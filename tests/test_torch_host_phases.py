"""The host's phases of the port's engine frames (``utils.telemetry.
HostPhases``) on the CPU: the phases tile a frame, a frame is one row
(from ``update_camera_matrices`` to the end of ``rasterize``, an exact
capacity re-render included), profiled frames are marked and skipped, the
ring wraps, and the benchmark's ``engine.*`` readers take the window's
rows. The case marked ``gpu`` holds the counters and the phases' cover to
graphed frames on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_host_phases.py
"""

import json
import statistics

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch.utils import telemetry
from godotgaussiansplatting_torch.utils.telemetry import (HOST_COLUMNS,
                                                          PHASES, HostPhases)
from portbench.readers import RunRecord
from portbench.run import load_metric

from _torch_parity import model_blob

SYNCS = HOST_COLUMNS.index("syncs")
LAUNCHES = HOST_COLUMNS.index("launches")
PROFILED = HOST_COLUMNS.index("profiled")
READERS = ("engine.prep_ms", "engine.launch_ms", "engine.wait_ms",
           "engine.finish_ms", "engine.host_syncs", "engine.unspanned_ms")


def _rast(quality="exact", recorder=None, **kw):
    kw.setdefault("tile_capacity", 256)
    r = gt.Rasterizer(model_blob(), texture_size=(64, 48), quality=quality,
                      device="cpu", **kw)
    r.host_phases = recorder or HostPhases(64)
    return r


def _phase_sum_ms(row) -> float:
    return float(row[:len(PHASES)].sum()) * 1e3


@pytest.mark.parametrize("quality", ["exact", "fast"])
def test_phases_sum_to_the_frame(quality):
    r = _rast(quality)
    r.rasterize(sync=True)                       # first frame: warm
    r.rasterize(sync=True)
    assert r.host_phases.frames == 2
    row = r.host_phases.last_frames(1)[0]
    frame = r.timings.as_dict()["Frame"]
    assert _phase_sum_ms(row) == pytest.approx(frame, rel=0.02)
    t = telemetry.host_timings(row)
    # the eager stages are the launch; no graph, no host wait on the CPU
    assert t["launch"] > 0.5 * frame
    assert t["capture"] == 0 and t["outputs"] == 0
    assert t["syncs"] == 0 and t["launches"] == 0
    assert r.debug_info()["host_timings"] == t


def test_camera_opens_the_next_row():
    r = _rast()
    r.rasterize(sync=True)      # its uniforms build the camera's matrices
    r.rasterize(sync=True)
    r.camera = gt.Camera.reset_pose().with_yaw_pitch(20, -5)
    assert r.update_camera_matrices()
    assert r.host_phases.frames == 2             # the row is still open
    r.rasterize(sync=True)
    assert r.host_phases.frames == 3
    first, second = r.host_phases.last_frames(2)
    assert first[PHASES.index("camera")] == 0
    assert second[PHASES.index("camera")] > 0
    # the caller's time between the two calls is in no phase
    frame = r.timings.as_dict()["Frame"]
    assert (_phase_sum_ms(second) - second[PHASES.index("camera")] * 1e3
            == pytest.approx(frame, rel=0.02))


def test_overflow_rerender_stays_in_one_row():
    import time
    r = _rast(tile_capacity=8)
    r.rasterize(sync=True)                       # grows the capacity
    assert r.tile_capacity > 8
    assert r.host_phases.frames == 1
    r.tile_capacity = 8
    t0 = time.perf_counter()
    r.rasterize(sync=True)
    took_ms = (time.perf_counter() - t0) * 1e3
    assert r.tile_capacity > 8
    assert r.host_phases.frames == 2
    row = r.host_phases.last_frames(1)[0]
    # both renders' stages are in the row, the re-render's after the check
    assert row[PHASES.index("launch")] * 1e3 > r.timings.as_dict()["Frame"]
    assert _phase_sum_ms(row) == pytest.approx(took_ms, rel=0.02)


def test_profiled_frames_are_marked_and_skipped(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    r = _rast("exact")
    r.rasterize(sync=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for yaw in (10, 20):
            r.camera = gt.Camera.reset_pose().with_yaw_pitch(yaw, -5)
            r.update_camera_matrices()
            r.rasterize(sync=True)
    assert r.host_phases.frames == 3
    # the two profiled rows are skipped: only the first frame is left
    rows = r.host_phases.last_frames(3)
    assert len(rows) == 1 and rows[0][PROFILED] == 0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    for phase in ("camera", "uniforms", "graph", "upload", "launch", "wait",
                  "timings", "overflow"):
        assert f"engine.{phase}" in names, phase
    # off the profiler again: a new row is not marked
    r.rasterize(sync=True)
    assert len(r.host_phases.last_frames(3)) == 2


def test_ring_wraps_at_its_bound():
    ring = HostPhases(4)
    for i in range(10):
        ring.begin(telemetry.GRAPH)
        for _ in range(i):
            ring.synced()
        ring.launched(4)
        ring.end()
    assert ring.frames == 10
    rows = ring.last_frames(10)
    assert rows[:, SYNCS].tolist() == [6, 7, 8, 9]
    assert rows[:, LAUNCHES].tolist() == [4, 4, 4, 4]
    assert ring.last_frames(2)[:, SYNCS].tolist() == [8, 9]
    assert len(ring.last_frames(0)) == 0


def test_nested_frame_and_pause_keep_one_row():
    ring = HostPhases(8)
    ring.begin(telemetry.GRAPH)
    ring.begin(telemetry.UNIFORMS)               # a frame nested in it
    ring.synced()
    ring.end()
    assert ring.frames == 0
    was = ring.phase
    assert was == telemetry.UNIFORMS
    ring.mark(telemetry.CAMERA)
    ring.mark(was)
    ring.end()
    assert ring.frames == 1
    row = ring.last_frames(1)[0]
    assert row[SYNCS] == 1
    assert all(row[i] >= 0 for i in range(len(PHASES)))


# -- the benchmark's readers on a hand-built ring ----------------------------

FRAMES = [
    ({"camera": 180_000, "uniforms": 40_000, "graph": 30_000,
      "upload": 20_000, "launch": 150_000, "outputs": 25_000,
      "wait": 2_000_000, "timings": 60_000, "overflow": 15_000}, 4),
    ({"camera": 220_000, "uniforms": 35_000, "graph": 31_000,
      "capture": 5_000_000, "upload": 22_000, "launch": 140_000,
      "outputs": 24_000, "wait": 1_900_000, "timings": 50_000,
      "overflow": 14_000}, 4),
    ({"camera": 200_000, "uniforms": 38_000, "graph": 29_000,
      "upload": 21_000, "launch": 160_000, "outputs": 26_000,
      "wait": 2_100_000, "timings": 55_000, "overflow": 16_000}, 3),
]


def _hand_built(monkeypatch, frames):
    """A ring of ``frames`` ((phase: ns), syncs) written through the
    recorder's own calls on a clock (s) the test moves."""
    clock = [1000.0]
    monkeypatch.setattr(telemetry, "perf_counter", lambda: clock[0])
    ring = HostPhases(16)
    for spent, syncs in frames:
        for k, phase in enumerate(spent):
            if k == 0:
                ring.begin(PHASES.index(phase))
            else:
                ring.mark(PHASES.index(phase))
            clock[0] += spent[phase] * 1e-9
        for _ in range(syncs):
            ring.synced()
        ring.launched(4)
        ring.end()
        clock[0] += 7e-6                          # the loop, between frames
    monkeypatch.setattr(telemetry, "HOST_PHASES", ring)
    return ring


def _expected(name, frames, frame_ms):
    def ms(spent, phases):
        return sum(spent.get(p, 0) for p in phases) * 1e-6
    groups = {"engine.prep_ms": ("camera", "uniforms", "graph", "upload"),
              "engine.launch_ms": ("launch", "outputs"),
              "engine.wait_ms": ("wait",),
              "engine.finish_ms": ("timings", "overflow")}
    if name in groups:
        return statistics.fmean(ms(s, groups[name]) for s, _ in frames)
    if name == "engine.host_syncs":
        return statistics.fmean(n for _, n in frames)
    return statistics.fmean(f - ms(s, PHASES)
                            for f, (s, _) in zip(frame_ms, frames))


def _run(frame_ms):
    n = len(frame_ms)
    return RunRecord(config={}, capacity=0, frame_ms=list(frame_ms),
                     stage_ms=[{}] * n, slot=[0] * n)


@pytest.mark.parametrize("name", READERS)
def test_reader_means_the_window_rows(name, monkeypatch):
    _hand_built(monkeypatch, FRAMES)
    window = FRAMES[1:]                          # the ring's last two rows
    frame_ms = [2.6, 2.45]
    got = load_metric(name)(_run(frame_ms))
    assert got == pytest.approx(_expected(name, window, frame_ms), rel=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_rows(name, monkeypatch):
    _hand_built(monkeypatch, FRAMES)
    read = load_metric(name)
    assert read(_run([2.5] * 4)) is None         # more frames than rows
    assert read(_run([])) is None
    monkeypatch.delattr(telemetry, "HOST_PHASES")  # a renderer without it
    assert read(_run([2.5])) is None


def test_host_lines_show_the_last_frame():
    t = telemetry.host_timings(np.array(
        [1e-4, 0, 5e-5, 0, 0, 0, 0, 2e-3, 0, 0, 3, 4, 0]))
    assert t["camera"] == pytest.approx(0.1) and t["syncs"] == 3
    lines = telemetry.host_lines(t)
    assert lines[0] == f"{'camera:':<16} 0.10ms"
    assert f"{'Host Total:':<16} 2.15ms" in lines
    assert lines[-1].endswith("3, graph launches 4")
    assert telemetry.host_lines({}) == []


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphed frames run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("quality", ["fast", "exact"])
def test_graphed_frames_count_their_waits(quality, cuda, monkeypatch):
    """200 graphed frames: the ring's syncs a frame equal the host's waits
    counted by wrapping every way the engine waits (the device and event
    synchronises, a card tensor's ``int``), and the phases cover the
    loop's frame time to 0.05 ms."""
    import time

    cloud = gt.synthetic_scene(200_000, surfaces=True, device=cuda)
    r = gt.Rasterizer(cloud, texture_size=(1280, 720), quality=quality,
                      device=cuda)
    cams = [gt.Camera.reset_pose().with_yaw_pitch(190 + i, -5)
            for i in range(8)]
    for cam in cams:                             # capture, capacity growth
        r.camera = cam
        r.update_camera_matrices()
        r.rasterize(sync=True)
    ring = HostPhases(256)
    r.host_phases = ring
    waits = [0]

    def counted(fn):
        def wrapper(*a, **k):
            waits[0] += 1
            return fn(*a, **k)
        return wrapper

    def counted_int(t):
        if t.is_cuda:
            waits[0] += 1
        return torch._C.TensorBase.__int__(t)

    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted(torch.cuda.synchronize))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        counted(torch.cuda.Event.synchronize))
    monkeypatch.setattr(torch.Tensor, "__int__", counted_int)
    frame_ms = []
    for i in range(200):
        a = time.perf_counter()
        r.camera = cams[i % len(cams)]
        r.update_camera_matrices()
        r.rasterize(sync=True)
        frame_ms.append((time.perf_counter() - a) * 1e3)
    monkeypatch.undo()
    assert r.graph_captures >= 1 and ring.frames == 200
    rows = ring.last_frames(200)
    assert int(rows[:, SYNCS].sum()) == waits[0]
    assert rows[:, SYNCS].tolist() == [3 if quality == "fast" else 4] * 200
    assert rows[:, LAUNCHES].tolist() == [4] * 200
    monkeypatch.setattr(telemetry, "HOST_PHASES", ring)
    run = _run(frame_ms)
    assert load_metric("engine.host_syncs")(run) == waits[0] / 200
    unspanned = load_metric("engine.unspanned_ms")(run)
    assert 0 <= unspanned <= 0.05, unspanned
