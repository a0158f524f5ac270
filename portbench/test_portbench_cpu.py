"""The benchmark's own tests on the CPU, at small sizes: the scene and the
path are deterministic for a seed, the end-to-end arithmetic, the roofline
arithmetic on hand-counted inputs, the reference against the renderer's
exact frame, the import guard, and the comparison failing the control and
a run whose frames are broken underneath.

    python -m pytest portbench/ -q
"""

from __future__ import annotations

import ast
import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, control, readers, run, trace
from portbench.reference import camera as ref_camera, frame as ref_frame
from portbench.scene import make_scene
from portbench.traffic import CameraPath
from portbench.work import projection, render, sort

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def small(quality: str, splats: int = 5000, size=(256, 160)) -> dict:
    cfg = json.loads((HERE / "configs" /
                      f"garden5.8M-1080p-{quality}.json").read_text())
    cfg["scene"]["splats"] = splats
    cfg["rasterizer"]["width"], cfg["rasterizer"]["height"] = size
    return cfg


def half_turn(mix: str = "orbit") -> dict:
    tr = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    tr.update(deg_per_frame=180.0, samples_deg=[0, 180])
    return tr


def limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def quiet(*args):
    pass


# -- scene and path -------------------------------------------------------

def test_scene_is_deterministic_for_a_seed():
    cfg = small("exact", splats=3000)
    a = make_scene(cfg, 2 ** 31 + 11, "cpu")
    b = make_scene(cfg, 2 ** 31 + 11, "cpu")
    c = make_scene(cfg, 2 ** 31 + 12, "cpu")
    n = a["num_splats"]
    assert a["means"].shape[0] % cfg["scene"]["pad"] == 0
    for k in ("means", "cov3d", "opacity", "sh", "upload_time"):
        assert torch.equal(a[k], b[k])
        assert not a[k][n:].any()              # padding is inert
    assert not torch.equal(a["means"][:n], c["means"][:n])
    assert (a["opacity"][:n] > 0).all()


def test_scene_covariance_is_r_s2_rt():
    s = torch.tensor([[0.1, 0.2, 0.3]])
    q = torch.tensor([[0.3, -0.2, 0.5, 0.8]])
    x, y, z, w = (q / q.norm()).unbind(-1)
    R = torch.tensor([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    full = R @ torch.diag(s[0] ** 2) @ R.T
    want = full[[0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    from portbench.scene import covariance
    assert torch.allclose(covariance(s, q)[0], want, atol=1e-7)


@pytest.mark.parametrize("mix", ["orbit", "overview"])
def test_path_visits_the_samples_in_a_seeds_order(mix):
    tr = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    a, b = CameraPath(tr, 7), CameraPath(tr, 7 + 240 * 1000)
    assert a.frames_per_revolution == 240
    assert [a.slot(i) for i in range(300)] == [b.slot(i) for i in range(300)]
    # set-up does the same work for every seed
    c = CameraPath(tr, 8)
    assert c.slot(0) != a.slot(0)
    assert [a.warmup_slot(i) for i in range(a.warmup_frames)] == \
        [c.warmup_slot(i) for i in range(c.warmup_frames)]
    seen = {a.slot(i) for i in range(a.frames_per_revolution)}
    assert set(a.samples) <= seen and len(seen) == 240
    pos, tgt = a.pose(0)
    r = math.hypot(pos[0] - tgt[0], pos[2] - tgt[2])
    assert r == pytest.approx(tr["radius"], rel=1e-6)
    assert pos[1] - tgt[1] == pytest.approx(tr["height"])


# -- end-to-end arithmetic -------------------------------------------------

def test_percentile_is_over_every_frame():
    xs = sorted(float(v) for v in range(1, 101))
    assert xs[run.percentile_rank(100, 95)] == 95.0
    assert run.percentile_rank(1, 95) == 0
    assert run.percentile_rank(20, 95) == 18


def test_rate_is_every_frame_over_the_whole_window():
    cfg = small("exact", splats=2000, size=(96, 64))
    tr = half_turn()
    res = run.run_cell(cfg, tr, limits("garden-exact.orbit"), 5, 1.0, False,
                       device="cpu", log=quiet,
                       report=[("frames_per_s", "frames/s"),
                               ("frame_ms_p95", "ms"), ("setup_s", "s")])
    m = res["metrics"]
    # the window lasts at least its seconds and at most one frame more
    assert res["attempted"] / m["frames_per_s"]["value"] >= 1.0
    assert res["attempted"] / m["frames_per_s"]["value"] <= \
        1.0 + m["frame_ms_p95"]["value"] * 1e-3 * 3
    assert m["setup_s"]["value"] > 0


# -- roofline arithmetic ----------------------------------------------------

def record(quality="exact", capacity=16384, samples=None, frames=None):
    cfg = small(quality, size=(64, 32))
    frames = frames or [(2.0, {"Projection": 0.5, "Sort": 1.0,
                               "Render": 0.25}, 0)]
    rec = readers.RunRecord(config=cfg, capacity=capacity,
                            frame_ms=[f[0] for f in frames],
                            stage_ms=[f[1] for f in frames],
                            slot=[f[2] for f in frames])
    rec.samples = samples or {0: {"evaluations": 1000, "pair_reads": 100,
                                  "live_pairs": 500, "rendered_splats": 500}}
    return rec


def test_projection_work_counts_the_input_bytes():
    rec = record("exact")
    assert projection.work(rec) == (0.0, 16384 * (44 + 192))
    assert projection.work(record("fast")) == (0.0, 16384 * (44 + 96))


def test_sort_and_render_work_by_hand():
    rec = record("exact")
    counts = rec.samples[0]
    assert sort.work(rec, counts) == (0.0, 500 * 12 + 16384 * 25)
    flops, nbytes = render.work(rec, counts)
    assert flops == 1000 * 23
    assert nbytes == 100 * 40 + 64 * 32 * 16


def test_shares_divide_the_least_time_by_the_events():
    rec = record("exact")
    least = readers.least_ms(0.0, 16384 * 236)
    assert least == pytest.approx(16384 * 236 / 3.35e12 * 1e3)
    got = run.load_metric("exact.projection_roofline")(rec)
    assert got == pytest.approx(100 * least / 0.5)
    sort_least = readers.least_ms(0.0, 500 * 12 + 16384 * 25)
    assert run.load_metric("exact.sort_roofline")(rec) == \
        pytest.approx(100 * sort_least / 1.0)
    f, b = render.work(rec, rec.samples[0])
    assert run.load_metric("exact.render_roofline")(rec) == \
        pytest.approx(100 * max(f / 67e12, b / 3.35e12) * 1e3 / 0.25)
    assert run.load_metric("mfu.exact")(rec) == pytest.approx(
        100 * (least + sort_least + max(f / 67e12, b / 3.35e12) * 1e3) / 2.0)
    assert run.load_metric("exact.engine_overhead_ms")(rec) == \
        pytest.approx(0.25)


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = record("exact", frames=[(2.0, {}, 0)])
    for name in ("exact.sort_ms", "exact.render_roofline",
                 "exact.projection_roofline", "device_idle_share",
                 "exact.engine_overhead_ms"):
        assert run.load_metric(name)(rec) is None


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        run.load_metric(m["name"])
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"])
    for c in BENCH["configs"]:
        assert (CHECKOUT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()


def test_trace_summary_by_hand():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": trace.SPANS[1],
         "ts": 35, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 42, "dur": 10},
    ]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert dict(s["device_ops"]) == pytest.approx(
        {"k1": 20e-6, "k2": 15e-6, "copy": 10e-6})
    gaps = dict(s["idle_gaps"])
    # [0, 10] between spans; [40, 60] in the rasterize span, 10 of it in
    # the sync; [70, 100] in it until 85, then between spans
    assert gaps[trace.SPANS[1] + "/cudaDeviceSynchronize"] == \
        pytest.approx(10e-6)
    assert gaps[trace.SPANS[1]] == pytest.approx(25e-6)
    assert gaps["portbench.loop"] == pytest.approx(25e-6)


# -- the reference ----------------------------------------------------------

@pytest.mark.parametrize("mix", ["orbit", "overview"])
def test_reference_matches_the_exact_frame_plain_versions(mix):
    """The reference and the renderer's exact frame on the CPU (its plain
    versions), one tiny scene and camera: the same image and counts."""
    from godotgaussiansplatting_torch import Camera, Rasterizer, SplatCloud
    cfg = small("exact", splats=4000, size=(128, 96))
    scene = make_scene(cfg, 3, "cpu")
    path = CameraPath(json.loads((HERE / "traffic" / f"{mix}.json")
                                 .read_text()), 0)
    pos, tgt = path.pose(37)
    r = Rasterizer(SplatCloud(**scene), texture_size=(128, 96),
                   quality="exact", device="cpu")
    r.camera = Camera(position=pos, fov_y=path.fov_y).look_at(tgt)
    r.update_camera_matrices()
    r.rasterize(sync=True)
    info = r.debug_info()
    view, proj, campos = ref_camera.camera_matrices(pos, tgt, path.fov_y,
                                                    128, 96)
    ref = ref_frame.render(scene, view, proj, campos, 1e4,
                           run.reference_spec(cfg))
    assert ref["rendered_splats"] == info["rendered_splats"] > 0
    assert ref["pair_overflow_dropped"] == info["pair_overflow_dropped"]
    assert ref["max_tile_count"] == info["max_tile_count"]
    np.testing.assert_allclose(ref["image"].numpy(), r.image()[:, :, :3],
                               atol=1e-6)


def test_reference_caps_and_quirk_by_hand():
    spec = {"width": 64, "height": 16, "tile_size": 16,
            "max_tiles_per_splat": 2, "exact_tiers": [[3, 1]],
            "giant_splat_capacity": 1, "sort_buffer_factor": 10}
    nt = torch.tensor([1, 3, 3, 4, 4, 0])
    count, group = ref_frame.emit(nt, spec)
    # splat 1 takes the tier, splat 2 is capped to 2, splat 3 is the giant
    assert count.tolist() == [1, 3, 2, 4, 2, 0]
    assert group.tolist() == [0, 1, 0, 2, 0, 0]
    tile = torch.tensor([0, 0, 1, 2, 2])
    start, end = ref_frame.boundaries(tile, 5, 4, quirk=True)
    assert start.tolist() == [0, 2, 3, 5] and end.tolist() == [2, 3, 3, 5]
    start, end = ref_frame.boundaries(torch.tensor([0, 3, 3]), 3, 4, True)
    assert end.tolist() == [1, 1, 1, 2]


# -- the import guard ---------------------------------------------------------

def test_guard_compares_whole_top_level_names(monkeypatch):
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "godotgaussiansplatting_tpuish", None)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", None)
    assert run.banned_modules() == ["jaxlib"]


def test_the_guard_stops_a_run_that_loaded_jax(monkeypatch):
    run._guard("here")
    monkeypatch.setitem(sys.modules, "flax", None)
    with pytest.raises(SystemExit, match="flax"):
        run._guard("before the result")


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax():
    """Every source under portbench/ but the tests: none of jax, jaxlib,
    flax or the JAX package; the reference, nothing of the renderer
    either. Names are compared whole, so the renderer's package, which
    begins with the JAX package's name, is told apart."""
    files = [p for p in HERE.rglob("*.py")
             if not p.name.startswith("test_")]
    assert len(files) > 20
    for path in files:
        banned = set(run.BANNED)
        if "reference" in path.relative_to(HERE).parts:
            banned.add("godotgaussiansplatting_torch")
        assert not _imported_tops(path) & banned, path


# -- the comparison fails the control and broken frames ----------------------

@pytest.mark.parametrize("cell", ["garden-exact.orbit", "garden-fast.orbit"])
def test_the_control_fails_the_comparison(cell):
    quality = cell.split("-")[1].split(".")[0]
    cfg = small(quality)
    nums = control.control_numbers(cfg, half_turn(), 9, "cpu")
    assert compare.judge(nums, limits(cell))[1] > 0


def _broken(kind: str):
    from godotgaussiansplatting_torch import Rasterizer

    class Broken(Rasterizer):
        def rasterize(self, sync=False):
            prev = self.last_frame
            out = super().rasterize(sync)
            img = out.image
            planar = img.shape[0] == 4
            if kind == "stale" and prev is not None:
                self.last_frame = out = prev
            elif kind == "half":
                if planar:
                    img[:, img.shape[1] // 2:] = 0.0
                else:
                    img[img.shape[0] // 2:] = 0.0
            elif kind == "tile":
                if planar:
                    img[:3, :32, :32] += 1.0
                else:
                    img[:32, :32, :3] += 1.0
            return out

    return lambda c, s, q, d: Broken(c, texture_size=s, quality=q, device=d)


@pytest.mark.parametrize("cell", ["garden-exact.orbit", "garden-fast.orbit"])
@pytest.mark.parametrize("fault", [None, "stale", "half", "tile"])
def test_a_run_with_broken_frames_is_not_correct(cell, fault):
    """A run driven through the harness on the CPU: sound frames pass the
    cell's limits; a frame left as the last one, half a frame left out and
    a tile altered where it is produced each fail them."""
    quality = cell.split("-")[1].split(".")[0]
    seconds = 6.0 if quality == "fast" else 2.0
    for _ in range(3):      # a window of two frames or more, on a busy CPU
        res = run.run_cell(small(quality), half_turn(), limits(cell), 4,
                           seconds, False, device="cpu", log=quiet,
                           rasterizer_factory=fault and _broken(fault))
        if res["attempted"] >= 2:
            break
        seconds *= 3
    assert res["attempted"] >= 2
    assert res["correct"] is (fault is None), res["checks"]
