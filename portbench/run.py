"""Run one cell of ``BENCHMARK.json``: the viewer's frame loop on a scene
and a camera path made from the seed, timed on the card, its sample
frames checked against the plain reference.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Each frame does what the viewer's render loop does for a frame: set
``Rasterizer.camera`` to the path's next camera, call
``update_camera_matrices()``, then ``rasterize(sync=True)``; one frame is
in flight at a time. Set-up (``setup_s``, from the process's start to the
first timed frame) makes the scene on the card, builds the ``Rasterizer``
and renders the traffic's warm-up revolutions. The window then renders
frames for ``--seconds``. With ``--trace 1`` one more revolution is
rendered under the profiler after the window, and the result carries the
per-layer metrics; with ``--trace 0`` the end-to-end ones. Once the window
has closed and the renderer is freed, the plain reference renders the
sample cameras from the same seed and the comparison decides ``correct``.

Earlier lines of standard output say what ran; the last is the result.
The last lines of standard error give each compared number beside its
limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "godotgaussiansplatting_tpu")
REFERENCE_TIME_S = 1e4   # the fade-in clock: every splat fully loaded


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc, in
    clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start / os.sysconf("SC_CLK_TCK"))


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load (compared whole: the renderer's package shares a prefix)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _guard(when: str) -> None:
    bad = banned_modules()
    if bad:
        raise SystemExit(f"portbench: {when}, modules that may not be "
                         f"loaded are: {', '.join(bad)}")


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_rasterizer(rast, stated: dict) -> None:
    """The configuration file states the renderer's knobs; raise unless the
    renderer runs with them (the reference's semantics assume them)."""
    cfg = rast.config
    for key, want in stated.items():
        have = getattr(cfg, key)
        if isinstance(have, tuple):
            have = [list(x) if isinstance(x, tuple) else x for x in have]
        if have != want:
            raise RuntimeError(f"the renderer runs {key}={have!r}, the "
                               f"configuration states {want!r}")


def load_cell(workload: str):
    """(cell, config, traffic, limits) of ``workload``, found by the names
    ``BENCHMARK.json`` gives: its entry, ``configs/<config>.json``,
    ``traffic/<mix>.json`` and ``limits/<workload>.json``."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((CHECKOUT / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return cell, config, traffic, limits


def reference_spec(config: dict) -> dict:
    """What the reference renders: the renderer's stated knobs with the
    keys the configuration's ``reference_differs`` replaces."""
    return {**config["rasterizer"], **config["reference_differs"]}


def reference_frames(config: dict, path, seed: int, slots, device,
                     dtype=None) -> dict:
    """{slot: the plain reference's frame} of the sample cameras ``slots``
    of ``path``, on the scene made anew from ``seed`` (SH rounded to the
    precision the configuration hands the renderer), computed in ``dtype``
    (float32 unless given); each image as a host (H, W, 3) array."""
    import torch

    from .reference import camera as ref_camera, frame as ref_frame
    from .scene import make_scene

    spec = reference_spec(config)
    scene = make_scene(config, seed, device)
    if config["scene"]["sh_dtype"] == "bfloat16":
        scene["sh"] = scene["sh"].to(torch.bfloat16)
    out = {}
    for slot in slots:
        pos, tgt = path.pose(slot)
        view, proj, campos = ref_camera.camera_matrices(
            pos, tgt, path.fov_y, spec["width"], spec["height"])
        ref = ref_frame.render(scene, view, proj, campos, REFERENCE_TIME_S,
                               spec, dtype or torch.float32,
                               fast_tile_size=spec.get("fast_tile_size"))
        ref["image"] = ref["image"].cpu().numpy()
        out[slot] = ref
    return out


def frame_outputs(frame) -> tuple:
    """What the comparison reads of a frame: its image and the renderer's
    pair, dropped-pair and densest-tile counts, as the renderer holds them
    (on its device)."""
    s = frame.stats
    return (frame.image, s.num_pairs, s.num_overflow, s.max_tile_count)


def sample_from(image, pairs, dropped, densest) -> dict:
    """A sample frame for ``compare.numbers`` from the host copies of
    ``frame_outputs``: the image as (H, W, 3) (the fast path's planar
    (4, H, W) target viewed channels-last) and the counts as integers."""
    img = image.numpy()
    if img.shape[0] == 4 and img.shape[2] != 4:
        img = img.transpose(1, 2, 0)
    return {"image": img[:, :, :3].copy(), "rendered_splats": int(pairs),
            "pair_overflow_dropped": int(dropped),
            "max_tile_count": int(densest)}


def run_cell(config: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda", report=(),
             rasterizer_factory=None, log=print) -> dict:
    """One run of a cell; returns the result object, with ``numbers``, the
    worst reading of every comparison number, beside its keys. ``report``: the
    (name, unit) of each metric this cell reports (the per-layer ones when
    ``trace``, else the end-to-end ones). ``limits``: {compared number:
    its limit} (``limits/<cell>.json``). ``rasterizer_factory``
    builds the renderer from (cloud, texture size, quality, device); it
    defaults to the renderer's ``Rasterizer``."""
    import torch

    from godotgaussiansplatting_torch import Camera, Rasterizer, SplatCloud
    from godotgaussiansplatting_torch import kernels

    from . import compare, trace as tracing
    from .readers import RunRecord
    from .scene import make_scene
    from .traffic import CameraPath

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        log(f"card: {card_line()}")
    size = (config["rasterizer"]["width"], config["rasterizer"]["height"])

    # -- set-up ----------------------------------------------------------
    t0 = time.perf_counter()
    arrays = make_scene(config, seed, device)
    cloud = SplatCloud(means=arrays["means"], cov3d=arrays["cov3d"],
                       opacity=arrays["opacity"], sh=arrays["sh"],
                       upload_time=arrays["upload_time"],
                       num_splats=arrays["num_splats"])
    capacity = cloud.capacity
    del arrays
    if on_card:
        torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    make = rasterizer_factory or (
        lambda c, s, q, d: Rasterizer(c, texture_size=s, quality=q, device=d))
    rast = make(cloud, size, config["rasterizer"]["quality"], device)
    del cloud
    check_rasterizer(rast, config["rasterizer"])
    t_rast = time.perf_counter() - t0 - t_scene
    path = CameraPath(traffic, seed)
    cams = []
    for slot in range(path.frames_per_revolution):
        pos, tgt = path.pose(slot)
        cams.append(Camera(position=pos, fov_y=path.fov_y).look_at(tgt))

    def frame(slot, span=None):
        if span is None:
            rast.camera = cams[slot]
            rast.update_camera_matrices()
            rast.rasterize(sync=True)
        else:
            with span(tracing.SPANS[0]):
                rast.camera = cams[slot]
                rast.update_camera_matrices()
            with span(tracing.SPANS[1]):
                rast.rasterize(sync=True)

    t1 = time.perf_counter()
    for i in range(path.warmup_frames):
        frame(path.warmup_slot(i))
    t_warm = time.perf_counter() - t1
    _guard("at the end of set-up")
    captures0 = rast.graph_captures
    kernels.reset_launch_counts()

    # -- the window ------------------------------------------------------
    frame_ms, stage_ms, slots, taken = [], [], [], {}
    want = set(path.samples)
    # host buffers (pinned on the card) for each sample frame's outputs,
    # made before the window: taking a sample in it is one copy, and every
    # conversion waits until the window has closed
    held = {slot: [torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card)
                   for t in frame_outputs(rast.last_frame)]
            for slot in want}
    setup_s = process_age_s()
    w0 = time.perf_counter()
    end = w0 + seconds
    i = 0
    while True:
        a = time.perf_counter()
        if a >= end:
            break
        slot = path.slot(i)
        frame(slot)
        b = time.perf_counter()
        frame_ms.append((b - a) * 1e3)
        stage_ms.append({k: v for k, v in rast.timings.as_dict().items()
                         if k != "Frame"})
        slots.append(slot)
        if slot in want and slot not in taken:
            for buf, t in zip(held[slot], frame_outputs(rast.last_frame)):
                buf.copy_(t)
            taken[slot] = held[slot]
        i += 1
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    _guard("after the window")
    taken = {slot: sample_from(*bufs) for slot, bufs in taken.items()}
    n = len(frame_ms)
    captures = rast.graph_captures - captures0
    launches = {k: v / n for k, v in kernels.launch_counts().items() if v}
    means = {k: sum(s.get(k, 0.0) for s in stage_ms) / n
             for k in sorted({k for s in stage_ms for k in s})}
    host = sum(frame_ms) / n - sum(means.values())
    log(f"window: {n} frames in {window_s:.3f} s, frame ms median "
        f"{sorted(frame_ms)[n // 2]:.4f}; stage events, mean ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in means.items())
        + f"; host less stages {host:.4f}")
    if on_card:
        log("card after the window: " + card_line(
            "clocks.sm,clocks.max.sm,temperature.gpu,power.draw"))
    log(f"set-up: scene on the device {t_scene:.3f} s, renderer "
        f"{t_rast:.3f} s, warm-up {path.warmup_frames} frames "
        f"{t_warm:.3f} s; captures before the window {captures0}, in it "
        f"{captures}; tile capacity {getattr(rast, 'tile_capacity', None)}")
    log("launches a frame: " + json.dumps(launches, sort_keys=True))

    record = RunRecord(config=config, capacity=capacity, frame_ms=frame_ms,
                       stage_ms=stage_ms, slot=slots)
    if trace:
        record.trace = tracing.profile(
            lambda span: [frame(path.slot(i + k), span)
                          for k in range(path.frames_per_revolution)])
        _guard("after the traced stretch")

    # -- the reference ---------------------------------------------------
    del rast, cams
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    missing = want - set(taken)
    per_sample = []
    t2 = time.perf_counter()
    refs = reference_frames(config, path, seed, sorted(taken), device)
    for slot, ref in refs.items():
        per_sample.append(compare.numbers(taken[slot], ref))
        record.samples[slot] = {k: ref[k] for k in (
            "evaluations", "pair_reads", "live_pairs", "rendered_splats")}
        log(f"sample camera {slot * path.step:g} deg: renderer pairs "
            f"{taken[slot]['rendered_splats']} dropped "
            f"{taken[slot]['pair_overflow_dropped']} densest tile "
            f"{taken[slot]['max_tile_count']}; reference pairs "
            f"{ref.get('fast_pairs', ref['rendered_splats'])} dropped "
            f"{ref['pair_overflow_dropped']} densest tile "
            f"{ref['max_tile_count']}, evaluations {ref['evaluations']}")
    log(f"reference: {len(taken)} frames in "
        f"{time.perf_counter() - t2:.3f} s")
    checks, failed = compare.judge(per_sample, limits)
    readings = compare.worst(per_sample)
    log("readings (worst over the samples): " + json.dumps(readings))
    failed += len(missing)
    correct = failed == 0 and bool(per_sample)

    # -- the result ------------------------------------------------------
    result = {"correct": correct, "attempted": n, "failed": failed}
    if trace:
        metrics = {}
        for name, unit in report:
            v = load_metric(name)(record)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
    else:
        values = {"frames_per_s": n / window_s,
                  "frame_ms_p95": sorted(frame_ms)[percentile_rank(n, 95)],
                  "peak_device_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {name: {"value": values[name], "unit": unit}
                   for name, unit in report}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and record.trace:
        dev["busy_s"] = record.trace["busy_s"]
        dev["window_s"] = record.trace["window_s"]
        result["breakdown"] = {"device_ops": record.trace["device_ops"],
                               "idle_gaps": record.trace["idle_gaps"]}
    result["device"] = dev
    result["checks"] = checks
    result["numbers"] = readings
    return result


def percentile_rank(n: int, q: int) -> int:
    """The index of the q-th percentile in n sorted values (nearest rank)."""
    return min(n - 1, max(0, -(-q * n // 100) - 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config, traffic, limits = load_cell(args.workload)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    metrics = bench["per_layer"] if args.trace else bench["end_to_end"]
    names = [(m["name"], m["unit"]) for m in metrics
             if args.workload in m.get("workloads", [args.workload])]

    # build and kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" /
                                             "torch_extensions")
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"portbench: {cell['chips']} CUDA device(s) needed, {found} "
              "found", file=sys.stderr)
        return 2
    result = run_cell(config, traffic, limits, args.seed, args.seconds,
                      bool(args.trace), report=names)
    del result["numbers"]      # printed above; the last line keeps to its keys
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    _guard("before the result")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
