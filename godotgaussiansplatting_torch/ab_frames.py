"""A/B timing of the fast frames as captured CUDA graphs: this checkout's
against another checkout's, in one process, on the same scene.

    python3 -m godotgaussiansplatting_torch.ab_frames OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another tree of this repository, for example
one unpacked with ``git archive <commit> | tar -x -C build/ab_base``. Its
port package is copied to ``build/ab/gsother`` and imported beside this
one (as ``ab_render`` does); each builds its kernels from its own sources.
On bench.py's 5.8M-splat scene in load order at 1920x1080, for
fast_defaults(), its v4 and RasterizerConfig(quality="fast"), each side's
``FastFrameGraph`` renders 8 orbit cameras: every output field of each
camera's frame is compared between the sides (bit for bit, f32 as bits);
the frames are timed in turns, other, this, this, other (median host
clock, CUDA events and stage times over the cameras); the Blocks stage
alone is timed as graph replays on each camera's projection; and each
side's peak device memory above its inputs during an eager frame is
printed. Then the exact frame (RasterizerConfig's default quality, tile
capacity 2048) as each side's ``ExactFrameGraph``: the image, tile_t0,
the sorted values, the tile ranges and the statistics of the 8 cameras
compared bit for bit, and the frames timed in turns. Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch.ab_render import import_other
from godotgaussiansplatting_torch.ops import fast_pipeline as fp
from godotgaussiansplatting_torch.ops.pipeline import pack_uniforms

FIELDS = ("image", "tile_t0", "tile_blocks", "tile_nblocks", "tile_nbig",
          "payload", "tile_bigpay")
CAMERAS = 8


class Side:
    """One checkout's package: its config, cloud, uniforms and graphs."""

    def __init__(self, name: str, pkg, fast_pipeline, cloud):
        self.name, self.pkg, self.fp = name, pkg, fast_pipeline
        cls = importlib.import_module(
            f"{pkg.__name__}.models.splats").SplatCloud
        self.cloud = cls(**{f.name: getattr(cloud, f.name)
                            for f in dataclasses.fields(cloud)})

    def configs(self) -> dict:
        base = self.pkg.RasterizerConfig(width=1920, height=1080)
        return {"shipped": base.fast_defaults(),
                "v4": base.replace(kernel="v4").fast_defaults(),
                "quality=fast": base.replace(quality="fast")}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _graphed_ms(fn, reps: int = 10) -> float:
    """Device ms a call of ``fn`` over ``reps`` calls in one graph."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _peak_gib(fn) -> float:
    """Peak device memory above what was allocated before ``fn()``."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**30


def _timed(graph, values, timer_cls) -> tuple:
    """(host ms, CUDA-event ms, {stage: ms}) of one replayed frame."""
    timer = timer_cls(torch.device("cuda"))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    graph.render(values, timer)
    b.record()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3, a.elapsed_time(b),
            timer.times_ms())


def config_ab(tag: str, sides: dict, card: str) -> None:
    """One configuration on both sides: frames compared, then timed."""
    cams = gt.orbit_trajectory(CAMERAS, radius=5.0, target=(0, 0, 6.0))
    state = {}
    for name, side in sides.items():
        cfg = side.configs()[tag]
        cloud = side.pkg.fast_cloud_view(side.cloud,
                                         planar_sh=cfg.projection_kernel)
        w, h = cfg.target_size
        values = [pack_uniforms(c.view_matrix(), c.projection_matrix(w, h),
                                c.camera_pos_ply(), 1.0, 1e9, 0.0)
                  for c in cams]
        unis = [side.pkg.make_uniforms(c, cfg) for c in cams]
        peak = _peak_gib(lambda: side.fp.render_frame_fast_staged(
            cloud, unis[0], cfg))
        stages = [dict(side.fp._frame_stages(cloud, u, cfg)) for u in unis]
        prjs = [s["Projection"](None) for s in stages]
        blocks = [_graphed_ms(lambda: s["Blocks"](p))
                  for s, p in zip(stages, prjs)]
        del stages, prjs
        state[name] = (side.fp.FastFrameGraph(cloud, cfg, values[0]),
                       values, peak, blocks)
    differ = []
    for i in range(CAMERAS):
        outs = {name: st[0].render(st[1][i]) for name, st in state.items()}
        a, b = outs["other"], outs["this"]
        differ += [f"camera {i} {f}" for f in FIELDS
                   if not torch.equal(_bits(getattr(a, f)),
                                      _bits(getattr(b, f)))]
        differ += [f"camera {i} stats.{f}" for f, x, y in zip(
            a.stats._fields, a.stats, b.stats) if not torch.equal(x, y)]
    print(f"[{tag}] {card}: {CAMERAS} graphed frames of each side, every "
          f"field {'bit-equal' if not differ else 'DIFFERS: ' + str(differ)}",
          flush=True)
    for k, name in enumerate(("other", "this", "this", "other")):
        graph, values, peak, blocks = state[name]
        runs = [_timed(graph, values[i], sides[name].fp.StageTimer)
                for i in range(CAMERAS)]
        med = {s: round(statistics.median(r[2][s] for r in runs), 3)
               for s in runs[0][2]}
        print(f"[{tag}] {name} ({k + 1} of 4): median frame "
              f"{statistics.median(r[0] for r in runs):.3f} ms host clock "
              f"(all {[round(r[0], 3) for r in runs]}), "
              f"{statistics.median(r[1] for r in runs):.3f} ms CUDA events,"
              f" median stages {json.dumps(med)}; Blocks alone as graph "
              f"replays, median {statistics.median(blocks):.4f} ms; peak "
              f"above the inputs {peak:.3f} GiB", flush=True)
    del state


EXACT_FIELDS = ("image", "tile_t0", "sorted_values", "tile_start",
                "tile_end")


def exact_ab(sides: dict, card: str, capacity: int = 2048) -> None:
    """The exact frame on both sides: frames compared, then timed."""
    cams = gt.orbit_trajectory(CAMERAS, radius=5.0, target=(0, 0, 6.0))
    state = {}
    for name, side in sides.items():
        cfg = side.pkg.RasterizerConfig(width=1920, height=1080)
        pipe = importlib.import_module(f"{side.pkg.__name__}.ops.pipeline")
        w, h = cfg.target_size
        values = [pack_uniforms(c.view_matrix(), c.projection_matrix(w, h),
                                c.camera_pos_ply(), 1.0, 1e9, 0.0)
                  for c in cams]
        state[name] = (pipe.ExactFrameGraph(side.cloud, cfg, values[0],
                                            capacity), values)
    differ = []
    for i in range(CAMERAS):
        a = state["other"][0].render(state["other"][1][i])
        a = a._replace(**{f: getattr(a, f).clone() for f in EXACT_FIELDS})
        b = state["this"][0].render(state["this"][1][i])
        differ += [f"camera {i} {f}" for f in EXACT_FIELDS
                   if not torch.equal(_bits(getattr(a, f)),
                                      _bits(getattr(b, f)))]
        differ += [f"camera {i} stats.{f}" for f, x, y in zip(
            a.stats._fields, a.stats, b.stats) if not torch.equal(x, y)]
    print(f"[exact] {card}: {CAMERAS} graphed frames of each side, tile "
          f"capacity {capacity}, every field "
          f"{'bit-equal' if not differ else 'DIFFERS: ' + str(differ)}",
          flush=True)
    for k, name in enumerate(("other", "this", "this", "other")):
        graph, values = state[name]
        runs = [_timed(graph, values[i], sides[name].fp.StageTimer)
                for i in range(CAMERAS)]
        med = {s: round(statistics.median(r[2][s] for r in runs), 3)
               for s in runs[0][2]}
        print(f"[exact] {name} ({k + 1} of 4): median frame "
              f"{statistics.median(r[0] for r in runs):.3f} ms host clock, "
              f"{statistics.median(r[1] for r in runs):.3f} ms CUDA events,"
              f" median stages {json.dumps(med)}", flush=True)
    del state


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    _, other_kernels = import_other(Path(argv[0]).resolve())
    other = importlib.import_module("gsother")
    other_fp = importlib.import_module("gsother.ops.fast_pipeline")
    kernels.build(*kernels.SIGNATURES)
    other_kernels.build(*other_kernels.SIGNATURES)
    card = kernels.card_name_and_power()
    t0 = time.perf_counter()
    cloud = gt.mortonize(gt.synthetic_scene(
        5_800_000, seed=42, extent=4.0, scale_range=(0.004, 0.03),
        surfaces=True))
    print(f"{card}: scene set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    sides = {"other": Side("other", other, other_fp, cloud),
             "this": Side("this", gt, fp, cloud)}
    for tag in ("shipped", "v4", "quality=fast"):
        config_ab(tag, sides, card)
    exact_ab(sides, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
