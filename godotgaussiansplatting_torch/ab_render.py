"""A/B timing of the render kernels (v3, both entry points, v4 and the
exact composite): this checkout's against another checkout's, in one
process, on the same inputs.

    python3 -m godotgaussiansplatting_torch.ab_render OTHER_CHECKOUT [ENTRY ...]

OTHER_CHECKOUT is the root of another tree of this repository, for example
one unpacked with ``git archive <commit> | tar -x -C build/ab_base``. Its
port package is copied to ``build/ab/gsother`` and imported beside this
one; each builds its kernels from its own sources. ENTRY is any of
``words``, ``cooked``, ``v4`` and ``exact`` (all four by default). The
inputs are made once with this checkout's pipeline under the reset camera:
200K splats at 512x512 (chip_smoke.py's phases 3, 3b and 7) and the
5.8M-splat scene at 1920x1080 (phase 6), each under fast_defaults() (the
word payload, ``gs_render_v3``), RasterizerConfig(quality="fast") (the
cooked payload, ``gs_render_v3_cooked``),
RasterizerConfig(kernel="v4").fast_defaults() (the cooked payload into
``gs_render_v4`` at GT 4) and the default exact quality (the readable
projection, emit_and_sort and tile_boundaries into ``gs_render_exact`` at
tile 16, with tile capacity 2048 at 512x512 and 16384, where the engine
settles, at 1080p). ``main(argv, views)`` compares further inputs from a
caller, each a (tag, fast cloud view, cfg, camera) through
``frame_inputs`` into the configuration's fast kernel; with views and no
ENTRY only the views run (``python3 -m portbench.render_views ab
OTHER_CHECKOUT`` hands it the benchmark's fast cells). A side whose
``_render_cuda`` or ``_render_v4_cuda`` takes the big log-alpha maps
(``bigla``) computes them with its own ``prepass_big_la`` inside each
timed call, as its frame does. The script
prints both sides' ptxas reports (registers, stack frame, spills) and
``render_exact``'s instructions per evaluation (``cuobjdump -sass``,
``render_exact.sass_per_evaluation``), the RGB PSNR, the largest
difference and whether the two outputs are bit-equal, and the ms per call
of 20 calls of each side (CUDA events, after a warm-up call) in the order
other, this, this, other, three times. Needs a CUDA device.
"""

from __future__ import annotations

import importlib
import inspect
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_torch.ops import render_exact as rx
from godotgaussiansplatting_torch.ops import render_v3 as rv
from godotgaussiansplatting_torch.ops import render_v4 as r4
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.binning2 import bin_blocks2
from godotgaussiansplatting_torch.ops.blocks2 import (
    build_block_frame2, build_block_frame2_words)
from godotgaussiansplatting_torch.ops.projection import project_splats
from godotgaussiansplatting_torch.ops.sort import (emit_and_sort,
                                                   tile_boundaries)

AB_DIR = Path(__file__).resolve().parent.parent / "build" / "ab"
# The scenes of chip_smoke.py's phases 3/3b (200K splats, scales up to 0.12,
# so tiles carry resident big lanes) and 6 (bench.py's 5.8M-splat scene).
SCENES = {
    "200K 512x512": (dict(n=200_000, seed=2, scale_range=(0.005, 0.12)),
                     (512, 512)),
    "5.8M 1920x1080": (dict(n=5_800_000, seed=42, extent=4.0,
                            scale_range=(0.004, 0.03)), (1920, 1080)),
}


ENTRIES = ("words", "cooked", "v4", "exact")
# render_exact's tile capacity a scene: phase 7's, and phase 8's at 1080p
EXACT_CAPACITY = {"200K 512x512": 2048, "5.8M 1920x1080": 16384}


def scene_cloud(tag: str):
    """The full-precision cloud of SCENES[tag] (the fast frames read its
    fast_cloud_view) and its base configuration."""
    scene, (width, height) = SCENES[tag]
    scene = dict(scene)
    cloud = gt.mortonize(gt.synthetic_scene(scene.pop("n"), surfaces=True,
                                            **scene))
    return cloud, gt.RasterizerConfig(width=width, height=height)


def import_other(root: Path):
    """The other checkout's render_v3 and kernels modules, as gsother (its
    render_v4 and render_exact are gsother.ops.render_v4 and
    gsother.ops.render_exact)."""
    dst = AB_DIR / "gsother"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "godotgaussiansplatting_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, str(AB_DIR))
    return (importlib.import_module("gsother.ops.render_v3"),
            importlib.import_module("gsother.kernels"))


def frame_inputs(cloud, cfg, camera=None):
    """(rows, payload, bigpay, cfg, U, max_batches) of ``camera`` (the
    reset camera unless given) through the configuration's projection and
    payload (the readable projection's kernel takes (P, 16, 3) SH)."""
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    uni = gt.make_uniforms(camera or gt.Camera.reset_pose(), cfg)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uni.view, uni.proj, uni.camera_pos,
            uni.model_scale, uni.time, cfg)
    if cfg.projection_kernel:
        bf, bigs = build_block_frame2_words(
            pk.project_words(*args, num_splats=cloud.num_splats), cfg,
            words_payload=cfg.words_payload)
    else:
        bf, bigs = build_block_frame2(project_splats(*args), cfg,
                                      num_splats=cloud.num_splats,
                                      words_payload=cfg.words_payload)
    tbig = bin_bigs(bigs, cfg, obig=cfg.big_tile_capacity)
    rows, U, max_batches = rv.tile_rows(bin_blocks2(bf, cfg), tbig,
                                        uni.heatmap_factor, cfg)
    return rows, bf.payload, tbig.bigpay, cfg, U, max_batches


def exact_inputs(cloud, cfg):
    """render_tiles' arguments up to the heatmap factor for the reset
    camera: the readable projection, emit_and_sort and tile_boundaries."""
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    prj = project_splats(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                         cloud.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, cfg)
    pairs = emit_and_sort(prj.valid, prj.rect, prj.num_tiles, prj.depth16,
                          cfg)
    start, end = tile_boundaries(pairs.keys, pairs.num_pairs, cfg)
    return (pairs.values, start, end, prj.image_pos, prj.conic, prj.color,
            uni.heatmap_factor)


def exact_sass(lib_module) -> dict:
    """A side's render_exact instructions per evaluation, by instance."""
    per = rx.sass_per_evaluation(kernels.sass(
        "render_exact", lib_module.library_path("render_exact")))
    return {ppt: {k: round(v, 3) for k, v in c.items()
                  if "." not in k or k == "MUFU.EX2"}
            for ppt, c in per.items()}


def _call(mod, mod4, args):
    """One call of a side's render kernel wrapper (v4 when the config says
    so), with its own big log-alpha maps when it takes them."""
    rows, payload, bigpay, cfg, U, mb = args
    v4 = cfg.kernel == "v4"
    fn = mod4._render_v4_cuda if v4 else mod._render_cuda
    more = (cfg.lockstep_gt, True) if v4 else (True,)
    if "bigla" in inspect.signature(fn).parameters:
        return fn(rows, payload, bigpay, mod.prepass_big_la(bigpay, cfg),
                  cfg, U, mb, *more)
    return fn(rows, payload, bigpay, cfg, U, mb, *more)


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _ptxas(lib_module, name: str) -> list:
    """The stack, spill and register lines of the build log of a side's
    render library."""
    log = lib_module.library_path(name).with_suffix(".log")
    return [ln.strip() for ln in log.read_text().splitlines()
            if "stack" in ln or "registers" in ln] if log.exists() else []


def _compare(a, b, cfg) -> str:
    asm, chans = ((r4.assemble_image_v4, r4.tile_channels_v4)
                  if cfg.kernel == "v4"
                  else (rv.assemble_image_v3, rv.tile_channels_v3))
    ia, ib = (asm(t, cfg)[0][:3].clamp(0, 1) for t in (a, b))
    mse = float(((ia - ib) ** 2).mean())
    ca, cb = chans(a, cfg), chans(b, cfg)
    return (f"PSNR {10 * np.log10(1.0 / max(mse, 1e-20)):.2f} dB, max |d| "
            f"{float((ca[..., :5] - cb[..., :5]).abs().max()):.3g}, channels "
            f"5-7 equal {torch.equal(ca[..., 5:], cb[..., 5:])}, bit-equal "
            f"{torch.equal(a, b)}")


def _ab(tag: str, fns: dict, cmp: str) -> None:
    """Time the two sides in the order other, this, this, other, three
    times, and print the line."""
    ms = {k: [] for k in fns}
    for _ in range(3):
        for who in ("other", "this", "this", "other"):
            ms[who].append(time_ms(fns[who]))
    print(f"{tag}: {cmp}; ms per call {json.dumps(ms)}", flush=True)


def _compare_exact(a, b) -> str:
    ia, ib = (o.image[..., :3].clamp(0, 1) for o in (a, b))
    mse = float(((ia - ib) ** 2).mean())
    return (f"PSNR {10 * np.log10(1.0 / max(mse, 1e-20)):.2f} dB, max |d| "
            f"{float((a.image - b.image).abs().max()):.3g}, tile_t0 "
            f"bit-equal {torch.equal(a.tile_t0, b.tile_t0)}, counts equal "
            f"{torch.equal(a.tile_counts, b.tile_counts)}, bit-equal "
            f"{torch.equal(a.image, b.image)}")


def main(argv, views=()) -> int:
    """``views``: further inputs, (tag, fast cloud view, cfg, camera)
    each; with views, only the ENTRYs named in ``argv`` run besides."""
    if not argv or not torch.cuda.is_available() or any(
            e not in ENTRIES for e in argv[1:]):
        raise SystemExit(__doc__)
    entries = argv[1:] or (() if views else ENTRIES)
    other_rv, other_kernels = import_other(Path(argv[0]).resolve())
    other_r4 = importlib.import_module("gsother.ops.render_v4")
    other_rx = importlib.import_module("gsother.ops.render_exact")
    for name in ("render_v3", "render_v4", "render_exact"):
        kernels.library(name)
        other_kernels.library(name)
        print(f"ptxas {name}, other:", json.dumps(_ptxas(other_kernels, name)))
        print(f"ptxas {name}, this:", json.dumps(_ptxas(kernels, name)))
    print("render_exact SASS per evaluation, other:",
          json.dumps(exact_sass(other_kernels)))
    print("render_exact SASS per evaluation, this:",
          json.dumps(exact_sass(kernels)))
    for tag in SCENES if entries else ():
        full, base = scene_cloud(tag)
        cloud = gt.fast_cloud_view(full)
        for entry, cfg in (("words", base.fast_defaults()),
                           ("cooked", base.replace(quality="fast")),
                           ("v4", base.replace(kernel="v4").fast_defaults())):
            if entry not in entries:
                continue
            args = frame_inputs(cloud, cfg)
            fns = {"other": lambda: _call(other_rv, other_r4, args),
                   "this": lambda: _call(rv, r4, args)}
            _ab(f"{tag} {entry} (tile {cfg.tile_size}, U={args[4]}"
                f"{f', GT={cfg.lockstep_gt}' if entry == 'v4' else ''})",
                fns, _compare(fns["other"](), fns["this"](), cfg))
            del args, fns
        if "exact" in entries:
            args = exact_inputs(full, base)
            cap = EXACT_CAPACITY[tag]
            fns = {"other": lambda: other_rx._render_exact_cuda(
                       *args, base, cap),
                   "this": lambda: rx._render_exact_cuda(*args, base, cap)}
            _ab(f"{tag} exact (tile {base.tile_size}, capacity {cap})", fns,
                _compare_exact(fns["other"](), fns["this"]()))
            del args, fns
        del cloud, full
    for tag, cloud, cfg, camera in views:
        args = frame_inputs(cloud, cfg, camera)
        fns = {"other": lambda: _call(other_rv, other_r4, args),
               "this": lambda: _call(rv, r4, args)}
        _ab(f"{tag} {cfg.kernel} (tile {cfg.tile_size}, U={args[4]})", fns,
            _compare(fns["other"](), fns["this"](), cfg))
        del args, fns
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
