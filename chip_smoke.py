"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from godotgaussiansplatting_torch/csrc, then:

1. device: the card's name and power limit, and the kernels' build time;
2. projection kernel against its plain-torch version on a 1M-splat surface
   scene at 1920x1080 (fast_defaults()): key, bkey and cnt bit-equal,
   pc1/pc2/rgb9 within one unit in the last place per packed field, ix/iy
   within 1e-3 px;
3. render kernel against its plain-torch version at 512x512 on 200K splats
   (scales up to 0.12, so tiles carry resident big lanes), heatmap 0 and 1: RGB PSNR >= 50 dB, t_final within 1e-3, finite output;
4. full frame: render_frame_fast at 1920x1080 on the 5.8M-splat scene of
   bench.py over 8 orbit cameras; finite images, pairs > 0, both kernels
   launched by the frame, a finite pick on the centre tile; the median
   frame and stage times (CUDA events, after one warm-up frame) and the
   peak device memory.

Any failed check raises, and the script exits non-zero. Without a CUDA
device it raises before printing any result. The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_torch.ops import render_v3 as rv
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.binning2 import bin_blocks2
from godotgaussiansplatting_torch.ops.blocks2 import (
    _bits16, adaptive_cell_shift, build_block_frame2_words, u32)

PROJ_SRC = "godotgaussiansplatting_torch/csrc/projection.cu"
PROJ_TPU = "godotgaussiansplatting_tpu/ops/projection_pallas.py:133"
RENDER_SRC = "godotgaussiansplatting_torch/csrc/render_v3.cu"
RENDER_TPU = "godotgaussiansplatting_tpu/ops/render_pallas3.py:178"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, after one warm-up call."""
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


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    for name in ("projection", "render_v3"):
        kernels.library(name)
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in kernels.build_seconds.items()})})")
    return card


def _f16_ulps(a, b):
    """Max difference of the two f16 halves of int32 words, in ulps."""
    worst = 0
    for sh in (0, 16):
        ha = _bits16((u32(a) >> sh) & 0xFFFF).to(torch.int64)
        hb = _bits16((u32(b) >> sh) & 0xFFFF).to(torch.int64)
        worst = max(worst, int((ha - hb).abs().max()))
    return worst


def phase_projection(n: int, width: int, height: int) -> dict:
    dev = torch.device("cuda")
    cloud = gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        n, seed=1, surfaces=True, device=dev)))
    cfg = gt.RasterizerConfig(width=width, height=height).fast_defaults()
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=dev)
    vec = pk.frame_uniform_vector(uni.view, uni.proj, uni.camera_pos,
                                  uni.model_scale, uni.time, cfg)
    gx, gy = cfg.tile_dims
    cell = adaptive_cell_shift(cloud.num_splats, gx, gy)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, vec, cfg, cell)
    wk = pk._project_words_cuda(*args)
    wr = pk.project_words_reference(*args)
    torch.cuda.synchronize()
    bad = {f: int((getattr(wk, f) != getattr(wr, f)).sum())
           for f in pk.ProjWords._fields}
    valid = wr.key.reshape(-1) != -1
    ix_err = max(float((wk.ix.view(torch.float32) - wr.ix.view(torch.float32))
                       .reshape(-1)[valid].abs().max()),
                 float((wk.iy.view(torch.float32) - wr.iy.view(torch.float32))
                       .reshape(-1)[valid].abs().max()))
    pc_ulps = max(_f16_ulps(wk.pc1.reshape(-1)[valid], wr.pc1.reshape(-1)[valid]),
                  _f16_ulps(wk.pc2.reshape(-1)[valid], wr.pc2.reshape(-1)[valid]))
    ka, kb = u32(wk.rgb9.reshape(-1)[valid]), u32(wr.rgb9.reshape(-1)[valid])
    rgb_ok = bool(((ka >> 27) == (kb >> 27)).all()) and all(
        int((((ka >> s) & 0x1FF) - ((kb >> s) & 0x1FF)).abs().max()) <= 1
        for s in (0, 9, 18))
    ms = time_ms(lambda: pk._project_words_cuda(*args), 20)
    plain_ms = time_ms(lambda: pk.project_words_reference(*args), 3)
    log(f"[2 projection] {n} splats {width}x{height}: valid "
        f"{int(valid.sum())}, mismatching words {json.dumps(bad)}, "
        f"max |d ix,iy| {ix_err:.3g} px, f16 max ulps {pc_ulps}, rgb9e5 "
        f"within 1 ulp {rgb_ok}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for f in ("key", "bkey", "cnt"):
        check(bad[f] == 0, f"projection: {f} differs on {bad[f]} entries")
    check(ix_err <= 1e-3, f"projection: ix/iy error {ix_err}")
    check(pc_ulps <= 1, f"projection: f16 halves {pc_ulps} ulps apart")
    check(rgb_ok, "projection: rgb9e5 fields more than 1 ulp apart")
    return {"name": "projection", "route": "cuda", "source": PROJ_SRC,
            "replaces": PROJ_TPU, "max_abs_err": ix_err, "ms": ms,
            "plain_ms": plain_ms}


def _frame_inputs(cloud, cfg, heatmap: float):
    dev = cloud.device
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=dev,
                           heatmap=heatmap)
    words = pk.project_words(cloud.means, cloud.cov3d, cloud.opacity,
                             cloud.sh, cloud.upload_time, uni.view, uni.proj,
                             uni.camera_pos, uni.model_scale, uni.time, cfg,
                             num_splats=cloud.num_splats)
    bf, bigs = build_block_frame2_words(words, cfg, words_payload=True)
    bins = bin_blocks2(bf, cfg)
    tbig = bin_bigs(bigs, cfg, obig=cfg.big_tile_capacity)
    rows = rv.pack_tile_rows_v3(bins.tile_blocks, bins.tile_nblocks,
                                tbig.tile_nbig, bins.tile_minmax,
                                bins.tile_candidates, uni.heatmap_factor,
                                cfg, tile_big_prefix=tbig.big_prefix)
    bigla = rv.prepass_big_la(tbig.bigpay, cfg)
    U = cfg.batch_u
    return (rows, bf.payload, tbig.bigpay, bigla, cfg, U,
            -(-bins.tile_blocks.shape[1] // U))


def phase_render(n: int, size: int) -> dict:
    dev = torch.device("cuda")
    cloud = gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        n, seed=2, scale_range=(0.005, 0.12), surfaces=True, device=dev)))
    cfg = gt.RasterizerConfig(width=size, height=size).fast_defaults()
    worst = 0.0
    times = []
    for hm in (0.0, 1.0):
        args = _frame_inputs(cloud, cfg, hm)
        rows = args[0]
        tk = rv._render_cuda(*args, early_exit=True)
        tr = rv.render_tiles_v3_reference(*args, early_exit=True)
        torch.cuda.synchronize()
        ik, tfk = rv.assemble_image_v3(tk, cfg)
        ir, tfr = rv.assemble_image_v3(tr, cfg)
        finite = bool(torch.isfinite(tk).all())
        mse = float(((ik[:3].clamp(0, 1) - ir[:3].clamp(0, 1)) ** 2).mean())
        psnr = 10 * np.log10(1.0 / max(mse, 1e-20))
        tf_err = float((tfk - tfr).abs().max())
        err = float((tk[:, :5] - tr[:, :5]).abs().max())
        worst = max(worst, err)
        nb = rows[:, 0, 0]
        log(f"[3 render] {n} splats {size}x{size} heatmap {hm}: PSNR "
            f"{psnr:.2f} dB, max |d t_final| {tf_err:.3g}, max |d| {err:.3g},"
            f" finite {finite}; tiles {rows.shape[0]}, blocks/tile mean "
            f"{float(nb.float().mean()):.1f} max {int(nb.max())}, tiles with "
            f"bigs {int((rows[:, 0, 4] > 0).sum())}, blocks processed "
            f"{int(tk[:, 5, 0].sum())} of {int(nb.sum())}")
        check(finite, "render: non-finite kernel output")
        check(psnr >= 50.0, f"render: PSNR {psnr:.2f} dB < 50")
        check(tf_err <= 1e-3, f"render: t_final error {tf_err}")
        if hm == 0.0:
            ms = time_ms(lambda: rv._render_cuda(*args, early_exit=True), 10)
            plain_ms = time_ms(lambda: rv.render_tiles_v3_reference(
                *args, early_exit=True), 2)
            times = [ms, plain_ms]
    log(f"[3 render] kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms")
    return {"name": "render_v3", "route": "cuda", "source": RENDER_SRC,
            "replaces": RENDER_TPU, "max_abs_err": worst, "ms": times[0],
            "plain_ms": times[1]}


def phase_frame(n: int, width: int, height: int, frames: int) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cloud = gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        n, seed=42, extent=4.0, scale_range=(0.004, 0.03), surfaces=True,
        device=dev)))
    setup_s = time.perf_counter() - t0
    cfg = gt.RasterizerConfig(width=width, height=height).fast_defaults()
    cams = gt.orbit_trajectory(frames, radius=5.0, target=(0, 0, 6.0))
    unis = [gt.make_uniforms(c, cfg, device=dev) for c in cams]
    out = gt.render_frame_fast(cloud, unis[0], cfg)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    frame_ms, stages = [], []
    for uni in unis:
        timer = gt.StageTimer(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = gt.render_frame_fast_staged(cloud, uni, cfg, timer=timer)
        b.record()
        stages.append(timer.times_ms())
        frame_ms.append(a.elapsed_time(b))
        check(bool(torch.isfinite(out.image).all()), "frame: non-finite image")
        check(int(out.stats.num_pairs) > 0, "frame: no splat-tile pairs")
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gx, gy = cfg.tile_dims
    centre = (gy // 2) * gx + gx // 2
    pick = gt.pick_splat_position_fast(out, centre, cloud, 1.0, cfg)
    check(bool(torch.isfinite(pick).all()), f"frame: centre pick {pick}")
    d_pick = float((cloud.means[:cloud.num_splats] - pick).norm(dim=1).min())
    check(d_pick < 1e-4, f"frame: centre pick is not a splat mean ({d_pick})")
    for name in ("projection", "render_v3"):
        check(launches[name] > 0, f"frame: kernel {name} never launched")
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    log(f"[4 frame] {n} splats {width}x{height}, {frames} orbit frames: "
        f"median {statistics.median(frame_ms):.3f} ms/frame (all "
        f"{[round(x, 3) for x in frame_ms]}), median stages "
        f"{json.dumps({k: round(v, 3) for k, v in med.items()})}, peak "
        f"memory {peak / 2**30:.2f} GiB, pairs {int(out.stats.num_pairs)}, "
        f"overflow {int(out.stats.num_overflow)}, launches "
        f"{json.dumps(launches)}, centre pick {pick.tolist()}, scene set-up "
        f"{setup_s:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was measured")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_device()
    rec = [phase_projection(1_000_000, 1920, 1080),
           phase_render(200_000, 512)]
    launches = phase_frame(5_800_000, 1920, 1080, 8)
    for r in rec:
        r["launches"] = launches[r["name"]]
    log(card)
    log(json.dumps({"kernels": rec}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
