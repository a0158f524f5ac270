"""A/B timing of the word-payload v3 render kernel: this checkout's against
another checkout's, in one process, on the same inputs.

    python3 -m godotgaussiansplatting_torch.ab_render OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another tree of this repository, for example
one unpacked with ``git archive <commit> | tar -x -C build/ab_base``. Its
port package is copied to ``build/ab/gsother`` and imported beside this
one; each builds its kernels from its own sources. The inputs are made once
with this checkout's pipeline under fast_defaults() and the reset camera:
200K splats at 512x512 (chip_smoke.py's phase 3) and the 5.8M-splat scene
at 1920x1080 (phase 6). For each, the script prints both render_v3
libraries' ptxas reports (registers, stack frame, spills), checks that
the two outputs are bit-equal, and times 20 calls of each kernel (CUDA
events, after a warm-up call) in the order other, this, this, other, three
times. Needs a CUDA device.
"""

from __future__ import annotations

import importlib
import json
import shutil
import sys
from pathlib import Path

import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_torch.ops import render_v3 as rv
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.binning2 import bin_blocks2
from godotgaussiansplatting_torch.ops.blocks2 import build_block_frame2_words

AB_DIR = Path(__file__).resolve().parent.parent / "build" / "ab"


def _import_other(root: Path):
    """The other checkout's render_v3 and kernels modules, as gsother."""
    dst = AB_DIR / "gsother"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "godotgaussiansplatting_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, str(AB_DIR))
    return (importlib.import_module("gsother.ops.render_v3"),
            importlib.import_module("gsother.kernels"))


def _inputs(n, seed, width, height, **scene):
    cloud = gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        n, seed=seed, surfaces=True, **scene)))
    cfg = gt.RasterizerConfig(width=width, height=height).fast_defaults()
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    words = pk.project_words(cloud.means, cloud.cov3d, cloud.opacity,
                             cloud.sh, cloud.upload_time, uni.view, uni.proj,
                             uni.camera_pos, uni.model_scale, uni.time, cfg,
                             num_splats=cloud.num_splats)
    bf, bigs = build_block_frame2_words(words, cfg, words_payload=True)
    tbig = bin_bigs(bigs, cfg, obig=cfg.big_tile_capacity)
    rows, bigla, U, max_batches = rv.tile_inputs(
        bin_blocks2(bf, cfg), tbig, uni.heatmap_factor, cfg)
    return (rows, bf.payload, tbig.bigpay, bigla, cfg, U, max_batches)


def _time_ms(fn, reps: int = 20) -> float:
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


def _ptxas(lib_module) -> list:
    """The stack, spill and register lines of a render_v3 build log."""
    logs = sorted(Path(lib_module.BUILD_DIR).glob("librender_v3-*.log"))
    return [ln.strip() for ln in logs[-1].read_text().splitlines()
            if "stack" in ln or "registers" in ln] if logs else []


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    other_rv, other_kernels = _import_other(Path(argv[0]).resolve())
    kernels.library("render_v3")
    other_kernels.library("render_v3")
    print("ptxas render_v3, other:", json.dumps(_ptxas(other_kernels)))
    print("ptxas render_v3, this:", json.dumps(_ptxas(kernels)))
    runs = {
        "200K 512x512": dict(n=200_000, seed=2, width=512, height=512,
                             scale_range=(0.005, 0.12)),
        "5.8M 1920x1080": dict(n=5_800_000, seed=42, width=1920,
                               height=1080, extent=4.0,
                               scale_range=(0.004, 0.03)),
    }
    for tag, kw in runs.items():
        args = _inputs(**kw)
        fns = {"other": lambda: other_rv._render_cuda(*args, True),
               "this": lambda: rv._render_cuda(*args, True)}
        same = torch.equal(fns["other"](), fns["this"]())
        ms = {k: [] for k in fns}
        for _ in range(3):
            for who in ("other", "this", "this", "other"):
                ms[who].append(_time_ms(fns[who]))
        print(f"{tag}: bit-equal {same}; ms per call {json.dumps(ms)}")
        del args, fns
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
