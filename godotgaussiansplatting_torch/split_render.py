"""Where the v3 render kernel's time goes at 1080p: copies of its source with
one stage dropped or one constant changed, each built and timed on the same
inputs; and the v4 kernel launched as plain thread blocks or as clusters.

    python3 -m godotgaussiansplatting_torch.split_render [SECTION ...] \
        [OTHER_CHECKOUT]

SECTION names the input sets to run (any of SECTIONS; all by default).
``words`` and ``cooked`` are chip_smoke.py's phase 6: the 5.8M-splat scene
at 1920x1080 and the reset camera, under fast_defaults() (word payload,
tile 32, U=2) and RasterizerConfig(quality="fast") (cooked payload, tile
16, U=4). ``main(argv, views)`` takes further input sets from a caller,
each a (tag, fast cloud view, cfg, camera) under the word payload
(``frame_inputs``'s arguments); with views and no
SECTION only the views run (``python3 -m portbench.render_views split``
hands it the benchmark's fast cells). For each input set, the script
prints the distribution of resident big lanes per tile (nbig), of batches
per tile and the share of batches that straddle a big lane. Then every
copy of csrc/render_v3.cu listed in STAGES and VARIANTS, and of
csrc/render_v4.cu in V4_VARIANTS (each edit must match the source), is
built with the kernels' nvcc flags into build/split/, the copies of one
source all started together, and its ptxas report printed (only the
copies the chosen input sets time). A stage copy runs on the rows cut to
the blocks the kernel processes with early exit, without early exit, so
every copy does the same batches; a variant runs as the frame does. Each
is timed over 10 calls (CUDA events, after a warm-up call). The ``v4``
section's copies (launched as plain CTAs, or in clusters of GT CTAs) run
on the inputs of RasterizerConfig(kernel="v4").fast_defaults() (cooked,
tile 32, U=2) and of RasterizerConfig(quality="fast", kernel="v4") (tile
16, U=4) at GT 1, 2 and 4, in the order A, B, B, A, beside this
checkout's cooked v3 kernel on the same inputs. With OTHER_CHECKOUT, a
tree of this repository whose v3 kernel reads prepass_big_la's maps (the
design before the in-kernel big lanes), its copies in OTHER_STAGES are
timed the same way, and so is prepass_big_la. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch.ab_render import (
    frame_inputs, import_other, scene_cloud, time_ms)
from godotgaussiansplatting_torch.ops import render_v3 as rv

SPLIT_DIR = Path(__file__).resolve().parent.parent / "build" / "split"
# The input sets, each chosen by naming it (all of them by default).
SECTIONS = ("words", "cooked", "v4")
_P, _I = ctypes.c_void_p, ctypes.c_int

_COMPOSITE = ("const bool more = composite_batch<T, PPT>(tl, k, U, n, q, ps, "
              "ts);", "const bool more = true;")
_EXACT = [("__expf(", "expf("),
          ("ex2_ftz(power_at(f, q) * LOG2E_F)", "expf(power_at(f, q))"),
          ("return lg2_ftz(1.0f - alpha) * LN2_F;", "return log1pf(-alpha);")]


def _consts(tile: int, ppt: int, min_blocks: int) -> list:
    return [(f"constexpr int PPT_TILE{tile} = ", f"constexpr int PPT_TILE{tile} = {ppt}; //"),
            (f"constexpr int MIN_BLOCKS_TILE{tile} = ",
             f"constexpr int MIN_BLOCKS_TILE{tile} = {min_blocks}; //")]


# Stage copies of this checkout's kernel: name -> edits.
STAGES = {
    "full": [],
    "no big lanes (front sum, exchange, finish)": [
        ("const bool has_big = nbig > 0;", "const bool has_big = false;"),
        ("for (int b = 0; b < tl.nbig; ++b) {", "for (int b = 0; b < 0; ++b) {")],
    "no emit": [("    j0 = emit_batch<PPT>(", "    if (false) j0 = emit_batch<PPT>("),
                ("    emit_batch<PPT>(tl, prv,", "    if (false) emit_batch<PPT>(tl, prv,")],
    "fetch, decode and rank count only": [_COMPOSITE],
    "fetch and decode only": [
        _COMPOSITE,
        ("for (int c2 = 0; c2 < n; ++c2) r += keys[c2] < key;", "r = c;")],
}
# Design items D (the warp's block of pixels), F and G of render_v3.cu
# undone: each warp owns the tile's rows w, w + 8, w + 16 and w + 24; the
# log-alphas take __expf and __logf; the batch total is summed apart from
# the emit's merge with the batch. The kernel so edited walks a tile as it
# did before those items, and must give the same bits.
_ROW_WARPS = [
    ("return ((w / BX) * WR + l / WC) * T + (w % BX) * WC + l % WC;",
     "return tid;"),
    ("return 32 / warp_cols<T>() * T;", "return T * T / (T == 32 ? 4 : 1);")]
_GUARDED_SFU = [
    ("ex2_ftz(power_at(f, q) * LOG2E_F)", "__expf(power_at(f, q))"),
    ("return lg2_ftz(1.0f - alpha) * LN2_F;", "return __logf(1.0f - alpha);")]
_TOTAL_APART = [
    ("for (int j = j0; j < n; ++j) {",
     "for (int i = 0; i < PPT; ++i) tot[i] = 0.0f;\n"
     "    for (int j = 0; j < n; ++j) {")]
BEFORE_D_F_G = _ROW_WARPS + _GUARDED_SFU + _TOTAL_APART
# Variants of this checkout's kernel: name -> (edits, inputs timed).
VARIANTS = {
    "as built": ([], ("words", "cooked", "views")),
    "exact expf and log1pf": (_EXACT, ("words", "cooked")),
    **{f"tile 32: {p} px/thread, {m} blocks/SM":
       (_consts(32, p, m), ("words",))
       for p, m in ((1, 1), (2, 1), (2, 2), (4, 1))},
    "tile 32: 2 px/thread, 1 block/SM, exact expf and log1pf":
        (_consts(32, 2, 1) + _EXACT, ("words",)),
    **{f"tile 16: {p} px/thread, {m} blocks/SM":
       (_consts(16, p, m), ("cooked",)) for p, m in ((1, 1), (2, 2))},
    "tile 32: each warp's pixels 16 x 8": (
        [("constexpr int WARP_COLS = 32;", "constexpr int WARP_COLS = 16;")],
        ("words", "views")),
    "tile 32: warp w's pixels in rows w, w + 8, w + 16, w + 24": (
        _ROW_WARPS, ("words", "views")),
    "log-alphas through __expf and __logf": (_GUARDED_SFU,
                                             ("words", "views")),
    "batch total apart from the emit's merge": (_TOTAL_APART,
                                                ("words", "views")),
    "without items D, F and G": (BEFORE_D_F_G, ("words", "views")),
}
# A copy of csrc/render_v4.cu whose entry point launches each group of GT
# tiles as one thread-block cluster of GT CTAs (the walk then gives cluster
# rank g tile grp * GT + g), on GT times the clusters the card holds at
# once, which gs_render_v4_max_clusters reports. The kernel itself keeps
# the plain launch (PERF.md section 6 has the comparison).
_V4_PLAIN_LAUNCH = """  return launch<true, true>(rows, payload, bigpay, out, dz, TG,
                            (TG + GT - 1) / GT * GT, gx, tile_size, U,
                            max_batches, obig, early_exit, grid, stream);
}"""
_V4_CLUSTER_LAUNCH = """  int threads = 0;
  const Kernel k = kernel_for<true, true>(tile_size, &threads);
  if (k == nullptr || grid % GT != 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(U, obig, true);
  const int err = allow_smem(k, bytes);
  if (err != 0) return err;
  const Params P{TG, gx, U, max_batches, obig, early_exit,
                 (TG + GT - 1) / GT * GT};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = GT;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, k, (const int32_t*)rows, payload, (const float*)bigpay,
      (float*)out, (float*)dz, P);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int gs_render_v4_max_clusters(int tile_size, int U, int GT,
                                         int OB) {
  int threads = 0;
  const Kernel k = kernel_for<true, true>(tile_size, &threads);
  const size_t bytes = smem_bytes(U, OB, true);
  if (k == nullptr || allow_smem(k, bytes) != 0) return -1;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = GT;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(GT);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, k, &cfg) == cudaSuccess ? n : -4;
}"""
V4_VARIANTS = {
    "plain CTAs (as built)": [],
    "clusters of GT CTAs": [(_V4_PLAIN_LAUNCH, _V4_CLUSTER_LAUNCH)],
}
# Stage copies of a kernel that reads the log-alpha maps and sorts each
# batch with a bitonic sort (the other checkout's).
_OLD_COMPOSITE = ("const bool more = composite_batch(tr, k, U, US, NPX, p, q, "
                  "ps, ts);", "const bool more = true;")
OTHER_STAGES = {
    "full": [],
    "no passes over the big lanes' maps": [
        ("  if (has_big) {\n    const float bminf = (float)bmin, bmaxf = "
         "(float)bmax;", "  if (false) {\n    const float bminf = (float)bmin,"
         " bmaxf = (float)bmax;")],
    "decode and bitonic sort only": [_OLD_COMPOSITE],
    "decode and sort only, every lane from the tile's first block": [
        _OLD_COMPOSITE,
        ("decode_lane<COOKED>(payload, row[128 + pos] & 0x7FFFFF,",
         "decode_lane<COOKED>(payload, row[128] & 0x7FFFFF,")],
}


def edited_sources(csrc: Path, edits: list,
                   source: str = "render_v3") -> dict:
    """{file name: text} of csrc/<source>.cu and the shared headers with
    the edits made. An edit replaces every match in the first file that
    holds it, and must match."""
    texts = {f.name: f.read_text()
             for f in (csrc / f"{source}.cu", *sorted(csrc.glob("*.cuh")))}
    for old, new in edits:
        hit = next((f for f, t in texts.items() if old in t), None)
        if hit is None:
            raise ValueError(f"edit does not match {csrc}: {old!r}")
        texts[hit] = texts[hit].replace(old, new)
    return texts


def build_copies(csrc: Path, copies: dict, tag: str,
                 source: str = "render_v3") -> dict:
    """{name: edits} of csrc/<source>.cu -> {name: (ctypes library, ptxas
    lines)}."""
    jobs = {}
    for i, (name, edits) in enumerate(copies.items()):
        d = SPLIT_DIR / f"{tag}{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f, t in edited_sources(csrc, edits, source).items():
            (d / f).write_text(t)
        so = d / f"lib{source}.so"
        jobs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
             str(d / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out, failed = {}, []
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {tag} {name}:\n{err}")
            continue
        out[name] = (ctypes.CDLL(str(so)),
                     [ln.strip() for ln in err.splitlines()
                      if "stack" in ln or "registers" in ln])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def launcher(lib, maps: bool):
    """A call (rows, payload, bigpay, bigla, cfg, U, max_batches,
    early_exit) of a copy's entry point. ``maps``: the entry points take
    the big log-alpha maps (the other checkout's signature)."""
    n_ptr = 6 if maps else 5
    for fn in ("gs_render_v3", "gs_render_v3_cooked"):
        getattr(lib, fn).argtypes = [_P] * n_ptr + [_I] * 8 + [_P]
    lib.gs_render_v3_max_blocks.argtypes = [_I] * (3 if maps else 4)

    def call(rows, payload, bigpay, bigla, cfg, U, max_batches, early_exit):
        cooked = payload.dtype == torch.float32
        TG, NPX, OB = rows.shape[0], cfg.tile_size ** 2, bigpay.shape[2]
        shape = (cfg.tile_size, U, int(cooked)) + (() if maps else (OB,))
        grid = min(TG, lib.gs_render_v3_max_blocks(*shape))
        out = torch.empty((TG, 8, NPX), device=rows.device)
        scratch = torch.zeros((grid, OB, NPX), device=rows.device)
        ptrs = [rows.data_ptr(), payload.data_ptr(), bigpay.data_ptr()]
        if maps:
            ptrs.append(bigla.transpose(1, 2).data_ptr())
        fn = lib.gs_render_v3_cooked if cooked else lib.gs_render_v3
        kernels.check(fn(*ptrs, out.data_ptr(), scratch.data_ptr(), TG,
                         cfg.tile_dims[0], cfg.tile_size, U, max_batches, OB,
                         int(early_exit), grid,
                         ctypes.c_void_p(kernels.stream_ptr(rows.device))),
                      "split copy launch")
        return out
    return call


def v4_launcher(lib, clusters: bool):
    """A call (rows, payload, bigpay, cfg, U, max_batches, GT) of a v4
    copy's entry point, early exit on; ``clusters``: the cluster copy."""
    lib.gs_render_v4.argtypes = kernels.SIGNATURES["render_v4"]["gs_render_v4"]
    lib.gs_render_v4_max_blocks.argtypes = [_I] * 3
    if clusters:
        lib.gs_render_v4_max_clusters.argtypes = [_I] * 4

    def call(rows, payload, bigpay, cfg, U, max_batches, GT):
        T, NPX, OB = rows.shape[0], cfg.tile_size ** 2, bigpay.shape[2]
        T4 = -(-T // GT)
        n = (GT * lib.gs_render_v4_max_clusters(cfg.tile_size, U, GT, OB)
             if clusters else lib.gs_render_v4_max_blocks(cfg.tile_size, U,
                                                          OB))
        if n <= 0:
            raise RuntimeError(f"v4 copy: occupancy query failed ({n})")
        grid = min(T4 * GT, n)
        out = torch.empty((T4, GT * NPX, 8), device=rows.device)
        dz = torch.zeros((grid, OB, NPX), device=rows.device)
        kernels.check(lib.gs_render_v4(
            rows.data_ptr(), payload.data_ptr(), bigpay.data_ptr(),
            out.data_ptr(), dz.data_ptr(), T, GT, cfg.tile_dims[0],
            cfg.tile_size, U, max_batches, OB, 1, grid,
            ctypes.c_void_p(kernels.stream_ptr(rows.device))),
            "v4 copy launch")
        return out
    return call


def _quantiles(x: torch.Tensor) -> dict:
    x = x.float().cpu().numpy()
    return {**{f"q{q}": float(np.quantile(x, q)) for q in (0, .5, .9, .99, 1)},
            "mean": float(x.mean())}


def straddling(rows, processed, U) -> tuple[int, int]:
    """(batches processed, of them straddling a big lane: the kernel's gate
    from the rows' big depth-bucket prefix)."""
    TG = rows.shape[0]
    mm = rows[:, 3:5].reshape(TG, 256).to(torch.int64) & 0xFFFFFFFF
    prefix = rows[:, 5].to(torch.int64)
    nbig = rows[:, 0, 4]
    n = ns = 0
    for k in range(-(-256 // U)):
        pos = k * U + torch.arange(U, device=rows.device)
        live = pos[None] < processed[:, None].long()
        act = live[:, 0]
        if not bool(act.any()):
            break
        m = mm[:, pos]
        bmin = torch.where(live, m >> 16, 0x10000).amin(1)
        bmax = torch.where(live, m & 0xFFFF, -1).amax(1)
        hi = prefix.gather(1, (bmax >> 9).clamp(0, 127)[:, None])[:, 0]
        b0 = (bmin >> 9).clamp(0, 127)
        lo = torch.where(b0 > 0, prefix.gather(
            1, (b0 - 1).clamp(min=0)[:, None])[:, 0], 0)
        n += int(act.sum())
        ns += int((act & (nbig > 0) & (hi != lo)).sum())
    return n, ns


def _time_copies(libs, entry, args, cut):
    """{copy: ms per call} of each copy in ``libs`` on one input set: the
    stage copies on the cut rows without early exit (the other checkout's
    only where ``args`` hold its big log-alpha maps), the variants timed on
    ``entry`` as the frame runs them."""
    ms = {}
    for name, (lib, _) in libs.items():
        other = name.startswith("other")
        call = launcher(lib, other)
        if name.startswith("variant"):
            if entry in VARIANTS[name.split(": ", 1)[1]][1]:
                ms[name] = time_ms(lambda: call(*args, True), 10)
        elif not other or args[3] is not None:
            ms[name] = time_ms(lambda: call(cut, *args[1:], False), 10)
    return ms


def _walked(tag, rows, payload, bigpay, cfg, U, mb):
    """The rows cut to the blocks the kernel processes with early exit,
    after printing the tiles' big lanes, batches walked and straddling
    batches."""
    processed = rv._render_cuda(rows, payload, bigpay, cfg, U, mb,
                                True)[:, 5, 0]
    cut = rows.clone()
    cut[:, 0, 0] = processed.to(torch.int32)
    n, ns = straddling(rows, processed, U)
    print(f"[{tag}] tile {cfg.tile_size} U={U}: {rows.shape[0]} tiles; "
          f"nbig {json.dumps(_quantiles(rows[:, 0, 4]))}; batches per "
          f"tile {json.dumps(_quantiles(torch.ceil(processed / U)))}; "
          f"{n} batches, {ns} straddle a big lane", flush=True)
    return cut


def main(argv, views=()) -> int:
    """``views``: further input sets, (tag, fast cloud view, cfg, camera)
    each, timed as ``words``; with views, only the SECTIONs named in
    ``argv`` run."""
    sections = ([a for a in argv if a in SECTIONS]
                or ([] if views else list(SECTIONS)))
    others = [a for a in argv if a not in SECTIONS]
    if len(others) > 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    inputs = set(sections) | ({"views"} if views else set())
    csrc = Path(kernels.CSRC)
    copies = ({f"stage: {k}": v for k, v in STAGES.items()}
              if inputs - {"v4"} else {})
    copies.update({f"variant: {k}": v[0] for k, v in VARIANTS.items()
                   if set(v[1]) & inputs})
    libs = build_copies(csrc, copies, "this")
    v4libs = (build_copies(csrc, V4_VARIANTS, "v4", "render_v4")
              if "v4" in sections else {})
    other_rv = None
    if others:
        other_rv, _ = import_other(Path(others[0]).resolve())
        libs.update({f"other stage: {k}": v for k, v in build_copies(
            Path(others[0]).resolve() / "godotgaussiansplatting_torch"
            / "csrc", OTHER_STAGES, "other").items()})
    for name, (_, ptxas) in {**libs, **v4libs}.items():
        print(f"ptxas {name}: {json.dumps(ptxas)}", flush=True)
    if {"words", "cooked"} & set(sections):
        cloud, base = scene_cloud("5.8M 1920x1080")
        for entry, cfg in (("words", base.fast_defaults()),
                           ("cooked", base.replace(quality="fast"))):
            if entry not in sections:
                continue
            rows, payload, bigpay, _, U, mb = frame_inputs(cloud, cfg)
            bigla = (other_rv.prepass_big_la(bigpay, cfg) if other_rv
                     else None)
            args = (rows, payload, bigpay, bigla, cfg, U, mb)
            cut = _walked(entry, rows, payload, bigpay, cfg, U, mb)
            ms = _time_copies(libs, entry, args, cut)
            if other_rv:
                ms["other: prepass_big_la"] = time_ms(
                    lambda: other_rv.prepass_big_la(bigpay, cfg), 10)
            print(f"[{entry}] ms per call {json.dumps(ms, indent=0)}",
                  flush=True)
            del args, bigla, cut
        del cloud
    for tag, cloud, cfg, camera in views:
        rows, payload, bigpay, _, U, mb = frame_inputs(cloud, cfg, camera)
        args = (rows, payload, bigpay, None, cfg, U, mb)
        cut = _walked(tag, rows, payload, bigpay, cfg, U, mb)
        print(f"[{tag}] ms per call "
              f"{json.dumps(_time_copies(libs, 'views', args, cut), indent=0)}",
              flush=True)
        del args, cut
    if "v4" not in sections:
        return 0
    cloud, base = scene_cloud("5.8M 1920x1080")
    calls = {name: v4_launcher(lib, name != "plain CTAs (as built)")
             for name, (lib, _) in v4libs.items()}
    names = list(calls)
    for cfg in (base.replace(kernel="v4").fast_defaults(),
                base.replace(quality="fast", kernel="v4")):
        rows, payload, bigpay, _, U, mb = frame_inputs(cloud, cfg)
        ms = {"cooked v3": time_ms(lambda: rv._render_cuda(
            rows, payload, bigpay, cfg, U, mb, True), 10)}
        for GT in (1, 2, 4):
            for name in names + names[::-1]:
                ms.setdefault(f"GT={GT} {name}", []).append(time_ms(
                    lambda: calls[name](rows, payload, bigpay, cfg, U, mb,
                                        GT), 10))
        print(f"[v4] tile {cfg.tile_size} U={U}: ms per call "
              f"{json.dumps(ms, indent=0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
