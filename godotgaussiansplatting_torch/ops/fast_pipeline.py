"""The fast frame: projection -> blocks -> binning -> v3 composite.

Counterpart of ``godotgaussiansplatting_tpu/ops/fast_pipeline.py`` for the
shipped fast path (``RasterizerConfig.fast_defaults()``): the fused
projection kernel, the word payload and the v3 render kernel. Two kernels
run per frame (csrc/projection.cu and csrc/render_v3.cu); the stages between
them are sorts, gathers and elementwise torch ops. CPU tensors take every
stage's plain-torch version.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..config import RasterizerConfig
from ..models.splats import SplatCloud
from .bigbin import GROUP, TileBigs, bin_bigs
from .binning2 import TileBins2, bin_blocks2
from .blocks2 import (BLOCK_SIZE, DEPTH_INVALID, _unpack_bf16_pair,
                      build_block_frame2_words, u32)
from .pipeline import FrameStats, FrameUniforms
from .projection_kernel import project_words
from .render_v3 import assemble_image_v3, render_tiles_v3


class FastFrameOutput(NamedTuple):
    image: torch.Tensor         # (4, H, W) f32 planar render target
    stats: FrameStats
    # picking state:
    tile_blocks: torch.Tensor   # (T, C2) i32
    tile_nblocks: torch.Tensor  # (T,) i32
    tile_t0: torch.Tensor       # (T,) f32 pixel (0, 0) transmittance per tile
    payload: torch.Tensor       # (B, 8, S) i32 block word payload
    tile_bigpay: torch.Tensor   # (T, 16, OBIG) f32 per-tile big-lane payload
    tile_nbig: torch.Tensor     # (T,) i32


def _check_supported(cfg: RasterizerConfig) -> None:
    if not cfg.projection_kernel:
        raise NotImplementedError(
            "projection_kernel=False (the readable projection) is not ported "
            "yet: ROADMAP queue 1 #8")
    if cfg.kernel != "v3":
        raise NotImplementedError(
            "kernel='v4' is not ported yet: ROADMAP queue 2 #3")
    if not cfg.words_payload:
        raise NotImplementedError(
            "the cooked 16-row payload (words_payload=False) is not ported "
            "yet: ROADMAP queue 2 #2b")


class StageTimer:
    """Per-stage device times of one frame, from CUDA events recorded on the
    current stream around each stage. It measures the card only: a
    non-CUDA device raises. ``times_ms()`` waits for the recorded work and
    returns {stage: ms}."""

    def __init__(self, device: torch.device):
        if torch.device(device).type != "cuda":
            raise ValueError("StageTimer times CUDA work only")
        self._marks = []

    @contextlib.contextmanager
    def stage(self, name: str):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self._marks.append((name, a, b))

    def times_ms(self) -> dict:
        torch.cuda.synchronize()
        return {n: a.elapsed_time(b) for n, a, b in self._marks}


def render_frame_fast_staged(cloud: SplatCloud, uniforms: FrameUniforms,
                             cfg: RasterizerConfig, supertile_cap: int = 1024,
                             tile_cap: int = 256, early_exit: bool = True,
                             lowp: bool = True, obig: int | None = None,
                             batch_u: int | None = None,
                             timer: StageTimer | None = None
                             ) -> FastFrameOutput:
    """The fast frame in four stages (Projection, Blocks, Binning, Render),
    each timed by ``timer`` when one is passed."""
    _check_supported(cfg)
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    with stage("Projection"):
        words = project_words(
            cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uniforms.view, uniforms.proj,
            uniforms.camera_pos, uniforms.model_scale, uniforms.time, cfg,
            num_splats=cloud.num_splats)
    with stage("Blocks"):
        bf, bigs = build_block_frame2_words(words, cfg,
                                            words_payload=cfg.words_payload,
                                            big_cap=cfg.big_capacity)
    with stage("Binning"):
        bins: TileBins2 = bin_blocks2(bf, cfg, supertile_cap=supertile_cap,
                                      tile_cap=tile_cap)
        tile_bigs: TileBigs = bin_bigs(bigs, cfg,
                                       obig=obig or cfg.big_tile_capacity)
    with stage("Render"):
        tiles = render_tiles_v3(bf.payload, bins, tile_bigs,
                                uniforms.heatmap_factor, cfg,
                                early_exit=early_exit, lowp=lowp,
                                batch_u=batch_u)
        image, t_final = assemble_image_v3(tiles, cfg)
    stats = FrameStats(
        num_pairs=bf.num_culled_pairs,
        num_overflow=bins.overflow + tile_bigs.overflow,
        max_tile_count=bins.tile_candidates.max(),
    )
    return FastFrameOutput(
        image=image, stats=stats,
        tile_blocks=bins.tile_blocks, tile_nblocks=bins.tile_nblocks,
        tile_t0=t_final[:, 0], payload=bf.payload,
        tile_bigpay=tile_bigs.bigpay, tile_nbig=tile_bigs.tile_nbig)


def render_frame_fast(cloud: SplatCloud, uniforms: FrameUniforms,
                      cfg: RasterizerConfig, supertile_cap: int = 1024,
                      tile_cap: int = 256, early_exit: bool = True,
                      lowp: bool = True, obig: int | None = None,
                      batch_u: int | None = None) -> FastFrameOutput:
    """One fast-path frame (see module docstring). ``lowp`` is accepted
    for signature parity; the port computes in f32."""
    return render_frame_fast_staged(cloud, uniforms, cfg, supertile_cap,
                                    tile_cap, early_exit, lowp, obig,
                                    batch_u)


def _pick_fast(frame: FastFrameOutput, tile_id: int, means: torch.Tensor,
               model_scale: float, cfg: RasterizerConfig) -> torch.Tensor:
    """The reference picks the splat 10% into the tile's depth-sorted
    covered range (gsplat_render.glsl:103-110): gather the tile's chain and
    big lanes, keep those whose rect covers the tile, take the (n/10)-th
    smallest depth (stable on ties) and return its world position."""
    S = BLOCK_SIZE
    gx, _ = cfg.tile_dims
    ts = float(cfg.tile_size)
    dev = frame.payload.device
    entries = frame.tile_blocks[tile_id].to(torch.int64)
    entry_ok = entries >= 0
    ids = torch.where(entry_ok, entries & 0x7FFFFF, 0)
    pays = frame.payload[ids]                                  # (C2, 8, S)
    gx2 = -(-gx // GROUP)
    gid = (tile_id // gx) * gx2 + (tile_id % gx) // GROUP
    bigp = frame.tile_bigpay[gid]                              # (16, OB)
    ix = torch.cat([pays[:, 1].reshape(-1).view(torch.float32), bigp[9]])
    iy = torch.cat([pays[:, 2].reshape(-1).view(torch.float32), bigp[10]])
    rw = torch.cat([pays[:, 7].reshape(-1), bigp[11].view(torch.int32)])
    rx, ry = _unpack_bf16_pair(rw)
    d_chain = (u32(pays[:, 0].reshape(-1)) & 0xFFFF).float()
    d_chain = torch.where(d_chain >= 65535.0, DEPTH_INVALID, d_chain)
    d_big = torch.where(bigp[12] >= 65535.0, DEPTH_INVALID, bigp[12])
    depth = torch.cat([d_chain, d_big])
    idx = torch.cat([u32(pays[:, 6].reshape(-1)),
                     u32(bigp[13].view(torch.int32))])
    lane_ok = torch.cat([entry_ok[:, None].expand(-1, S).reshape(-1),
                         torch.ones(bigp.shape[1], dtype=torch.bool,
                                    device=dev)])
    tx = float(tile_id % gx) * ts
    ty = float(tile_id // gx) * ts
    covered = ((ix - rx < tx + ts) & (ix + rx > tx)
               & (iy - ry < ty + ts) & (iy + ry > ty)
               & (depth < DEPTH_INVALID) & lane_ok)
    key = torch.where(covered, depth, DEPTH_INVALID)
    order = torch.sort(key, stable=True).indices
    n = int(covered.sum())
    k = min(max(n // 10, 0), key.shape[0] - 1)
    pos = means[idx[order[k]]] * model_scale
    hit = n > 0 and float(frame.tile_t0[tile_id]) != 1.0
    return pos if hit else torch.full_like(pos, float("inf"))


def pick_splat_position_fast(frame: FastFrameOutput, tile_id: int,
                             cloud: SplatCloud, model_scale: float,
                             cfg: RasterizerConfig) -> torch.Tensor:
    """Fast-path picking; returns the PLY-frame position or +inf."""
    return _pick_fast(frame, int(tile_id), cloud.means, float(model_scale),
                      cfg)
