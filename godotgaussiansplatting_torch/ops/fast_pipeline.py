"""The fast frame: projection -> blocks -> binning -> composite.

Counterpart of ``godotgaussiansplatting_tpu/ops/fast_pipeline.py``. The
config picks each stage:

  * projection: the fused projection kernel (``projection_kernel``,
    csrc/projection.cu) or the readable projection (ops/projection.py)
    with the screen clustering of ``blocks2.build_block_frame2``;
  * payload: the (B, 8, S) words (``words_payload``) or the cooked
    (B, 16, S) f32 rows;
  * render: the v3 kernel (csrc/render_v3.cu, one entry point per payload)
    or the v4 lockstep kernel (``kernel="v4"``, csrc/render_v4.cu), which
    reads the cooked payload only.

The shipped frame (``RasterizerConfig.fast_defaults()``) is the fused
projection, the words and v3. The stages between the kernels are sorts,
gathers and elementwise torch ops, every shape fixed by the config and the
splat capacity, with no host read. ``render_frame_fast_staged`` runs them
eagerly; ``FastFrameGraph`` captures them as CUDA graphs and replays them
(the engine's fast frame on the card). CPU tensors take every stage's
plain-torch version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterizerConfig
from ..models.splats import SplatCloud
from ..utils.telemetry import NO_PHASES, OUTPUTS, StageTimer
from .bigbin import GROUP, TileBigs, bin_bigs
from .binning2 import TileBins2, bin_blocks2
from .blocks2 import (BLOCK_SIZE, DEPTH_INVALID, _unpack_bf16_pair,
                      build_block_frame2, build_block_frame2_words, u32)
from .pipeline import (FrameStats, FrameUniforms, StageGraphs, graph_key,
                       run_stages)
from .projection import ProjectedSplats, project_splats
from .projection_kernel import project_words
from .render_v3 import assemble_image_v3, render_tiles_v3
from .render_v4 import assemble_image_v4, render_tiles_v4


class FastFrameOutput(NamedTuple):
    image: torch.Tensor         # (4, H, W) f32 planar render target
    stats: FrameStats
    # picking state:
    tile_blocks: torch.Tensor   # (T, C2) i32
    tile_nblocks: torch.Tensor  # (T,) i32
    tile_t0: torch.Tensor       # (T,) f32 pixel (0, 0) transmittance per tile
    payload: torch.Tensor       # (B, 8, S) i32 words or (B, 16, S) f32 cooked
    tile_bigpay: torch.Tensor   # (T, 16, OBIG) f32 per-tile big-lane payload
    tile_nbig: torch.Tensor     # (T,) i32


def _check_supported(cfg: RasterizerConfig) -> None:
    if cfg.kernel not in ("v3", "v4"):
        raise ValueError(f"unknown render kernel {cfg.kernel!r}")
    if cfg.kernel == "v4" and cfg.words_payload:
        raise ValueError(
            "words_payload is a v3-kernel feature (the lockstep v4 kernel "
            "reads the cooked 16-row payload)")


def _slim_projection(prj: ProjectedSplats) -> ProjectedSplats:
    """Drop the ProjectedSplats fields the fast path never reads (the
    per-splat tile rect and square radius: blocks2 rebuilds anisotropic
    extents from the conic and opacity), so they are freed before the
    block build."""
    return prj._replace(rect=prj.rect.new_zeros((1, 4)),
                        radius=prj.radius.new_zeros((1,)))


def _frame_stages(cloud: SplatCloud, uniforms: FrameUniforms,
                  cfg: RasterizerConfig, supertile_cap: int = 1024,
                  tile_cap: int = 256, early_exit: bool = True,
                  lowp: bool = True, obig: int | None = None,
                  batch_u: int | None = None) -> tuple:
    """The fast frame's four stages as (name, function) pairs, in order:
    each function takes the one before's result (the first takes None) and
    the last returns the FastFrameOutput. The counterparts of the JAX
    package's ``_stage_project``, ``_stage_blocks``, ``_stage_bin`` and
    ``_stage_render``."""
    _check_supported(cfg)

    def project(_):
        args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                cloud.upload_time, uniforms.view, uniforms.proj,
                uniforms.camera_pos, uniforms.model_scale, uniforms.time,
                cfg)
        if cfg.projection_kernel:
            return project_words(*args, num_splats=cloud.num_splats)
        return _slim_projection(project_splats(*args))

    def blocks(prj):
        if cfg.projection_kernel:
            return build_block_frame2_words(
                prj, cfg, words_payload=cfg.words_payload,
                big_cap=cfg.big_capacity)
        return build_block_frame2(
            prj, cfg, num_splats=cloud.num_splats,
            words_payload=cfg.words_payload, big_cap=cfg.big_capacity)

    def binning(frame):
        bf, bigs = frame
        bins: TileBins2 = bin_blocks2(bf, cfg, supertile_cap=supertile_cap,
                                      tile_cap=tile_cap)
        tile_bigs: TileBigs = bin_bigs(bigs, cfg,
                                       obig=obig or cfg.big_tile_capacity)
        return bf, bins, tile_bigs

    def render(binned):
        bf, bins, tile_bigs = binned
        if cfg.kernel == "v4":
            tiles_fn, assemble = render_tiles_v4, assemble_image_v4
        else:
            tiles_fn, assemble = render_tiles_v3, assemble_image_v3
        tiles = tiles_fn(bf.payload, bins, tile_bigs,
                         uniforms.heatmap_factor, cfg, early_exit=early_exit,
                         lowp=lowp, batch_u=batch_u)
        image, t_final = assemble(tiles, cfg)
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

    return (("Projection", project), ("Blocks", blocks),
            ("Binning", binning), ("Render", render))


def render_frame_fast_staged(cloud: SplatCloud, uniforms: FrameUniforms,
                             cfg: RasterizerConfig, supertile_cap: int = 1024,
                             tile_cap: int = 256, early_exit: bool = True,
                             lowp: bool = True, obig: int | None = None,
                             batch_u: int | None = None,
                             timer: StageTimer | None = None
                             ) -> FastFrameOutput:
    """The fast frame in four stages (Projection, Blocks, Binning, Render),
    run eagerly, each timed by ``timer`` when one is passed. Raises
    ValueError for ``kernel="v4"`` with the word payload, as the JAX
    package does."""
    return run_stages(_frame_stages(cloud, uniforms, cfg, supertile_cap,
                                    tile_cap, early_exit, lowp, obig,
                                    batch_u), timer)


class FastFrameGraph(StageGraphs):
    """The fast frame as four captured CUDA graphs, one a stage (Projection,
    Blocks, Binning, Render; see ``pipeline.StageGraphs``): the port's
    counterpart of the JAX package's ``render_frame_fast_jit`` and its four
    stage jits (``_stage_project``, ``_stage_blocks``, ``_stage_bin``,
    ``_stage_render``), compiled once per static configuration. The frame
    is ``render_frame_fast_staged``'s, bit for bit. The graphs keep the
    cloud's addresses: refresh a streamed model's fast view in place
    (``models.splats.refresh_fast_view``). ``key`` is the ``graph_key`` it
    was captured for.

    Output: ``render`` copies ``image``, ``tile_t0`` and ``stats`` out of
    the graphs' buffers, so a frame a caller keeps is not overwritten by
    the next. The picking fields (``payload``, ``tile_blocks``,
    ``tile_nblocks``, ``tile_bigpay``, ``tile_nbig``) are the graphs'
    buffers: valid until the next ``render`` of this graph.
    """

    def __init__(self, cloud: SplatCloud, cfg: RasterizerConfig,
                 uniform_values):
        self.key = graph_key(cloud, cfg)
        self.cloud = cloud
        super().__init__(lambda uniforms: _frame_stages(cloud, uniforms, cfg),
                         cloud.means.device, uniform_values)

    def render(self, uniform_values, timer: StageTimer | None = None,
               phases=NO_PHASES) -> FastFrameOutput:
        """Replay the frame for one (UNIFORM_WIDTH,) f32 uniform vector,
        each stage timed by ``timer`` when one is passed, its host phases
        marked on ``phases`` (a ``utils.telemetry.HostPhases``)."""
        out = self.replay(uniform_values, timer, phases)
        phases.mark(OUTPUTS)
        return out._replace(
            image=out.image.clone(), tile_t0=out.tile_t0.clone(),
            stats=FrameStats(*(s.clone() for s in out.stats)))


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
    pays = frame.payload[ids]                      # (C2, 8 or 16, S)
    gx2 = -(-gx // GROUP)
    gid = (tile_id // gx) * gx2 + (tile_id % gx) // GROUP
    bigp = frame.tile_bigpay[gid]                              # (16, OB)
    if pays.dtype == torch.int32:
        # words: [key, ix, iy, pc1, pc2, rgb9, idx, rx|ry]
        ix_c = pays[:, 1].reshape(-1).view(torch.float32)
        iy_c = pays[:, 2].reshape(-1).view(torch.float32)
        rw_c = pays[:, 7].reshape(-1)
        d_chain = (u32(pays[:, 0].reshape(-1)) & 0xFFFF).float()
        idx_c = u32(pays[:, 6].reshape(-1))
    else:
        # cooked: ix, iy, rx|ry in rows 9-11, the sign-flipped rank in 12
        ix_c = pays[:, 9].reshape(-1)
        iy_c = pays[:, 10].reshape(-1)
        rw_c = pays[:, 11].reshape(-1).view(torch.int32)
        rank = u32(pays[:, 12].reshape(-1).view(torch.int32)) ^ 0x80000000
        d_chain = (rank >> 16).float()
        idx_c = u32(pays[:, 13].reshape(-1).view(torch.int32))
    ix = torch.cat([ix_c, bigp[9]])
    iy = torch.cat([iy_c, bigp[10]])
    rx, ry = _unpack_bf16_pair(torch.cat([rw_c, bigp[11].view(torch.int32)]))
    d_chain = torch.where(d_chain >= 65535.0, DEPTH_INVALID, d_chain)
    d_big = torch.where(bigp[12] >= 65535.0, DEPTH_INVALID, bigp[12])
    depth = torch.cat([d_chain, d_big])
    idx = torch.cat([idx_c, u32(bigp[13].view(torch.int32))])
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
