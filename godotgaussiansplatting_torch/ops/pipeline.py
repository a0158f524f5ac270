"""The exact four-stage frame: projection -> sort -> boundaries -> render,
with its per-frame uniforms, statistics and picking.

Counterpart of ``godotgaussiansplatting_tpu/ops/pipeline.py``. Stage 1 is
the readable projection (ops/projection.py), stages 2-3 ops/sort.py and
stage 4 ops/render_exact.py, whose CUDA tensors go to the kernel
csrc/render_exact.cu. torch runs eagerly, so there is no jit-compiled
variant: ``render_frame`` is the whole frame.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..config import RasterizerConfig
from .projection import project_splats
from .render_exact import render_tiles
from .sort import emit_and_sort, tile_boundaries


class FrameUniforms(NamedTuple):
    """Per-frame state (the reference's uniforms and push constants,
    gaussian_splatting_rasterizer.gd:125-126, 181-193)."""

    view: torch.Tensor          # (4, 4) f32
    proj: torch.Tensor          # (4, 4) f32
    camera_pos: torch.Tensor    # (3,) f32, PLY frame
    model_scale: torch.Tensor   # () f32
    time: torch.Tensor          # () f32 seconds (fade-in clock)
    heatmap_factor: torch.Tensor  # () f32 0/1


# The packed uniform vector: view (16, row-major), proj (16), camera_pos (3),
# model_scale, time, heatmap_factor.
UNIFORM_WIDTH = 38


def pack_uniforms(view, proj, camera_pos, model_scale, time,
                  heatmap) -> np.ndarray:
    """A frame's uniforms as one (UNIFORM_WIDTH,) f32 host vector, the
    layout ``uniforms_from_buffer`` reads."""
    out = np.empty(UNIFORM_WIDTH, np.float32)
    out[0:16] = np.asarray(view, np.float32).reshape(16)
    out[16:32] = np.asarray(proj, np.float32).reshape(16)
    out[32:35] = np.asarray(camera_pos, np.float32).reshape(3)
    out[35:38] = (model_scale, time, heatmap)
    return out


def uniforms_from_buffer(buf: torch.Tensor) -> FrameUniforms:
    """FrameUniforms as views into one (UNIFORM_WIDTH,) f32 tensor, so that
    one copy uploads a frame's uniforms."""
    return FrameUniforms(view=buf[0:16].view(4, 4),
                         proj=buf[16:32].view(4, 4), camera_pos=buf[32:35],
                         model_scale=buf[35], time=buf[36],
                         heatmap_factor=buf[37])


def make_uniforms(camera, cfg: RasterizerConfig, model_scale: float = 1.0,
                  time: float = 1e9, heatmap: float = 0.0,
                  device="cuda") -> FrameUniforms:
    """Uniforms from a models.camera.Camera, on ``device`` (the card unless
    the caller asks for another; without a card the default raises)."""
    w, h = cfg.target_size
    values = pack_uniforms(camera.view_matrix(),
                           camera.projection_matrix(w, h),
                           camera.camera_pos_ply(), model_scale, time,
                           heatmap)
    return uniforms_from_buffer(torch.as_tensor(values, device=device))


class FrameStats(NamedTuple):
    num_pairs: torch.Tensor      # () i32 splat-tile pairs ("Rendered Splats")
    num_overflow: torch.Tensor   # () i32 pairs dropped by capacity caps
    max_tile_count: torch.Tensor  # () i32 densest tile


class FrameOutput(NamedTuple):
    image: torch.Tensor          # (H, W, 4) f32
    stats: FrameStats
    # what picking reads (get_splat_position):
    sorted_values: torch.Tensor  # (K_max,) i32
    tile_start: torch.Tensor     # (T,) i32
    tile_end: torch.Tensor       # (T,) i32
    tile_t0: torch.Tensor        # (T,) f32
    splat_pos: torch.Tensor      # (P, 3) model-scaled positions


def render_frame_staged(cloud, uniforms: FrameUniforms,
                        cfg: RasterizerConfig, tile_capacity: int = 2048,
                        timer=None) -> FrameOutput:
    """One exact frame in the reference's four stages (Projection, Sort,
    Boundaries, Render; gaussian_splatting_rasterizer.gd:135-160), each
    timed by ``timer`` (``timer.stage(name)``, e.g. ``StageTimer``) when
    one is passed."""
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    with stage("Projection"):
        prj = project_splats(
            cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uniforms.view, uniforms.proj,
            uniforms.camera_pos, uniforms.model_scale, uniforms.time, cfg)
    with stage("Sort"):
        pairs = emit_and_sort(prj.valid, prj.rect, prj.num_tiles,
                              prj.depth16, cfg)
    with stage("Boundaries"):
        start, end = tile_boundaries(pairs.keys, pairs.num_pairs, cfg)
    with stage("Render"):
        out = render_tiles(pairs.values, start, end, prj.image_pos,
                           prj.conic, prj.color, uniforms.heatmap_factor,
                           cfg, tile_capacity=tile_capacity)
    stats = FrameStats(num_pairs=pairs.num_pairs,
                       num_overflow=pairs.num_overflow,
                       max_tile_count=out.tile_counts.max())
    return FrameOutput(image=out.image, stats=stats,
                       sorted_values=pairs.values, tile_start=start,
                       tile_end=end, tile_t0=out.tile_t0, splat_pos=prj.pos)


def render_frame(cloud, uniforms: FrameUniforms, cfg: RasterizerConfig,
                 tile_capacity: int = 2048) -> FrameOutput:
    """One exact frame (the JAX package's ``render_frame`` and
    ``render_frame_jit``)."""
    return render_frame_staged(cloud, uniforms, cfg, tile_capacity)


def render_multiview(cloud, uniforms_batched: FrameUniforms,
                     cfg: RasterizerConfig,
                     tile_capacity: int = 2048) -> torch.Tensor:
    """Several views of one cloud: every field of ``uniforms_batched`` has a
    leading view axis. Returns (V, H, W, 4)."""
    n = uniforms_batched.view.shape[0]
    return torch.stack([
        render_frame(cloud, FrameUniforms(*(f[i] for f in uniforms_batched)),
                     cfg, tile_capacity).image
        for i in range(n)])


def pick_splat_position(frame: FrameOutput, tile_id) -> torch.Tensor:
    """The splat 10% into the tile's depth-sorted range
    (gaussian_splatting_rasterizer.gd:162-171, gsplat_render.glsl:103-110),
    or +inf when the tile is empty or its pixel (0, 0) is untouched. The
    host applies basis_override^-1 (-x, -y, z)."""
    s = frame.tile_start[tile_id].to(torch.int64)
    n = frame.tile_end[tile_id].to(torch.int64) - s
    K = frame.sorted_values.shape[0]
    idx = frame.sorted_values[torch.clamp(s + n // 10, 0, K - 1)]
    pos = frame.splat_pos[idx.to(torch.int64)]
    hit = (n > 0) & (frame.tile_t0[tile_id] != 1.0)
    return torch.where(hit, pos, float("inf"))
