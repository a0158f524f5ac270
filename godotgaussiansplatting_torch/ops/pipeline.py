"""Per-frame uniforms and frame statistics.

Counterpart of ``godotgaussiansplatting_tpu/ops/pipeline.py:25-57``
(``FrameUniforms``, ``make_uniforms``, ``FrameStats``). The exact-path frame
of that module is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterizerConfig


class FrameUniforms(NamedTuple):
    """Per-frame state (the reference's uniforms and push constants,
    gaussian_splatting_rasterizer.gd:125-126, 181-193)."""

    view: torch.Tensor          # (4, 4) f32
    proj: torch.Tensor          # (4, 4) f32
    camera_pos: torch.Tensor    # (3,) f32, PLY frame
    model_scale: torch.Tensor   # () f32
    time: torch.Tensor          # () f32 seconds (fade-in clock)
    heatmap_factor: torch.Tensor  # () f32 0/1


def make_uniforms(camera, cfg: RasterizerConfig, model_scale: float = 1.0,
                  time: float = 1e9, heatmap: float = 0.0,
                  device="cuda") -> FrameUniforms:
    """Uniforms from a models.camera.Camera, on ``device`` (the card unless
    the caller asks for another; without a card the default raises)."""
    w, h = cfg.target_size

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return FrameUniforms(
        view=t(camera.view_matrix()),
        proj=t(camera.projection_matrix(w, h)),
        camera_pos=t(camera.camera_pos_ply()),
        model_scale=t(model_scale),
        time=t(time),
        heatmap_factor=t(heatmap),
    )


class FrameStats(NamedTuple):
    num_pairs: torch.Tensor      # () i32 splat-tile pairs ("Rendered Splats")
    num_overflow: torch.Tensor   # () i32 pairs dropped by capacity caps
    max_tile_count: torch.Tensor  # () i32 densest tile
