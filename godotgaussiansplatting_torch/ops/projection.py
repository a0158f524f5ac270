"""The readable projection: per-splat frustum cull, EWA covariance
projection and SH colour.

Counterpart of ``godotgaussiansplatting_tpu/ops/projection.py``
(``gsplat_projection.glsl``): one elementwise torch program over the padded
splat axis. Every splat keeps its slot and carries a validity mask and a
tile count instead of being compacted. The reference's numeric quirks are
kept: the 1.2*w frustum margin with z in [0, w], the +0.3 dilation, the
eigenvalue floor sqrt(max(0.1, .)), the -focal.y*mean.x Jacobian quirk, the
opacity^0.2 * 2.5 sigma radius, depth16 = ndc.z^3 * 0xFFFF (clamped to
0xFFFE, the invalid sentinel being 0xFFFF) and the load fade-in.

It feeds the fast path when ``cfg.projection_kernel`` is False
(``ops/blocks2.build_block_frame2``), and is the readable statement of what
the fused projection kernel (ops/projection_kernel.py) computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterizerConfig
from .sh import eval_sh_color


class ProjectedSplats(NamedTuple):
    """Per-splat outputs, one slot per input splat (no compaction)."""

    valid: torch.Tensor       # (P,) bool survived all culls
    image_pos: torch.Tensor   # (P, 2) f32 pixel-space centre
    conic: torch.Tensor       # (P, 3) f32 inverse 2D covariance [c,-b,a]/det
    color: torch.Tensor       # (P, 4) f32 rgb + final opacity
    depth16: torch.Tensor     # (P,) i32 quantised depth key (low 16 bits)
    rect: torch.Tensor        # (P, 4) i32 tile rect [x0, y0, x1, y1)
    num_tiles: torch.Tensor   # (P,) i32 tiles touched (0 if culled)
    radius: torch.Tensor      # (P,) f32 opacity-biased radius (px)
    pos: torch.Tensor         # (P, 3) f32 model-scaled PLY-frame position


def device_pair(a: float, b: float, device) -> torch.Tensor:
    """(2,) f32 [a, b] made on ``device`` by fills, with no copy from host
    memory (a CUDA graph cannot capture one; a Python scalar assigned by
    index is such a copy too)."""
    out = torch.full((2,), float(a), dtype=torch.float32, device=device)
    out[1].fill_(float(b))
    return out


def ease_out_cubic(x: torch.Tensor) -> torch.Tensor:
    """gsplat_projection.glsl:87-90."""
    a = 1.0 - x
    return 1.0 - a * a * a


def project_splats(means, cov3d, opacity, sh, upload_time, view, proj,
                   camera_pos, model_scale, time,
                   cfg: RasterizerConfig) -> ProjectedSplats:
    """(P, ...) splat arrays and the frame's uniforms -> ProjectedSplats.
    ``sh`` is (P, 16, 3) (f32 or bf16) or the planar (48, P) view of
    ``fast_cloud_view``."""
    f32 = torch.float32
    dev = means.device
    w, h = cfg.target_size
    gx, gy = cfg.tile_dims
    dims = device_pair(w, h, dev)
    if sh.ndim == 2:
        sh = sh.reshape(16, 3, -1).permute(2, 0, 1)

    # world/view/clip transforms (gsplat_projection.glsl:160-162)
    splat_pos = means * model_scale
    vp = splat_pos @ view[:3, :3].T + view[:3, 3]
    clip = vp @ proj[:3, :3].T + proj[:3, 3]
    clip_w = vp @ proj[3, :3] + proj[3, 3]

    # frustum cull with the margin, z in [0, w] (:163-166)
    bound = clip_w * 1.2
    inside = ((clip[:, 0] >= -bound) & (clip[:, 0] <= bound)
              & (clip[:, 1] >= -bound) & (clip[:, 1] <= bound)
              & (clip[:, 2] >= 0.0) & (clip[:, 2] <= clip_w))

    # load fade-in (:169-174)
    st = time - upload_time
    tf = ease_out_cubic(torch.clamp(st, 0.0, 1.0))
    tfl = ease_out_cubic(torch.clamp(st - 0.35, 0.0, 1.0))
    splat_opacity = opacity * tfl * tfl
    splat_scale = model_scale * (2.0 - tfl)

    # EWA 2D covariance (project_covariance, :124-142)
    c3 = cov3d * (splat_scale * splat_scale)[:, None]
    tan_fov_inv = torch.stack([proj[0, 0], proj[1, 1]])
    focal = dims * 0.5 * tan_fov_inv
    tan_fov = 1.0 / tan_fov_inv
    z_inv = 1.0 / vp[:, 2]
    fzx = focal[0] * z_inv
    fzy = focal[1] * z_inv
    mx = torch.clamp(vp[:, 0] * z_inv, -tan_fov[0] * 1.3, tan_fov[0] * 1.3)
    my = torch.clamp(vp[:, 1] * z_inv, -tan_fov[1] * 1.3, tan_fov[1] * 1.3)
    jq = fzy if cfg.reference_jacobian_quirk else fzx
    Rv = view[:3, :3]
    b0 = (Rv[0] * fzx[:, None]) + (Rv[2] * (-jq * mx)[:, None])
    b1 = (Rv[1] * fzy[:, None]) + (Rv[2] * (-fzy * my)[:, None])
    xx, xy, xz = c3[:, 0], c3[:, 1], c3[:, 2]
    yy, yz, zz = c3[:, 3], c3[:, 4], c3[:, 5]

    def sigma_dot(v):
        return torch.stack([
            xx * v[:, 0] + xy * v[:, 1] + xz * v[:, 2],
            xy * v[:, 0] + yy * v[:, 1] + yz * v[:, 2],
            xz * v[:, 0] + yz * v[:, 1] + zz * v[:, 2],
        ], dim=-1)

    s0 = sigma_dot(b0)
    cov_a = torch.sum(b0 * s0, dim=-1) + 0.3
    cov_b = torch.sum(b1 * s0, dim=-1)
    cov_c = torch.sum(b1 * sigma_dot(b1), dim=-1) + 0.3
    det = cov_a * cov_c - cov_b * cov_b
    nonsingular = det != 0.0
    mid = 0.5 * (cov_a + cov_c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1 = mid + disc
    lam2 = mid - disc
    eig_ok = (lam1 >= 0.0) & (lam2 >= 0.0)

    # image position with the load slide-in (:184-185)
    safe_w = torch.where(clip_w == 0, torch.ones_like(clip_w), clip_w)
    ndc = clip / safe_w[:, None]
    shift = torch.stack([1.0 - tf, 0.75 * (1.0 - tf)], dim=-1)
    image_pos = ((ndc[:, :2] + 1.0) * 0.5 - shift) * (dims - 1.0)

    # opacity-biased radius and tile rect (:187-194)
    radius = (torch.pow(torch.clamp(splat_opacity, min=0.0), 0.2) * 2.5
              * torch.sqrt(torch.maximum(lam1, lam2)))
    ts = float(cfg.tile_size)
    grid = device_pair(gx, gy, dev)
    lo = torch.clamp((image_pos - radius[:, None]) / ts,
                     torch.zeros_like(grid), grid).to(torch.int32)
    hi = torch.clamp(torch.ceil((image_pos + radius[:, None]) / ts),
                     torch.zeros_like(grid), grid).to(torch.int32)
    nt = (torch.clamp(hi[:, 0] - lo[:, 0], min=0)
          * torch.clamp(hi[:, 1] - lo[:, 1], min=0))
    valid = inside & nonsingular & eig_ok & (nt > 0)
    nt = torch.where(valid, nt, 0).to(torch.int32)

    # depth key: ndc.z^3 quantised to 16 bits (:218), 0xFFFF reserved
    z3 = ndc[:, 2] * ndc[:, 2] * ndc[:, 2]
    depth16 = torch.clamp((z3 * 65535.0).to(torch.int64) & 0xFFFF,
                          max=0xFFFE).to(torch.int32)

    # SH colour (:198-203)
    vd = splat_pos - camera_pos
    vd = vd / torch.clamp(torch.sqrt(torch.sum(vd * vd, dim=-1,
                                               keepdim=True)), min=1e-12)
    rgb = eval_sh_color(vd, sh, cfg.sh_degree)
    color = torch.cat([rgb, splat_opacity[:, None]], dim=-1)

    # conic = inverse 2D covariance, [c, -b, a] / det (:202)
    safe_det = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([cov_c, -cov_b, cov_a], dim=-1) / safe_det[:, None]

    return ProjectedSplats(valid=valid, image_pos=image_pos, conic=conic,
                           color=color, depth16=depth16,
                           rect=torch.cat([lo, hi], dim=-1), num_tiles=nt,
                           radius=radius, pos=splat_pos)
