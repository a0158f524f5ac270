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

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
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


def project_splats_reference(means, cov3d, opacity, sh, upload_time, view,
                             proj, camera_pos, model_scale, time,
                             cfg: RasterizerConfig) -> ProjectedSplats:
    """Plain version of the readable projection kernel: elementwise torch
    ops, each product and sum on its own, in the kernel's order (no matrix
    product or reduction, whose order on the card is the library's).
    ``sh`` is (P, 16, 3) (f32 or bf16) or the planar (48, P) view of
    ``fast_cloud_view``."""
    dev = means.device
    w, h = cfg.target_size
    gx, gy = cfg.tile_dims
    dims = device_pair(w, h, dev)
    if sh.ndim == 2:
        sh = sh.reshape(16, 3, -1).permute(2, 0, 1)
    V = view
    Q = proj

    # world/view/clip transforms (gsplat_projection.glsl:160-162)
    spx = means[:, 0] * model_scale
    spy = means[:, 1] * model_scale
    spz = means[:, 2] * model_scale
    vpx = V[0, 0] * spx + V[0, 1] * spy + V[0, 2] * spz + V[0, 3]
    vpy = V[1, 0] * spx + V[1, 1] * spy + V[1, 2] * spz + V[1, 3]
    vpz = V[2, 0] * spx + V[2, 1] * spy + V[2, 2] * spz + V[2, 3]
    clx = Q[0, 0] * vpx + Q[0, 1] * vpy + Q[0, 2] * vpz + Q[0, 3]
    cly = Q[1, 0] * vpx + Q[1, 1] * vpy + Q[1, 2] * vpz + Q[1, 3]
    clz = Q[2, 0] * vpx + Q[2, 1] * vpy + Q[2, 2] * vpz + Q[2, 3]
    clw = Q[3, 0] * vpx + Q[3, 1] * vpy + Q[3, 2] * vpz + Q[3, 3]

    # frustum cull with the margin, z in [0, w] (:163-166)
    bound = clw * 1.2
    inside = ((clx >= -bound) & (clx <= bound) & (cly >= -bound)
              & (cly <= bound) & (clz >= 0.0) & (clz <= clw))

    # load fade-in (:169-174)
    st = time - upload_time
    tf = ease_out_cubic(torch.clamp(st, 0.0, 1.0))
    tfl = ease_out_cubic(torch.clamp(st - 0.35, 0.0, 1.0))
    splat_opacity = opacity * tfl * tfl
    splat_scale = model_scale * (2.0 - tfl)

    # EWA 2D covariance (project_covariance, :124-142)
    s2 = splat_scale * splat_scale
    xx, xy, xz = cov3d[:, 0] * s2, cov3d[:, 1] * s2, cov3d[:, 2] * s2
    yy, yz, zz = cov3d[:, 3] * s2, cov3d[:, 4] * s2, cov3d[:, 5] * s2
    focal = dims * 0.5 * torch.stack([Q[0, 0], Q[1, 1]])
    lim = (1.0 / torch.stack([Q[0, 0], Q[1, 1]])) * 1.3
    z_inv = 1.0 / vpz
    fzx = focal[0] * z_inv
    fzy = focal[1] * z_inv
    mx = torch.clamp(vpx * z_inv, -lim[0], lim[0])
    my = torch.clamp(vpy * z_inv, -lim[1], lim[1])
    jq = fzy if cfg.reference_jacobian_quirk else fzx
    njm = -jq * mx
    nfm = -fzy * my
    b0x = V[0, 0] * fzx + V[2, 0] * njm
    b0y = V[0, 1] * fzx + V[2, 1] * njm
    b0z = V[0, 2] * fzx + V[2, 2] * njm
    b1x = V[1, 0] * fzy + V[2, 0] * nfm
    b1y = V[1, 1] * fzy + V[2, 1] * nfm
    b1z = V[1, 2] * fzy + V[2, 2] * nfm
    s0x = xx * b0x + xy * b0y + xz * b0z
    s0y = xy * b0x + yy * b0y + yz * b0z
    s0z = xz * b0x + yz * b0y + zz * b0z
    s1x = xx * b1x + xy * b1y + xz * b1z
    s1y = xy * b1x + yy * b1y + yz * b1z
    s1z = xz * b1x + yz * b1y + zz * b1z
    cov_a = b0x * s0x + b0y * s0y + b0z * s0z + 0.3
    cov_b = b1x * s0x + b1y * s0y + b1z * s0z
    cov_c = b1x * s1x + b1y * s1y + b1z * s1z + 0.3
    det = cov_a * cov_c - cov_b * cov_b
    nonsingular = det != 0.0
    mid = 0.5 * (cov_a + cov_c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1 = mid + disc
    lam2 = mid - disc
    eig_ok = (lam1 >= 0.0) & (lam2 >= 0.0)

    # image position with the load slide-in (:184-185)
    safe_w = torch.where(clw == 0.0, torch.ones_like(clw), clw)
    ndcx = clx / safe_w
    ndcy = cly / safe_w
    ndcz = clz / safe_w
    ix = ((ndcx + 1.0) * 0.5 - (1.0 - tf)) * (dims[0] - 1.0)
    iy = ((ndcy + 1.0) * 0.5 - 0.75 * (1.0 - tf)) * (dims[1] - 1.0)

    # opacity-biased radius and tile rect (:187-194)
    radius = (torch.pow(torch.clamp(splat_opacity, min=0.0), 0.2) * 2.5
              * torch.sqrt(torch.maximum(lam1, lam2)))
    ts = float(cfg.tile_size)
    grid = device_pair(gx, gy, dev)
    zero = torch.zeros_like(grid)
    lox = torch.clamp((ix - radius) / ts, zero[0], grid[0]).to(torch.int32)
    loy = torch.clamp((iy - radius) / ts, zero[1], grid[1]).to(torch.int32)
    hix = torch.clamp(torch.ceil((ix + radius) / ts), zero[0],
                      grid[0]).to(torch.int32)
    hiy = torch.clamp(torch.ceil((iy + radius) / ts), zero[1],
                      grid[1]).to(torch.int32)
    nt = torch.clamp(hix - lox, min=0) * torch.clamp(hiy - loy, min=0)
    valid = inside & nonsingular & eig_ok & (nt > 0)
    nt = torch.where(valid, nt, 0).to(torch.int32)

    # depth key: ndc.z^3 quantised to 16 bits (:218), 0xFFFF reserved
    z3 = ndcz * ndcz * ndcz
    depth16 = torch.clamp((z3 * 65535.0).to(torch.int64) & 0xFFFF,
                          max=0xFFFE).to(torch.int32)

    # SH colour (:198-203)
    dx = spx - camera_pos[0]
    dy = spy - camera_pos[1]
    dz = spz - camera_pos[2]
    nrm = torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    vd = torch.stack([dx / nrm, dy / nrm, dz / nrm], dim=-1)
    rgb = eval_sh_color(vd, sh, cfg.sh_degree)
    color = torch.cat([rgb, splat_opacity[:, None]], dim=-1)

    # conic = inverse 2D covariance, [c, -b, a] / det (:202)
    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([cov_c / safe_det, -cov_b / safe_det,
                         cov_a / safe_det], dim=-1)

    return ProjectedSplats(
        valid=valid, image_pos=torch.stack([ix, iy], dim=-1), conic=conic,
        color=color, depth16=depth16,
        rect=torch.stack([lox, loy, hix, hiy], dim=-1), num_tiles=nt,
        radius=radius, pos=torch.stack([spx, spy, spz], dim=-1))


def _on(x, dev) -> torch.Tensor:
    """A uniform as a contiguous f32 tensor on ``dev`` (a view when it is
    one already: no copy)."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def _project_splats_cuda(means, cov3d, opacity, sh, upload_time, view, proj,
                         camera_pos, model_scale, time,
                         cfg: RasterizerConfig) -> ProjectedSplats:
    """The kernel (csrc/projection_readable.cu): one thread a splat."""
    P = means.shape[0]
    if sh.shape != (P, 16, 3) or sh.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise ValueError("project_splats on CUDA needs (P, 16, 3) f32 or bf16"
                         " SH (fast_cloud_view(planar_sh=False)), got "
                         f"{sh.dtype} {tuple(sh.shape)}")
    for t, shape in ((means, (P, 3)), (cov3d, (P, 6)), (opacity, (P,)),
                     (upload_time, (P,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"project_splats: expected f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    dev = means.device
    uni = [_on(x, dev) for x in (view, proj, camera_pos, model_scale, time)]
    if [u.numel() for u in uni] != [16, 16, 3, 1, 1]:
        raise ValueError("project_splats: view and proj must be (4, 4), "
                         "camera_pos (3,), model_scale and time scalars")
    kernels.require_cuda("project_splats", means, cov3d, opacity, sh,
                         upload_time, *uni)
    if sh.data_ptr() % 16:
        raise ValueError("project_splats: the SH rows are read 16 bytes at "
                         "a time and must be 16-byte aligned")
    w, h = cfg.target_size
    gx, gy = cfg.tile_dims

    def out(*shape, dtype=torch.float32):
        return torch.empty((P, *shape), dtype=dtype, device=dev)

    prj = ProjectedSplats(
        valid=out(dtype=torch.bool), image_pos=out(2), conic=out(3),
        color=out(4), depth16=out(dtype=torch.int32),
        rect=out(4, dtype=torch.int32), num_tiles=out(dtype=torch.int32),
        radius=out(), pos=out(3))
    err = kernels.library("projection_readable").gs_project_readable(
        *(u.data_ptr() for u in uni),
        *(t.data_ptr() for t in (means, cov3d, opacity, upload_time, sh)),
        *(t.data_ptr() for t in prj), P, int(sh.dtype == torch.bfloat16),
        gx, gy, cfg.tile_size, cfg.sh_degree,
        int(bool(cfg.reference_jacobian_quirk)), ctypes.c_float(w),
        ctypes.c_float(h), kernels.stream_ptr(dev))
    kernels.check(err, "projection_readable kernel launch")
    kernels.count_launch("projection_readable")
    return prj


def project_splats(means, cov3d, opacity, sh, upload_time, view, proj,
                   camera_pos, model_scale, time,
                   cfg: RasterizerConfig) -> ProjectedSplats:
    """(P, ...) splat arrays and the frame's uniforms -> ProjectedSplats.
    CUDA tensors go to the kernel (csrc/projection_readable.cu), which
    takes (P, 16, 3) f32 or bf16 SH and raises on any other layout; CPU
    tensors to ``project_splats_reference``, which also reads the planar
    (48, P) SH of ``fast_cloud_view``."""
    if means.device.type == "cpu":
        return project_splats_reference(means, cov3d, opacity, sh,
                                        upload_time, view, proj, camera_pos,
                                        model_scale, time, cfg)
    return _project_splats_cuda(means, cov3d, opacity, sh, upload_time, view,
                                proj, camera_pos, model_scale, time, cfg)
