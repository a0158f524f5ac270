"""Fused projection for the fast path: one pass over the splats per frame.

Counterpart of ``godotgaussiansplatting_tpu/ops/projection_pallas.py``. Per
splat, in order:

    frustum cull (1.2*w margin) -> load fade-in -> EWA 2D covariance (with
    the reference's Jacobian quirk) -> eigen radius and tile count -> SH
    colour -> depth16 = clip(ndc.z^3 * 0xFFFF) -> f16 conic/opacity pairs ->
    rgb9e5 colour -> stage-1 key (morton15 << 16 | depth16) -> big-candidate
    chunk key (depth16 << 10 | col) -> per-chunk counts

Each output is written in the shape its consumer
(ops/blocks2.build_block_frame2_words) reads; u32 words are int32 bit
patterns:

    key   (1, P)         (morton15 << 16) | depth16, U32_MAX when culled
    ix,iy (1, P)         f32 pixel-space centre bits
    pc1   (1, P)         f16 pair ca | cb
    pc2   (1, P)         f16 pair cc | opacity
    rgb9  (1, P)         shared-exponent colour
    bkey  (P / CW, CW)   big-candidate chunk key, U32_MAX otherwise
    cnt   (1, (P/CPK)*128)  per CPK-chunk [128i] = big count,
                            [128i+1] = covered-tile count

``project_words`` launches the CUDA kernel (csrc/projection.cu) for CUDA
tensors and runs ``project_words_reference`` (plain torch, the same
formulas in the same order) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from ..config import RasterizerConfig
from .blocks import BIG_RADIUS
from .blocks2 import (SUPERBLOCK, U32_MAX, _big_chunk_width, _pack_f16,
                      _pack_rgb9e5, _spread8, adaptive_cell_shift,
                      extents_from_conic, i32)
from .projection import device_pair
from .sh import SH_C0, SH_C1, SH_C2, SH_C3


class ProjWords(NamedTuple):
    """Fused-projection outputs (see module docstring); all int32."""
    key: torch.Tensor
    ix: torch.Tensor
    iy: torch.Tensor
    pc1: torch.Tensor
    pc2: torch.Tensor
    rgb9: torch.Tensor
    bkey: torch.Tensor
    cnt: torch.Tensor


def _chunk(P: int) -> int:
    for c in (8192, 4096, 2048, 1024, 512, 256, 128):
        if P % c == 0:
            return c
    return P


def frame_uniform_vector(view, proj, camera_pos, model_scale, time,
                         cfg: RasterizerConfig) -> torch.Tensor:
    """The (37,) f32 per-frame vector both the kernel and the reference
    read: 0-8 view rotation (row-major), 9-11 view translation, 12-20 proj
    rotation block, 21-23 proj[:3, 3], 24-26 proj[3, :3], 27 proj[3, 3],
    28-30 camera position, 31 model scale, 32 time, 33-34 focal,
    35-36 tan(fov/2)."""
    w, h = cfg.target_size
    f32 = torch.float32
    dev = view.device
    dims = device_pair(w, h, dev)
    tan_fov_inv = torch.stack([proj[0, 0], proj[1, 1]])
    focal = dims * 0.5 * tan_fov_inv
    return torch.cat([
        view[:3, :3].reshape(-1), view[:3, 3], proj[:3, :3].reshape(-1),
        proj[:3, 3], proj[3, :3], proj[3, 3].reshape(1),
        camera_pos.reshape(3),
        torch.as_tensor(model_scale, dtype=f32, device=dev).reshape(1),
        torch.as_tensor(time, dtype=f32, device=dev).reshape(1),
        focal, 1.0 / tan_fov_inv,
    ]).to(f32).contiguous()


def project_words_reference(means, cov3d, opacity, sh, upload_time,
                            uni: torch.Tensor, cfg: RasterizerConfig,
                            cell: int) -> ProjWords:
    """Plain-torch version of the projection kernel (elementwise ops in the
    kernel's order). ``sh`` is planar (48, P) or (P, 16, 3)."""
    P = means.shape[0]
    w, h = cfg.target_size
    gx, gy = cfg.tile_dims
    ts = float(cfg.tile_size)
    CPK = _chunk(P)
    CW = _big_chunk_width(P, min(SUPERBLOCK, P))
    u = [uni[k] for k in range(37)]
    shp = sh if sh.ndim == 2 else sh.permute(1, 2, 0).reshape(48, P)

    ms = u[31]
    spx = means[:, 0] * ms
    spy = means[:, 1] * ms
    spz = means[:, 2] * ms
    vpx = u[0] * spx + u[1] * spy + u[2] * spz + u[9]
    vpy = u[3] * spx + u[4] * spy + u[5] * spz + u[10]
    vpz = u[6] * spx + u[7] * spy + u[8] * spz + u[11]
    clx = u[12] * vpx + u[13] * vpy + u[14] * vpz + u[21]
    cly = u[15] * vpx + u[16] * vpy + u[17] * vpz + u[22]
    clz = u[18] * vpx + u[19] * vpy + u[20] * vpz + u[23]
    clw = u[24] * vpx + u[25] * vpy + u[26] * vpz + u[27]

    bound = clw * 1.2
    inside = ((clx >= -bound) & (clx <= bound) & (cly >= -bound)
              & (cly <= bound) & (clz >= 0.0) & (clz <= clw))

    st = u[32] - upload_time

    def ease(x):
        a = 1.0 - x
        return 1.0 - a * a * a

    tf = ease(torch.clamp(st, 0.0, 1.0))
    tfl = ease(torch.clamp(st - 0.35, 0.0, 1.0))
    sop = opacity * tfl * tfl
    sscale = ms * (2.0 - tfl)

    s2 = sscale * sscale
    xx = cov3d[:, 0] * s2
    xy = cov3d[:, 1] * s2
    xz = cov3d[:, 2] * s2
    yy = cov3d[:, 3] * s2
    yz = cov3d[:, 4] * s2
    zz = cov3d[:, 5] * s2
    z_inv = 1.0 / vpz
    fzx = u[33] * z_inv
    fzy = u[34] * z_inv
    lim_x = u[35] * 1.3
    lim_y = u[36] * 1.3
    mx = torch.clamp(vpx * z_inv, -lim_x, lim_x)
    my = torch.clamp(vpy * z_inv, -lim_y, lim_y)
    jq = fzy if cfg.reference_jacobian_quirk else fzx
    njm = -jq * mx
    nfm = -fzy * my
    b0x = u[0] * fzx + u[6] * njm
    b0y = u[1] * fzx + u[7] * njm
    b0z = u[2] * fzx + u[8] * njm
    b1x = u[3] * fzy + u[6] * nfm
    b1y = u[4] * fzy + u[7] * nfm
    b1z = u[5] * fzy + u[8] * nfm
    s0x = xx * b0x + xy * b0y + xz * b0z
    s0y = xy * b0x + yy * b0y + yz * b0z
    s0z = xz * b0x + yz * b0y + zz * b0z
    cov_a = b0x * s0x + b0y * s0y + b0z * s0z + 0.3
    cov_b = b1x * s0x + b1y * s0y + b1z * s0z
    s1x = xx * b1x + xy * b1y + xz * b1z
    s1y = xy * b1x + yy * b1y + yz * b1z
    s1z = xz * b1x + yz * b1y + zz * b1z
    cov_c = b1x * s1x + b1y * s1y + b1z * s1z + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    nonsingular = det != 0.0
    mid = 0.5 * (cov_a + cov_c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1 = mid + disc
    lam2 = mid - disc
    eig_ok = (lam1 >= 0.0) & (lam2 >= 0.0)

    # direct divides, as the kernel: keeps depth16 and the screen cell
    # boundary-identical between the two
    safe_w = torch.where(clw == 0.0, torch.ones_like(clw), clw)
    ndcx = clx / safe_w
    ndcy = cly / safe_w
    ndcz = clz / safe_w
    ix = ((ndcx + 1.0) * 0.5 - (1.0 - tf)) * (w - 1.0)
    iy = ((ndcy + 1.0) * 0.5 - 0.75 * (1.0 - tf)) * (h - 1.0)

    radius = (torch.exp(0.2 * torch.log(torch.clamp(sop, min=1e-37))) * 2.5
              * torch.sqrt(torch.maximum(lam1, lam2)))
    radius = torch.where(sop > 0.0, radius, torch.zeros_like(radius))
    lox = torch.clamp((ix - radius) / ts, 0.0, float(gx)).to(torch.int32)
    loy = torch.clamp((iy - radius) / ts, 0.0, float(gy)).to(torch.int32)
    hix = torch.clamp(torch.ceil((ix + radius) / ts), 0.0, float(gx)).to(
        torch.int32)
    hiy = torch.clamp(torch.ceil((iy + radius) / ts), 0.0, float(gy)).to(
        torch.int32)
    nt = torch.clamp(hix - lox, min=0) * torch.clamp(hiy - loy, min=0)
    valid = inside & nonsingular & eig_ok & (nt > 0)
    nt = torch.where(valid, nt, 0)

    z3 = ndcz * ndcz * ndcz
    depth16 = torch.clamp(z3 * 65535.0, 0.0, 65534.0).to(torch.int64)

    dx = spx - u[28]
    dy = spy - u[29]
    dz = spz - u[30]
    inv_n = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    x = dx * inv_n
    y = dy * inv_n
    z = dz * inv_n
    deg = cfg.sh_degree

    def band(c):
        def co(k):
            return shp[3 * k + c].float()

        v = 0.5 + co(0) * SH_C0
        if deg >= 1:
            v = (v - co(1) * (SH_C1 * y) + co(2) * (SH_C1 * z)
                 - co(3) * (SH_C1 * x))
        if deg >= 2:
            xx2, yy2, zz2 = x * x, y * y, z * z
            v = (v + co(4) * (SH_C2[0] * (x * y))
                 - co(5) * (SH_C2[1] * (y * z))
                 + co(6) * (SH_C2[2] * (2.0 * zz2 - xx2 - yy2))
                 - co(7) * (SH_C2[3] * (x * z))
                 + co(8) * (SH_C2[4] * (xx2 - yy2)))
        if deg >= 3:
            v = (v - co(9) * (SH_C3[0] * y * (3.0 * xx2 - yy2))
                 + co(10) * (SH_C3[1] * x * (y * z))
                 - co(11) * (SH_C3[2] * y * (4.0 * zz2 - xx2 - yy2))
                 + co(12) * (SH_C3[3] * z * (2.0 * zz2 - 3.0 * xx2
                                             - 3.0 * yy2))
                 - co(13) * (SH_C3[4] * x * (4.0 * zz2 - xx2 - yy2))
                 + co(14) * (SH_C3[5] * z * (xx2 - yy2))
                 - co(15) * (SH_C3[6] * x * (xx2 - 3.0 * yy2)))
        return torch.clamp(v, min=0.0)

    r, g, b = band(0), band(1), band(2)

    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    det_inv = 1.0 / safe_det
    ca = cov_c * det_inv
    cb = -cov_b * det_inv
    cc = cov_a * det_inv

    pc1 = _pack_f16(ca, cb)
    pc2 = _pack_f16(cc, sop)
    rgb9 = _pack_rgb9e5(r, g, b)

    rx, ry = extents_from_conic(ca, cb, cc, sop)
    is_big = (torch.maximum(rx, ry) >= BIG_RADIUS) & valid
    col = torch.arange(P, dtype=torch.int64, device=means.device) % CW
    bkey = torch.where(is_big, (depth16 << 10) | col, U32_MAX)

    ctx = torch.clamp((ix / ts).to(torch.int32), 0, gx - 1).to(
        torch.int64) >> cell
    cty = torch.clamp((iy / ts).to(torch.int32), 0, gy - 1).to(
        torch.int64) >> cell
    morton = (_spread8(ctx & 0xFF) | (_spread8(cty & 0xFF) << 1)) & 0x7FFF
    key = torch.where(valid, (morton << 16) | depth16, U32_MAX)

    grid = P // CPK
    cnt = torch.zeros((grid, 128), dtype=torch.int32, device=means.device)
    cnt[:, 0] = is_big.reshape(grid, CPK).sum(dim=1).to(torch.int32)
    cnt[:, 1] = nt.reshape(grid, CPK).sum(dim=1).to(torch.int32)

    def row(a):
        return a.reshape(1, P)

    return ProjWords(
        key=row(i32(key)), ix=row(ix.view(torch.int32)),
        iy=row(iy.view(torch.int32)), pc1=row(pc1), pc2=row(pc2),
        rgb9=row(rgb9), bkey=i32(bkey).reshape(P // CW, CW),
        cnt=cnt.reshape(1, grid * 128))


def _project_words_cuda(means, cov3d, opacity, sh, upload_time, uni, cfg,
                        cell) -> ProjWords:
    P = means.shape[0]
    if sh.ndim != 2 or sh.shape != (48, P) or sh.dtype != torch.bfloat16:
        raise ValueError("project_words on CUDA needs planar (48, P) bf16 SH "
                         "(models.splats.fast_cloud_view)")
    for t, shape in ((means, (P, 3)), (cov3d, (P, 6)), (opacity, (P,)),
                     (upload_time, (P,)), (uni, (37,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"project_words: expected f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    kernels.require_cuda("project_words", means, cov3d, opacity, sh,
                         upload_time, uni)
    w, h = cfg.target_size
    gx, gy = cfg.tile_dims
    CPK = _chunk(P)
    CW = _big_chunk_width(P, min(SUPERBLOCK, P))
    if CW & (CW - 1) or P % CW or P % CPK:
        raise ValueError(f"project_words: unsupported capacity {P}")
    dev = means.device
    out = [torch.empty((1, P), dtype=torch.int32, device=dev)
           for _ in range(6)]
    bkey = torch.empty((P // CW, CW), dtype=torch.int32, device=dev)
    cnt = torch.empty((1, (P // CPK) * 128), dtype=torch.int32, device=dev)
    lib = kernels.library("projection")
    ptrs = [t.data_ptr() for t in (uni, means, cov3d, opacity, upload_time,
                                   sh, *out, bkey, cnt)]
    err = lib.gs_project_words(
        *ptrs, P, CPK, CW, cell, gx, gy, cfg.sh_degree,
        int(bool(cfg.reference_jacobian_quirk)),
        ctypes.c_float(w), ctypes.c_float(h), ctypes.c_float(cfg.tile_size),
        kernels.stream_ptr(dev))
    kernels.check(err, "projection kernel launch")
    kernels.count_launch("projection")
    return ProjWords(*out, bkey, cnt)


def project_words(means, cov3d, opacity, sh, upload_time, view, proj,
                  camera_pos, model_scale, time, cfg: RasterizerConfig,
                  num_splats: int | None = None) -> ProjWords:
    """One fused projection pass -> ProjWords. CUDA tensors go to the CUDA
    kernel (or raise); CPU tensors to the plain-torch version."""
    P = means.shape[0]
    gx, gy = cfg.tile_dims
    cell = adaptive_cell_shift(num_splats or P, gx, gy)
    uni = frame_uniform_vector(view, proj, camera_pos, model_scale, time, cfg)
    if means.device.type == "cpu":
        return project_words_reference(means, cov3d, opacity, sh,
                                       upload_time, uni, cfg, cell)
    return _project_words_cuda(means, cov3d, opacity, sh, upload_time, uni,
                               cfg, cell)
