"""Pure-NumPy oracle renderer: the reference algorithm, literally.

A copy of ``godotgaussiansplatting_tpu/ops/oracle.py`` on the port's
``SplatCloud`` (its tensors are read back to the host), config and SH
constants. Slow, host-side and loop-based, it reproduces
`gsplat_projection.glsl`, `gsplat_boundaries.glsl` and `gsplat_render.glsl`
with sequential per-pixel blending, unlimited tiles per splat and the
boundary quirks, so the port's exact frame can be tested against it.
"""

from __future__ import annotations

import numpy as np

from ..config import MIN_FACTOR, RasterizerConfig
from ..models.splats import SplatCloud
from .sh import SH_C0, SH_C1, SH_C2, SH_C3


def _eval_sh_np(vd, sh, degree):
    x, y, z = vd[:, 0:1], vd[:, 1:2], vd[:, 2:3]
    c = 0.5 + sh[:, 0] * SH_C0
    if degree >= 1:
        c = c - sh[:, 1] * (SH_C1 * y) + sh[:, 2] * (SH_C1 * z) - sh[:, 3] * (SH_C1 * x)
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + sh[:, 4] * (SH_C2[0] * xy) - sh[:, 5] * (SH_C2[1] * yz)
             + sh[:, 6] * (SH_C2[2] * (2 * zz - xx - yy))
             - sh[:, 7] * (SH_C2[3] * xz) + sh[:, 8] * (SH_C2[4] * (xx - yy)))
    if degree >= 3:
        c = (c - sh[:, 9] * (SH_C3[0] * y * (3 * xx - yy))
             + sh[:, 10] * (SH_C3[1] * x * yz)
             - sh[:, 11] * (SH_C3[2] * y * (4 * zz - xx - yy))
             + sh[:, 12] * (SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy))
             - sh[:, 13] * (SH_C3[4] * x * (4 * zz - xx - yy))
             + sh[:, 14] * (SH_C3[5] * z * (xx - yy))
             - sh[:, 15] * (SH_C3[6] * x * (xx - 3 * yy)))
    return np.maximum(c, 0.0)


def oracle_render(
    cloud: SplatCloud,
    view: np.ndarray,
    proj: np.ndarray,
    camera_pos: np.ndarray,
    cfg: RasterizerConfig,
    model_scale: float = 1.0,
    time: float = 1e9,
    heatmap_factor: float = 0.0,
):
    """Render one frame. Returns (image (H,W,4) f32, info dict)."""
    f = np.float32
    n = cloud.num_splats

    def host(t):
        return t.detach().float().cpu().numpy()[:n].astype(f)

    means = host(cloud.means)
    cov3d = host(cloud.cov3d)
    opacity = host(cloud.opacity)
    sh = host(cloud.sh)
    uptime = host(cloud.upload_time)
    view = np.asarray(view, f)
    proj = np.asarray(proj, f)
    w, h = cfg.target_size
    gx, gy = cfg.tile_dims
    dims = np.array([w, h], f)
    ts = cfg.tile_size

    # --- projection (gsplat_projection.glsl:150-226) ---
    splat_pos = means * f(model_scale)
    vp = splat_pos @ view[:3, :3].T + view[:3, 3]
    clip = vp @ proj[:3, :3].T + proj[:3, 3]
    clip_w = vp @ proj[3, :3] + proj[3, 3]
    bound = clip_w * f(1.2)
    inside = ((clip[:, 0] >= -bound) & (clip[:, 0] <= bound)
              & (clip[:, 1] >= -bound) & (clip[:, 1] <= bound)
              & (clip[:, 2] >= 0) & (clip[:, 2] <= clip_w))

    st = f(time) - uptime
    tf = 1 - (1 - np.clip(st, 0, 1)) ** 3
    tfl = 1 - (1 - np.clip(st - 0.35, 0, 1)) ** 3
    sop = opacity * tfl * tfl
    sscale = f(model_scale) * (2.0 - tfl)

    c3 = cov3d * (sscale * sscale)[:, None]
    tfi = np.array([proj[0, 0], proj[1, 1]], f)
    focal = dims * 0.5 * tfi
    tanf = 1.0 / tfi
    z_inv = 1.0 / vp[:, 2]
    fzx, fzy = focal[0] * z_inv, focal[1] * z_inv
    mx = np.clip(vp[:, 0] * z_inv, -tanf[0] * 1.3, tanf[0] * 1.3)
    my = np.clip(vp[:, 1] * z_inv, -tanf[1] * 1.3, tanf[1] * 1.3)
    jq = fzy if cfg.reference_jacobian_quirk else fzx
    Rv = view[:3, :3]
    b0 = Rv[0][None] * fzx[:, None] + Rv[2][None] * (-jq * mx)[:, None]
    b1 = Rv[1][None] * fzy[:, None] + Rv[2][None] * (-fzy * my)[:, None]
    S = np.empty((len(vp), 3, 3), f)
    S[:, 0, 0], S[:, 0, 1], S[:, 0, 2] = c3[:, 0], c3[:, 1], c3[:, 2]
    S[:, 1, 0], S[:, 1, 1], S[:, 1, 2] = c3[:, 1], c3[:, 3], c3[:, 4]
    S[:, 2, 0], S[:, 2, 1], S[:, 2, 2] = c3[:, 2], c3[:, 4], c3[:, 5]
    s0 = np.einsum("nij,nj->ni", S, b0)
    ca = np.einsum("ni,ni->n", b0, s0) + f(0.3)
    cb = np.einsum("ni,ni->n", b1, s0)
    cc = np.einsum("ni,ni->n", b1, np.einsum("nij,nj->ni", S, b1)) + f(0.3)
    det = ca * cc - cb * cb
    mid = 0.5 * (ca + cc)
    disc = np.sqrt(np.maximum(0.1, mid * mid - det))
    lam1, lam2 = mid + disc, mid - disc

    ndc = clip / np.where(clip_w == 0, 1, clip_w)[:, None]
    shift = np.stack([1 - tf, 0.75 * (1 - tf)], -1)
    ipos = ((ndc[:, :2] + 1) * 0.5 - shift) * (dims - 1)
    radius = np.maximum(sop, 0) ** 0.2 * 2.5 * np.sqrt(np.maximum(lam1, lam2))
    lo = np.clip((ipos - radius[:, None]) / ts, 0, [gx, gy]).astype(np.int64)
    hi = np.clip(np.ceil((ipos + radius[:, None]) / ts), 0, [gx, gy]).astype(np.int64)
    nt = np.maximum(hi[:, 0] - lo[:, 0], 0) * np.maximum(hi[:, 1] - lo[:, 1], 0)
    valid = inside & (det != 0) & (lam1 >= 0) & (lam2 >= 0) & (nt > 0)

    z3 = ndc[:, 2] ** 3
    # 0xFFFE clamp matches ops/projection.py (0xFFFF = padding sentinel)
    depth16 = np.minimum(
        np.clip(z3 * 0xFFFF, -2**31, 2**31 - 1).astype(np.int64)
        .astype(np.uint32) & 0xFFFF, 0xFFFE).astype(np.uint32)
    vd = splat_pos - np.asarray(camera_pos, f)
    vd = vd / np.maximum(np.linalg.norm(vd, axis=-1, keepdims=True), 1e-12)
    rgb = _eval_sh_np(vd, sh, cfg.sh_degree)
    safe_det = np.where(det == 0, 1, det)
    conic = np.stack([cc, -cb, ca], -1) / safe_det[:, None]

    # --- pair emission + stable sort (deterministic splat-id order) ---
    vidx = np.nonzero(valid)[0]
    keys, vals = [], []
    for i in vidx:
        tiles_y = np.arange(lo[i, 1], hi[i, 1])
        tiles_x = np.arange(lo[i, 0], hi[i, 0])
        tid = (tiles_y[:, None] * gx + tiles_x[None, :]).ravel()
        keys.append((tid.astype(np.uint64) << 16) | np.uint64(depth16[i]))
        vals.append(np.full(len(tid), i, np.int64))
    if keys:
        keys = np.concatenate(keys)
        vals = np.concatenate(vals)
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
    else:
        keys = np.zeros(0, np.uint64)
        vals = np.zeros(0, np.int64)
    num_pairs = len(keys)

    # --- boundaries (gsplat_boundaries.glsl) ---
    T = gx * gy
    tids = (keys >> 16).astype(np.int64)
    tstart = np.searchsorted(tids, np.arange(T), side="left")
    tend = np.searchsorted(tids, np.arange(T), side="right")
    if cfg.reference_boundary_quirk and num_pairs > 0:
        last = tids[-1]
        tend[last] = num_pairs - 1 if (last == T - 1 and num_pairs > 1) else 0
    tend = np.maximum(tend, tstart)

    # --- sequential per-pixel blending (gsplat_render.glsl:50-101) ---
    img = np.zeros((gy * ts, gx * ts, 4), f)
    img[:, :, 3] = 1.0
    tile_t0 = np.ones(T, f)
    blue, red = np.array([0, 0, 1], f), np.array([1, 0.2, 0.2], f)
    for t_id in range(T):
        s, e = tstart[t_id], tend[t_id]
        nsp = max(0, e - s)
        ty, tx = divmod(t_id, gx)
        base_x, base_y = tx * ts, ty * ts
        tvals = vals[s:e]
        tile_rgb = np.zeros((ts, ts, 3), f)
        tile_t = np.ones((ts, ts), f)
        for sid in tvals:
            dx = ipos[sid, 0] - (base_x + np.arange(ts, dtype=f))[None, :]
            dy = ipos[sid, 1] - (base_y + np.arange(ts, dtype=f))[:, None]
            power = (-0.5 * (conic[sid, 0] * dx * dx + conic[sid, 2] * dy * dy)
                     - conic[sid, 1] * dx * dy)
            alpha = sop[sid] * np.exp(power)
            live = tile_t > 1.0 / MIN_FACTOR
            tile_rgb += np.where(live[..., None], (rgb[sid] * alpha[..., None]) * tile_t[..., None], 0)
            tile_t = np.where(live, tile_t * (1 - alpha), tile_t)
        hm = (blue + (red - blue) * (nsp * 5e-4)) * ((1 - tile_t)[..., None] * heatmap_factor)
        img[base_y:base_y + ts, base_x:base_x + ts, :3] = tile_rgb + hm
        tile_t0[t_id] = tile_t[0, 0]

    info = dict(num_pairs=num_pairs, tile_start=tstart, tile_end=tend,
                sorted_values=vals, tile_t0=tile_t0, splat_pos=splat_pos,
                image_pos=ipos, conic=conic, color=np.concatenate([rgb, sop[:, None]], -1),
                valid=valid, depth16=depth16, rect=np.concatenate([lo, hi], -1))
    return img[:h, :w], info
