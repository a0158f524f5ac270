"""The plain reference of one exact frame, in plain PyTorch.

It states what the renderer's exact quality computes for a camera, from
the splat arrays and the configuration's numbers alone, written
straight from the formulas of the Godot 3D Gaussian Splatting reference
shaders that the renderer ports:

1. projection: frustum cull with the 1.2 w margin, the load fade-in, the
   EWA covariance with its +0.3 dilation and eigenvalue floor, the
   -focal.y * mean.x Jacobian quirk, SH colour, the opacity-biased radius
   ``opacity^0.2 * 2.5 * sqrt(lambda_max)``, the tile rect and the depth
   key ``ndc.z^3 * 0xFFFF`` clamped to 0xFFFE;
2. pairs: each valid splat emits its first ``max_tiles_per_splat`` tiles
   in row-major order; a wider splat that one of the tiers (or the giant
   group) takes, the first ``cap`` eligible in splat order, emits every
   tile; the rest is dropped (``dropped``). Pairs are emitted base group
   first, then each tier, then the giants, each in splat order, at most
   ``sort_buffer_factor * P`` of them, and sorted stably by
   ``tile << 16 | depth``;
3. boundaries: each tile's run of the sorted pairs, with (where the
   configuration keeps it) the reference's quirk: the last run of the
   buffer collapses to empty unless it is the grid's last tile, whose end
   becomes ``pairs - 1``;
4. composite: each pixel walks its tile's list front to back, takes slot j
   while the transmittance before it exceeds 1/255, adds
   ``rgb * alpha * T`` with ``alpha = opacity * exp(power)`` (no clamp),
   and the image is the sum. Every slot of a tile's list is composited (the
   renderer grows its tile capacity to the densest tile before it returns
   a frame).

The heatmap is off in every frame the benchmark renders, so it is left out.
``dtype`` is the precision every float is computed in: float32 is the
reference; a lower one is the control that the comparison must fail.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
         1.0925484305920792, 0.5462742152960396)
SH_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
         0.3731763325901154, 0.4570457994644658, 1.445305721320277,
         0.5900435899266435)
MIN_T = 1.0 / 255.0       # the transmittance a pixel stops below
DEPTH_MAX = 0xFFFE        # 0xFFFF marks an invalid key


def sh_color(d, sh, degree: int):
    """(N, 3) unit view directions, (N, 16, 3) coefficients -> (N, 3)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = 0.5 + sh[:, 0] * SH_C0
    if degree >= 1:
        c = c - sh[:, 1] * (SH_C1 * y) + sh[:, 2] * (SH_C1 * z) \
            - sh[:, 3] * (SH_C1 * x)
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + sh[:, 4] * (SH_C2[0] * xy) - sh[:, 5] * (SH_C2[1] * yz)
             + sh[:, 6] * (SH_C2[2] * (2.0 * zz - xx - yy))
             - sh[:, 7] * (SH_C2[3] * xz) + sh[:, 8] * (SH_C2[4] * (xx - yy)))
    if degree >= 3:
        c = (c - sh[:, 9] * (SH_C3[0] * y * (3.0 * xx - yy))
             + sh[:, 10] * (SH_C3[1] * x * yz)
             - sh[:, 11] * (SH_C3[2] * y * (4.0 * zz - xx - yy))
             + sh[:, 12] * (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy))
             - sh[:, 13] * (SH_C3[4] * x * (4.0 * zz - xx - yy))
             + sh[:, 14] * (SH_C3[5] * z * (xx - yy))
             - sh[:, 15] * (SH_C3[6] * x * (xx - 3.0 * yy)))
    return torch.clamp(c, min=0.0)


def project(scene: dict, view, proj, campos, time: float, spec: dict,
            dtype=torch.float32) -> dict:
    """Per-splat screen state of every slot of the padded arrays."""
    dev = scene["means"].device

    def f(x):
        return torch.as_tensor(x, device=dev).to(dtype)

    V, Q, cp = f(view), f(proj), f(campos)
    w, h = spec["width"], spec["height"]
    means, cov = f(scene["means"]), f(scene["cov3d"])
    sx, sy, sz = means[:, 0], means[:, 1], means[:, 2]   # model scale 1
    vx = V[0, 0] * sx + V[0, 1] * sy + V[0, 2] * sz + V[0, 3]
    vy = V[1, 0] * sx + V[1, 1] * sy + V[1, 2] * sz + V[1, 3]
    vz = V[2, 0] * sx + V[2, 1] * sy + V[2, 2] * sz + V[2, 3]
    cx = Q[0, 0] * vx + Q[0, 1] * vy + Q[0, 2] * vz + Q[0, 3]
    cy = Q[1, 0] * vx + Q[1, 1] * vy + Q[1, 2] * vz + Q[1, 3]
    cz = Q[2, 0] * vx + Q[2, 1] * vy + Q[2, 2] * vz + Q[2, 3]
    cw = Q[3, 0] * vx + Q[3, 1] * vy + Q[3, 2] * vz + Q[3, 3]
    m = cw * 1.2
    inside = ((cx >= -m) & (cx <= m) & (cy >= -m) & (cy <= m) & (cz >= 0.0)
              & (cz <= cw))

    def ease(x):
        a = 1.0 - x
        return 1.0 - a * a * a

    st = f(time) - f(scene["upload_time"])
    tf = ease(torch.clamp(st, 0.0, 1.0))
    tfl = ease(torch.clamp(st - 0.35, 0.0, 1.0))
    opac = f(scene["opacity"]) * tfl * tfl
    s2 = (2.0 - tfl) * (2.0 - tfl)
    xx, xy, xz = cov[:, 0] * s2, cov[:, 1] * s2, cov[:, 2] * s2
    yy, yz, zz = cov[:, 3] * s2, cov[:, 4] * s2, cov[:, 5] * s2
    fx, fy = w * 0.5 * Q[0, 0], h * 0.5 * Q[1, 1]
    limx, limy = (1.0 / Q[0, 0]) * 1.3, (1.0 / Q[1, 1]) * 1.3
    zi = 1.0 / vz
    fzx, fzy = fx * zi, fy * zi
    mx = torch.clamp(vx * zi, -limx, limx)
    my = torch.clamp(vy * zi, -limy, limy)
    njm = -(fzy if spec["reference_jacobian_quirk"] else fzx) * mx
    nfm = -fzy * my
    b0 = (V[0, 0] * fzx + V[2, 0] * njm, V[0, 1] * fzx + V[2, 1] * njm,
          V[0, 2] * fzx + V[2, 2] * njm)
    b1 = (V[1, 0] * fzy + V[2, 0] * nfm, V[1, 1] * fzy + V[2, 1] * nfm,
          V[1, 2] * fzy + V[2, 2] * nfm)
    s0 = (xx * b0[0] + xy * b0[1] + xz * b0[2],
          xy * b0[0] + yy * b0[1] + yz * b0[2],
          xz * b0[0] + yz * b0[1] + zz * b0[2])
    s1 = (xx * b1[0] + xy * b1[1] + xz * b1[2],
          xy * b1[0] + yy * b1[1] + yz * b1[2],
          xz * b1[0] + yz * b1[1] + zz * b1[2])
    ca = b0[0] * s0[0] + b0[1] * s0[1] + b0[2] * s0[2] + 0.3
    cb = b1[0] * s0[0] + b1[1] * s0[1] + b1[2] * s0[2]
    cc = b1[0] * s1[0] + b1[1] * s1[1] + b1[2] * s1[2] + 0.3
    det = ca * cc - cb * cb
    mid = 0.5 * (ca + cc)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1, lam2 = mid + disc, mid - disc
    sw = torch.where(cw == 0.0, torch.ones_like(cw), cw)
    nz = cz / sw
    ix = ((cx / sw + 1.0) * 0.5 - (1.0 - tf)) * (w - 1.0)
    iy = ((cy / sw + 1.0) * 0.5 - 0.75 * (1.0 - tf)) * (h - 1.0)
    radius = (torch.pow(torch.clamp(opac, min=0.0), 0.2) * 2.5
              * torch.sqrt(torch.maximum(lam1, lam2)))
    z3 = nz * nz * nz
    depth = torch.clamp((z3 * 65535.0).to(torch.int64) & 0xFFFF,
                        max=DEPTH_MAX)
    dx, dy, dz = sx - cp[0], sy - cp[1], sz - cp[2]
    nrm = torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    d = torch.stack([dx / nrm, dy / nrm, dz / nrm], dim=-1)
    rgb = sh_color(d, f(scene["sh"]), spec["sh_degree"])
    sd = torch.where(det == 0.0, torch.ones_like(det), det)
    return {
        "ok": inside & (det != 0.0) & (lam1 >= 0.0) & (lam2 >= 0.0),
        "ix": ix, "iy": iy, "radius": radius, "depth": depth,
        "conic": torch.stack([cc / sd, -cb / sd, ca / sd], dim=-1),
        "rgb": rgb, "opacity": opac}


def tile_rects(prj: dict, tile_size: int, width: int, height: int):
    """Each splat's tile rect [x0, y0, x1, y1) and its tile count (0 unless
    valid) on a grid of ``tile_size`` tiles."""
    gx, gy = -(-width // tile_size), -(-height // tile_size)
    ix, iy, r, ts = prj["ix"], prj["iy"], prj["radius"], float(tile_size)
    x0 = torch.clamp((ix - r) / ts, 0.0, gx).to(torch.int64)
    y0 = torch.clamp((iy - r) / ts, 0.0, gy).to(torch.int64)
    x1 = torch.clamp(torch.ceil((ix + r) / ts), 0.0, gx).to(torch.int64)
    y1 = torch.clamp(torch.ceil((iy + r) / ts), 0.0, gy).to(torch.int64)
    nt = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    nt = torch.where(prj["ok"] & (nt > 0), nt, 0)
    return torch.stack([x0, y0, x1, y1], dim=-1), nt


def emit(nt, spec: dict):
    """(each splat's emitted tile count, its group: 0 base, 1.. the tiers
    and the giants), in the configuration's caps."""
    P = nt.shape[0]
    base = spec["max_tiles_per_splat"]
    ladder = [(w, c) for w, c in spec["exact_tiers"] if w > base]
    group = torch.zeros(P, dtype=torch.int64, device=nt.device)
    bands, lo = [], base
    for w, cap in ladder:
        bands.append((lo, w, cap))
        lo = w
    if spec["giant_splat_capacity"]:
        bands.append((lo, None, spec["giant_splat_capacity"]))
    for g, (lo_w, hi_w, cap) in enumerate(bands, start=1):
        elig = nt > lo_w if hi_w is None else (nt > lo_w) & (nt <= hi_w)
        rank = torch.cumsum(elig.to(torch.int64), 0) - 1
        group = torch.where(elig & (rank < cap), g, group)
    count = torch.where(group > 0, nt, torch.clamp(nt, max=base))
    return count, group


def sorted_pairs(rect, nt, depth, spec: dict):
    """(tile, splat) of the sorted pairs, the emitted total and the pairs
    the caps dropped."""
    dev = nt.device
    P = nt.shape[0]
    gx = -(-spec["width"] // spec["tile_size"])
    count, group = emit(nt, spec)
    order = torch.argsort(group * P + torch.arange(P, device=dev))
    reps = count[order]
    total = int(reps.sum())
    dropped = int(nt.sum()) - total
    k_max = spec["sort_buffer_factor"] * P
    splat = torch.repeat_interleave(order, reps)[:k_max]
    first = torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps)
    t = (torch.arange(total, device=dev) - first)[:k_max]
    r = rect[splat]
    wd = torch.clamp(r[:, 2] - r[:, 0], min=1)
    tile = (r[:, 1] + t // wd) * gx + r[:, 0] + t % wd
    key = (tile << 16) | depth[splat]
    perm = torch.sort(key, stable=True).indices
    return tile[perm], splat[perm], total, dropped


def boundaries(tile, total: int, num_tiles: int, quirk: bool):
    """Each tile's [start, end) over the sorted pairs, with the reference's
    quirk where ``quirk``."""
    counts = torch.bincount(tile, minlength=num_tiles)
    end = torch.cumsum(counts, 0)
    start = end - counts
    if quirk and total > 0:
        last = int(tile[min(total, tile.shape[0]) - 1])
        if last == num_tiles - 1 and total > 1:
            end[last] = total - 1
        else:
            end[last] = 0
    return start, torch.maximum(end, start)


def composite(prj: dict, splat, start, end, spec: dict, dtype,
              batch: int = 256, chunk: int = 512) -> dict:
    """The front-to-back composite of every tile. Returns the (H, W, 3)
    image, the (pixel, slot) evaluations taken and the pair records a
    tile's walk needs (up to its last pixel's last slot)."""
    dev = splat.device
    ts, w, h = spec["tile_size"], spec["width"], spec["height"]
    gx, gy = -(-w // ts), -(-h // ts)
    T, npx = gx * gy, ts * ts
    pos = torch.stack([prj["ix"], prj["iy"]], dim=-1)
    con, rgb, op = prj["conic"], prj["rgb"], prj["opacity"]
    loc = torch.arange(ts, device=dev)
    lx, ly = loc.repeat(ts), loc.repeat_interleave(ts)
    tiles = torch.arange(T, device=dev)
    px_all = ((tiles % gx) * ts)[:, None] + lx[None]
    py_all = ((tiles // gx) * ts)[:, None] + ly[None]
    image = torch.zeros((T, npx, 3), dtype=dtype, device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    reads = torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(chunk, device=dev)
    K = max(splat.shape[0], 1)
    for b0 in range(0, T, batch):
        s, e = start[b0:b0 + batch], end[b0:b0 + batch]
        B = s.shape[0]
        px = px_all[b0:b0 + B].to(dtype)[:, None, :]
        py = py_all[b0:b0 + B].to(dtype)[:, None, :]
        q = torch.ones((B, npx), dtype=dtype, device=dev)
        acc = torch.zeros((B, npx, 3), dtype=dtype, device=dev)
        taken = torch.zeros((B, npx), dtype=torch.int64, device=dev)
        k = 0
        while bool(((s + k < e) & (q > MIN_T).any(1)).any()):
            slots = s[:, None] + k + slot[None]
            live = slots < e[:, None]
            ids = splat[torch.clamp(slots, max=K - 1)] if splat.numel() \
                else torch.zeros_like(slots)
            dx = pos[ids, 0][:, :, None] - px
            dy = pos[ids, 1][:, :, None] - py
            c = con[ids]
            power = (-0.5 * (c[:, :, 0:1] * dx * dx + c[:, :, 2:3] * dy * dy)
                     - c[:, :, 1:2] * dx * dy)
            alpha = op[ids][:, :, None] * torch.exp(power)
            alpha = torch.where(live[:, :, None], alpha, 0.0)
            incl = q[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([q[:, None, :], incl[:, :-1]], dim=1)
            go = excl > MIN_T
            acc += torch.einsum("bcp,bck->bpk", alpha * excl * go,
                                rgb[ids])
            n = go.sum(dim=1)
            q = torch.where(n > 0, incl.gather(
                1, torch.clamp(n - 1, min=0)[:, None, :])[:, 0], q)
            taken += (go & live[:, :, None]).sum(dim=1)
            k += chunk
        image[b0:b0 + B] = acc
        evals += taken.sum()
        reads += taken.amax(dim=1).sum()
    img = image.reshape(gy, gx, ts, ts, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(gy * ts, gx * ts, 3)[:h, :w]
    return {"image": img.float(), "evaluations": int(evals),
            "pair_reads": int(reads)}


def render(scene: dict, view, proj, campos, time: float, spec: dict,
           dtype=torch.float32, fast_tile_size: int | None = None) -> dict:
    """One exact frame of ``scene``: the image and the frame's counts.
    ``fast_tile_size``, where given, adds ``fast_pairs``: the (splat, tile)
    pairs of the valid splats on a grid of that tile size."""
    prj = project(scene, view, proj, campos, time, spec, dtype)
    rect, nt = tile_rects(prj, spec["tile_size"], spec["width"],
                          spec["height"])
    T = -(-spec["width"] // spec["tile_size"]) * \
        -(-spec["height"] // spec["tile_size"])
    tile, splat, total, dropped = sorted_pairs(rect, nt, prj["depth"], spec)
    start, end = boundaries(tile, total, T,
                            spec["reference_boundary_quirk"])
    out = composite(prj, splat, start, end, spec, dtype)
    out.update(rendered_splats=total, pair_overflow_dropped=dropped,
               max_tile_count=int((end - start).max()),
               live_pairs=int(splat.shape[0]),
               splats=int(scene["means"].shape[0]))
    if fast_tile_size:
        out["fast_pairs"] = int(tile_rects(prj, fast_tile_size,
                                           spec["width"],
                                           spec["height"])[1].sum())
    return out
