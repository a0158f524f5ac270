"""Batch-exact tile compositing with resident big lanes (the v3 render).

Counterpart of ``godotgaussiansplatting_tpu/ops/render_pallas3.py``, for
both payloads: the (B, 8, 128) int32 words (``cfg.words_payload``) and the
cooked (B, 16, 128) f32 rows. Only the lane decode differs between them
(``_decode_words``, ``_decode_cooked``). Per tile:

  * the tile's chain blocks are composited front to back in batches of U
    blocks (U*128 lanes), up to ``tile_nblocks`` and ``max_batches``;
  * inside a batch the order is exact by a packed rank
    (depth16 << 16 | idx >> 7): a lane's transmittance exponent sums
    log1p(-alpha) over the lanes of strictly smaller rank (equal ranks do not
    occlude each other);
  * across consecutive batches whose block depth ranges overlap, lag-1
    corrections make the two batches mutually exact;
  * the tile's big lanes stay resident, with log-alpha maps from
    ``prepass_big_la`` (the CUDA kernel evaluates them itself). When a big
    lane falls inside a batch's depth range (the straddle gate, read from
    ``TileBigs.big_prefix``) chain and big lanes exchange exact masses by
    rank; otherwise whole-batch masses are exchanged;
  * the tile stops after a batch once every pixel has
    tcar + (big mass in front) <= ln(1/255);
  * present: t_final = exp(tcar + big mass), the heatmap mix and the
    diagnostics channels.

The kernel output is (TG, 8, NPX) f32, channel-major per tile:
[r, g, b, 1, t_final, blocks processed, nb, nbig].

``render_tiles_v3`` launches the CUDA kernel (csrc/render_v3.cu, one entry
point per payload) for CUDA tensors; the kernel evaluates the big lanes'
log-alphas itself, so that path builds no ``prepass_big_la`` maps. CPU
tensors go to ``render_tiles_v3_reference`` (plain torch, vectorised over
tiles, one loop step per batch), which reads the maps. Both compute in
f32 (the kernel's exp and log on the special function unit). The JAX
kernel also rounds alpha, colours and emit weights to bf16 and splits the
power matmul into bf16 halves; neither is reproduced here.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import kernels
from ..config import RasterizerConfig
from .bigbin import GROUP
from .blocks2 import (BLOCK_SIZE, GATE_OFF, PAYLOAD_WIDTH, _unpack_bf16_pair,
                      _unpack_f16, _unpack_rgb9e5, u32)

OUT_CH = 8         # r, g, b, 1, t_final, blocks processed, nb, nbig
BATCH_LANES = 512  # lanes per batch at tile 16 (see default_batch_u)
LOG_MIN_ALPHA = -5.54126354515843  # ln(1/255)
ALPHA_MAX = 0.99994
# Pixel x lane elements per chunk of tiles of the plain composite: 512 MB
# per f32 (tiles, NPX, U*128) temporary (one chunk at chip_smoke's 512x512).
REFERENCE_CHUNK = 2 ** 27


def default_batch_u(tile_size: int) -> int:
    """Blocks per batch: 4 at tile 16, scaled down with the pixel count."""
    return max(1, (BATCH_LANES // BLOCK_SIZE) // max(1, (tile_size // 16) ** 2))


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls without TF32 (the reference's einsums and mask
    products must keep full f32 on the card)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pack_tile_rows_v3(tile_blocks, tile_nblocks, tile_nbig, tile_minmax,
                      tile_candidates, heatmap_factor, cfg,
                      pixel_offset_y=0, tile_big_prefix=None):
    """Tile lists -> (TG, GROUP*8, 128) i32 rows. Per tile: row 0 = [nb,
    cand, heatmap as 16.16 fixed point, y offset, nbig], rows 1-2 = block
    ids, rows 3-4 = packed depth ranges, row 5 = the big depth-bucket
    prefix (absent: 1..128, which makes the straddle gate always fire),
    rows 6-7 spare."""
    gx, gy = cfg.tile_dims
    T, C2 = tile_blocks.shape
    if T != gx * gy or C2 > 256:
        raise ValueError("tile lists do not match the config's tile grid")
    dev = tile_blocks.device
    i32 = torch.int32
    hm_bits = torch.round(torch.as_tensor(
        heatmap_factor, dtype=torch.float32, device=dev) * 65536.0).to(i32)
    hdr = torch.zeros((T, 128), dtype=i32, device=dev)
    hdr[:, 0] = tile_nblocks.to(i32)
    hdr[:, 1] = tile_candidates.to(i32)
    hdr[:, 2] = hm_bits
    hdr[:, 3].fill_(int(pixel_offset_y))   # a fill, not a host copy

    def sect(a):
        out = torch.zeros((T, 256), dtype=i32, device=dev)
        out[:, :C2] = a.to(i32)
        return out

    rows = torch.cat([hdr, sect(tile_blocks), sect(tile_minmax),
                      torch.zeros((T, 3 * 128), dtype=i32, device=dev)],
                     dim=1).reshape(T, 8, 128)
    rows[:, 0, 4] = tile_nbig.to(i32)
    if tile_big_prefix is None:
        tile_big_prefix = torch.arange(1, 129, dtype=i32, device=dev)[
            None].expand(T, 128)
    rows[:, 5, :] = tile_big_prefix.to(i32)
    return rows


def _tile_origins(TG: int, cfg: RasterizerConfig, pixel_offset_y, device,
                  t0: int = 0):
    """Pixel origins of tiles t0 .. t0 + TG - 1 of the row-major order."""
    gx, _ = cfg.tile_dims
    t = torch.arange(t0, t0 + TG, dtype=torch.int64, device=device)
    ox = ((t % gx) * cfg.tile_size).float()
    oy = ((t // gx) * cfg.tile_size + int(pixel_offset_y)).float()
    return ox, oy


def _pixel_coords(tile_size: int, device):
    p = torch.arange(tile_size * tile_size, device=device)
    return (p % tile_size).float(), (p // tile_size).float()


def prepass_big_la(bigpay, cfg, lowp: bool = True, pixel_offset_y=0):
    """(TG, PW, OBIG) big-lane payloads -> (TG, NPX, OBIG) f32
    log1p(-alpha) maps: the features re-centred to the tile origin, the
    coverage gate and one f32 einsum over the 8 pixel features (TF32 off).
    The result is a transposed view of a (TG, OBIG, NPX) buffer, the layout
    the render kernel reads coalesced. ``lowp`` is accepted for signature
    parity (the JAX package stores bf16 under it); this is always f32. The
    exp and log1p run in place on the einsum's output to bound the peak
    memory."""
    del lowp
    TG = bigpay.shape[0]
    ts = float(cfg.tile_size)
    ox, oy = _tile_origins(TG, cfg, pixel_offset_y, bigpay.device)
    ox, oy = ox[:, None], oy[:, None]
    pay = bigpay.float()
    dx = ox - pay[:, 14]
    dy = oy - pay[:, 15]
    f0u = (pay[:, 0] + dx * pay[:, 1] + dy * pay[:, 2]
           + dx * dx * pay[:, 3] + dy * dy * pay[:, 4] + dx * dy * pay[:, 5])
    f1u = pay[:, 1] + 2.0 * dx * pay[:, 3] + dy * pay[:, 5]
    f2u = pay[:, 2] + 2.0 * dy * pay[:, 4] + dx * pay[:, 5]
    rxw, ryw = _unpack_bf16_pair(pay[:, 11].view(torch.int32))
    ixr, iyr = pay[:, 9], pay[:, 10]
    covered = ((ixr - rxw < ox + GROUP * ts) & (ixr + rxw > ox)
               & (iyr - ryw < oy + ts) & (iyr + ryw > oy))
    gate = torch.where(covered, 0.0, GATE_OFF)
    F = torch.stack([f0u, f1u, f2u, pay[:, 3], pay[:, 4], pay[:, 5],
                     gate, torch.zeros_like(gate)], dim=1)     # (TG, 8, OB)
    xs, ys = _pixel_coords(cfg.tile_size, bigpay.device)
    ones = torch.ones_like(xs)
    pixf = torch.stack([ones, xs, ys, xs * xs, ys * ys, xs * ys, ones,
                        torch.zeros_like(xs)], dim=1)          # (NPX, 8)
    with _full_f32_matmul():
        P = torch.einsum("pf,tfo->top", pixf, F).contiguous()
    P.exp_().clamp_(max=ALPHA_MAX).neg_().log1p_()
    return P.transpose(1, 2)


def _decode_words(pay, live, ox, oy, ts):
    """(TG, 8, W) int32 word lanes -> per-lane features at the tile origin.

    Returns (F (6 tensors f0u..f5, each (TG, W)), rgb (TG, 3, W), rank
    (TG, W) int64, active (TG, W) bool). ix/iy of invalid lanes are masked
    before use, so a culled lane's non-finite position cannot leak NaN."""
    key = u32(pay[:, 0])
    val = key != 0xFFFFFFFF
    zero = torch.zeros(pay[:, 0].shape, dtype=torch.float32,
                       device=pay.device)
    ca, cb = _unpack_f16(pay[:, 3])
    cc, op = _unpack_f16(pay[:, 4])
    ca = torch.where(val, ca, zero)
    cb = torch.where(val, cb, zero)
    cc = torch.where(val, cc, zero)
    op = torch.where(val, op, zero + 1e-6)
    ln_op = torch.clamp(torch.log(torch.clamp(op, min=1e-37)), max=-1e-3)
    ixl = torch.where(val, pay[:, 1].view(torch.float32) - ox[:, None], zero)
    iyl = torch.where(val, pay[:, 2].view(torch.float32) - oy[:, None], zero)
    f3 = -0.5 * ca
    f4 = -0.5 * cc
    f5 = -cb
    f1u = ca * ixl + cb * iyl
    f2u = cc * iyl + cb * ixl
    f0u = (-0.5 * (ca * ixl * ixl + cc * iyl * iyl) - cb * ixl * iyl) + ln_op
    rxw, ryw = _unpack_bf16_pair(pay[:, 7])
    covered = ((ixl - rxw < ts) & (ixl + rxw > 0.0)
               & (iyl - ryw < ts) & (iyl + ryw > 0.0))
    active = covered & live & val
    r, g, b = _unpack_rgb9e5(torch.where(val, pay[:, 5], 0))
    rank = ((key & 0xFFFF) << 16) | ((pay[:, 6].to(torch.int64) >> 7) & 0xFFFF)
    return (f0u, f1u, f2u, f3, f4, f5), torch.stack([r, g, b], 1), rank, active


def _decode_cooked(pay, live, ox, oy, ts):
    """(TG, 16, W) f32 cooked lanes -> the same as ``_decode_words``. The
    features about the block centre (rows 14/15) are re-centred to the tile
    origin (render_pallas3.py:380-404, formula for formula); the coverage
    gate reads absolute ix/iy (rows 9/10) and the bf16 pair in row 11;
    colour is rows 6-8 and the rank row 12 with its sign bit flipped.
    Invalid lanes carry ix = iy = -1e6 and fail the gate."""
    ox, oy = ox[:, None], oy[:, None]
    f0, f1, f2, f3, f4, f5 = (pay[:, r] for r in range(6))
    dx = ox - pay[:, 14]
    dy = oy - pay[:, 15]
    f0u = f0 + dx * f1 + dy * f2 + dx * dx * f3 + dy * dy * f4 + dx * dy * f5
    f1u = f1 + 2.0 * dx * f3 + dy * f5
    f2u = f2 + 2.0 * dy * f4 + dx * f5
    rxw, ryw = _unpack_bf16_pair(pay[:, 11].view(torch.int32))
    ixr, iyr = pay[:, 9], pay[:, 10]
    covered = ((ixr - rxw < ox + ts) & (ixr + rxw > ox)
               & (iyr - ryw < oy + ts) & (iyr + ryw > oy))
    rank = u32(pay[:, 12].view(torch.int32)) ^ 0x80000000
    return ((f0u, f1u, f2u, f3, f4, f5), pay[:, 6:9], rank,
            covered & live)


def _alpha(F, active, xs, ys):
    """(TG, NPX, W) alpha and log1p(-alpha) of lanes at the tile pixels."""
    f0u, f1u, f2u, f3, f4, f5 = (f[:, None, :] for f in F)
    x = xs[None, :, None]
    y = ys[None, :, None]
    power = (f0u + x * f1u + y * f2u + (x * x) * f3 + (y * y) * f4
             + (x * y) * f5)
    alpha = torch.where(active[:, None, :],
                        torch.clamp(torch.exp(power), max=ALPHA_MAX), 0.0)
    return alpha, torch.log1p(-alpha)


def _front(wa, wb):
    """(TG, A, B) f32 mask [wa_i < wb_j]."""
    return (wa[:, :, None] < wb[:, None, :]).float()


def render_tiles_v3_reference(rows, payload, bigpay, bigla, cfg, U: int,
                              max_batches: int, early_exit: bool = True):
    """Plain-torch v3 composite (see module docstring), vectorised over the
    tiles, with the kernel's batch boundaries, gates and early exit. It forms
    the rank-order matrices literally. Tiles are independent, so they are
    composited in chunks of at most REFERENCE_CHUNK pixel x lane elements,
    which bounds the (tiles, NPX, U*128) temporaries on a full frame.
    Returns (TG, OUT_CH, NPX) f32."""
    TG = rows.shape[0]
    step = max(1, REFERENCE_CHUNK // (cfg.tile_size ** 2 * U * BLOCK_SIZE))
    with _full_f32_matmul():
        if step >= TG:
            return _render_reference(rows, payload, bigpay, bigla, cfg, U,
                                     max_batches, early_exit)
        return torch.cat([_render_reference(
            rows[a:a + step], payload, bigpay[a:a + step], bigla[a:a + step],
            cfg, U, max_batches, early_exit, t0=a)
            for a in range(0, TG, step)])


def _render_reference(rows, payload, bigpay, bigla, cfg, U, max_batches,
                      early_exit, t0=0):
    dev = rows.device
    TG = rows.shape[0]
    ts = float(cfg.tile_size)
    S = BLOCK_SIZE
    US = U * S
    xs, ys = _pixel_coords(cfg.tile_size, dev)
    NPX = xs.shape[0]
    hdr = rows[:, 0, :].to(torch.int64)
    nb, cand, nbig = hdr[:, 0], hdr[:, 1], hdr[:, 4]
    hm_f = hdr[:, 2].float() * (1.0 / 65536.0)
    ox, oy = _tile_origins(TG, cfg, 0, dev, t0)
    oy = oy + hdr[:, 3].float()
    ids = rows[:, 1:3, :].reshape(TG, 256).to(torch.int64) & 0x7FFFFF
    mm = u32(rows[:, 3:5, :].reshape(TG, 256))
    prefix = rows[:, 5, :].to(torch.int64)
    has_big = nbig > 0
    R = payload.shape[1]
    decode = _decode_cooked if payload.dtype == torch.float32 else _decode_words

    # resident big lanes
    lab = bigla.float()                                        # (TG, NPX, OB)
    OB = lab.shape[2]
    d_big = bigpay[:, 12, :]
    i_row = bigpay[:, 13, :].view(torch.int32).to(torch.int64)
    w_big = ((torch.clamp(d_big, max=65535.0).to(torch.int64) << 16)
             | ((i_row >> 7) & 0xFFFF))
    rgb_big = bigpay[:, 6:9, :]                                # (TG, 3, OB)
    lt = torch.triu(torch.ones((OB, OB), device=dev), diagonal=1)
    big_z = lab @ lt                                           # (TG, NPX, OB)
    big_tot = lab.sum(dim=2)

    acc = torch.zeros((TG, NPX, 3), device=dev)
    tcar = torch.zeros((TG, NPX), device=dev)
    go = torch.ones(TG, dtype=torch.bool, device=dev)
    k_end = torch.zeros(TG, dtype=torch.int64, device=dev)
    pend = None
    pend_ok = torch.zeros(TG, dtype=torch.bool, device=dev)
    prev_bmin = torch.zeros(TG, dtype=torch.int64, device=dev)
    prev_bmax = torch.zeros(TG, dtype=torch.int64, device=dev)

    def emit(p, mask):
        w = torch.exp(p["z"] + p["c"][:, :, None]) * p["al"]
        return acc + torch.where(mask[:, None, None],
                                 torch.einsum("tpl,tcl->tpc", w, p["rgb"]),
                                 0.0)

    for k in range(max_batches):
        act = go & (k * U < nb)
        if not bool(act.any()):
            break
        pos = k * U + torch.arange(U, device=dev)
        live_blk = pos[None, :] < nb[:, None]                  # (TG, U)
        posc = torch.clamp(pos, max=255)
        bid = torch.where(live_blk, ids[:, posc], 0)
        pay = payload[bid.reshape(-1)].reshape(TG, U, R, S)
        pay = pay.permute(0, 2, 1, 3).reshape(TG, R, US)
        live = live_blk[:, :, None].expand(TG, U, S).reshape(TG, US)
        F, rgb, w, active = decode(pay, live, ox, oy, ts)
        al, la = _alpha(F, active, xs, ys)                     # (TG, NPX, US)
        tot = la.sum(dim=2)
        z = la @ _front(w, w)

        mmk = mm[:, posc]
        bmin = torch.where(live_blk, (mmk >> 16) & 0xFFFF, 0x10000).amin(1)
        bmax = torch.where(live_blk, mmk & 0xFFFF, -1).amax(1)
        b0 = torch.clamp(bmin >> 9, 0, 127)
        b1 = torch.clamp(bmax >> 9, 0, 127)
        n_hi = prefix.gather(1, b1[:, None])[:, 0]
        n_lo = torch.where(b0 > 0, prefix.gather(
            1, torch.clamp(b0 - 1, min=0)[:, None])[:, 0], 0)
        strad = has_big & (bmax >= bmin) & (n_hi != n_lo)
        nonst = has_big & ~strad
        bfm = (lab * (d_big < bmin[:, None].float())[:, None, :]).sum(2)
        c = tcar + torch.where(nonst[:, None], bfm, 0.0)
        s3 = strad[:, None, None]
        z = z + torch.where(s3, lab @ _front(w_big, w), 0.0)
        big_z = big_z + torch.where(s3 & act[:, None, None],
                                    la @ _front(w, w_big), 0.0)
        big_z = big_z + torch.where(
            (nonst & act)[:, None, None],
            tot[:, :, None] * (d_big > bmax[:, None].float())[:, None, :], 0.0)

        if pend is not None:
            ovl = act & pend_ok & (bmin <= prev_bmax) & (bmax >= prev_bmin)
            o3 = ovl[:, None, None]
            pend["z"] = pend["z"] + torch.where(o3, la @ _front(w, pend["w"]),
                                                0.0)
            z = z - torch.where(o3, pend["la"] @ (1.0 - _front(pend["w"], w)),
                                0.0)
            acc = emit(pend, pend_ok)

        tcar = torch.where(act[:, None], tcar + tot, tcar)
        if early_exit:
            bexit = torch.where(has_big[:, None], bfm, 0.0)
            more = (tcar + bexit).amax(dim=1) > LOG_MIN_ALPHA
            go = torch.where(act, more, go)
        k_end = torch.where(act, k + 1, k_end)
        prev_bmin = torch.where(act, bmin, prev_bmin)
        prev_bmax = torch.where(act, bmax, prev_bmax)
        pend = {"z": z, "c": c, "la": la, "al": al, "rgb": rgb, "w": w}
        pend_ok = act
    if pend is not None:
        acc = emit(pend, pend_ok)

    wb = torch.exp(big_z) - torch.exp(big_z + lab)
    acc = acc + torch.where(has_big[:, None, None],
                            torch.einsum("tpo,tco->tpc", wb, rgb_big), 0.0)
    t_final = torch.exp(tcar + torch.where(has_big[:, None], big_tot, 0.0))

    mixf = (cand.float() * 5e-4)[:, None]
    cov = (1.0 - t_final) * hm_f[:, None]
    out = torch.stack([
        acc[:, :, 0] + (1.0 * mixf) * cov,
        acc[:, :, 1] + (0.2 * mixf) * cov,
        acc[:, :, 2] + (1.0 - 0.8 * mixf) * cov,
        torch.ones_like(t_final),
        t_final,
        torch.minimum(k_end * U, nb).float()[:, None].expand(TG, NPX),
        nb.float()[:, None].expand(TG, NPX),
        nbig.float()[:, None].expand(TG, NPX),
    ], dim=1)
    return out


@functools.lru_cache(maxsize=None)
def resident_blocks(library: str, *shape: int) -> int:
    """Thread blocks of a render kernel (``gs_<library>_max_blocks`` for
    this shape) the whole card holds at once: the persistent grid, and the
    number of the kernel's big-lane scratch slices."""
    n = getattr(kernels.library(library), f"gs_{library}_max_blocks")(*shape)
    if n <= 0:
        raise RuntimeError(f"{library} kernel: occupancy query failed ({n})")
    return n


def check_kernel_inputs(what: str, rows, payload, bigpay, cfg, U,
                        words_ok: bool = True) -> bool:
    """The checks the render kernels (v3 and v4) share before a launch.
    Returns whether the payload is the cooked one."""
    TG = rows.shape[0]
    OB = bigpay.shape[2]
    if cfg.tile_size not in (16, 32):
        raise ValueError(f"the {what} kernel supports tile_size 16 and 32")
    if not 1 <= U <= 4:
        raise ValueError(f"the {what} kernel supports U*128 <= 512 lanes")
    if GROUP != 1 or OB > 256:
        raise ValueError(f"the {what} kernel needs GROUP 1 and OBIG <= 256")
    kind = (payload.dtype, payload.shape[1:])
    cooked = kind == (torch.float32, (PAYLOAD_WIDTH, BLOCK_SIZE))
    if not cooked and not (words_ok
                           and kind == (torch.int32, (8, BLOCK_SIZE))):
        words = "the (B, 8, 128) int32 word payload or " if words_ok else ""
        raise ValueError(f"the {what} kernel reads {words}the (B, 16, 128) "
                         "f32 cooked payload")
    if (rows.dtype != torch.int32 or rows.shape != (TG, 8, 128)
            or bigpay.dtype != torch.float32 or bigpay.shape != (TG, 16, OB)):
        raise ValueError(f"{what}: unexpected input shapes/dtypes")
    kernels.require_cuda(what, rows, payload, bigpay)
    if payload.data_ptr() % 16:
        raise ValueError(f"{what}: the chain payload must start on a 16-byte "
                         "boundary (cp.async.bulk fetches its blocks)")
    return cooked


def _render_cuda(rows, payload, bigpay, cfg, U, max_batches, early_exit):
    """The v3 kernel on (TG, 8, 128) tile rows, either chain payload and the
    (TG, 16, OB) big payload -> (TG, OUT_CH, NPX) f32."""
    TG = rows.shape[0]
    NPX = cfg.tile_size * cfg.tile_size
    OB = bigpay.shape[2]
    gx, _ = cfg.tile_dims
    cooked = check_kernel_inputs("render_v3", rows, payload, bigpay, cfg, U)
    entry, counter = (("gs_render_v3_cooked", "render_v3_cooked") if cooked
                      else ("gs_render_v3", "render_v3"))
    lib = kernels.library("render_v3")
    grid = min(TG, resident_blocks("render_v3", cfg.tile_size, U,
                                   int(cooked), OB))
    out = torch.empty((TG, OUT_CH, NPX), dtype=torch.float32,
                      device=rows.device)
    # per resident block, the (pixel, big lane) difference array of the chain
    # mass; the kernel leaves it zero
    dz = torch.zeros((grid, OB, NPX), dtype=torch.float32, device=rows.device)
    err = getattr(lib, entry)(
        rows.data_ptr(), payload.data_ptr(), bigpay.data_ptr(),
        out.data_ptr(), dz.data_ptr(), TG, gx, cfg.tile_size, U, max_batches,
        OB, int(bool(early_exit)), grid,
        ctypes.c_void_p(kernels.stream_ptr(rows.device)))
    kernels.check(err, "render kernel launch")
    kernels.count_launch(counter)
    return out


def tile_rows(bins, tile_bigs, heatmap_factor, cfg, pixel_offset_y=0,
              batch_u: int | None = None):
    """The render kernels' per-tile inputs from the tile bins: (rows, U,
    max_batches)."""
    U = batch_u or cfg.batch_u or default_batch_u(cfg.tile_size)
    max_batches = -(-bins.tile_blocks.shape[1] // U)
    rows = pack_tile_rows_v3(bins.tile_blocks, bins.tile_nblocks,
                             tile_bigs.tile_nbig, bins.tile_minmax,
                             bins.tile_candidates, heatmap_factor, cfg,
                             pixel_offset_y, tile_big_prefix=tile_bigs.big_prefix)
    return rows, U, max_batches


def tile_inputs(bins, tile_bigs, heatmap_factor, cfg, pixel_offset_y=0,
                batch_u: int | None = None):
    """The plain versions' per-tile inputs: (rows, big log-alpha maps, U,
    max_batches)."""
    rows, U, max_batches = tile_rows(bins, tile_bigs, heatmap_factor, cfg,
                                     pixel_offset_y, batch_u)
    bigla = prepass_big_la(tile_bigs.bigpay, cfg, pixel_offset_y=pixel_offset_y)
    return rows, bigla, U, max_batches


def render_tiles_v3(payload, bins, tile_bigs, heatmap_factor, cfg,
                    early_exit: bool = True, lowp: bool = True,
                    pixel_offset_y=0, batch_u: int | None = None):
    """Composite every tile -> (TG, OUT_CH, NPX) f32 (assemble_image_v3
    unpacks it). CUDA tensors go to the CUDA kernel (or raise), CPU tensors
    to ``render_tiles_v3_reference``. ``lowp`` is accepted for signature
    parity; both compute in f32."""
    del lowp
    if payload.device.type == "cpu":
        rows, bigla, U, max_batches = tile_inputs(
            bins, tile_bigs, heatmap_factor, cfg, pixel_offset_y, batch_u)
        return render_tiles_v3_reference(rows, payload, tile_bigs.bigpay,
                                         bigla, cfg, U, max_batches,
                                         early_exit)
    rows, U, max_batches = tile_rows(bins, tile_bigs, heatmap_factor, cfg,
                                     pixel_offset_y, batch_u)
    return _render_cuda(rows, payload, tile_bigs.bigpay, cfg, U, max_batches,
                        early_exit)


def tile_channels_v3(tiles: torch.Tensor, cfg: RasterizerConfig):
    """(TG, OUT_CH, NPX) kernel buffer -> (T, NPX, C) per tile."""
    gx, gy = cfg.tile_dims
    NPX = cfg.tile_size * cfg.tile_size
    C = tiles.shape[1]
    t4 = tiles.reshape(gy, -(-gx // GROUP) * GROUP, C, NPX)
    return t4[:, :gx].reshape(gy * gx, C, NPX).transpose(1, 2)


def assemble_image_v3(tiles: torch.Tensor, cfg: RasterizerConfig):
    """(TG, OUT_CH, NPX) channel-major kernel buffer -> ((4, H, W) planar
    image, (T, NPX) t_final). utils/image.hwc gives the (H, W, 4) view."""
    gx, gy = cfg.tile_dims
    gxp = -(-gx // GROUP) * GROUP
    ts = cfg.tile_size
    w, h = cfg.target_size
    t_final = tiles[:, 4].reshape(gy, gxp, ts * ts)[:, :gx]
    t_final = t_final.reshape(gy * gx, ts * ts)
    img = tiles.transpose(0, 1)[:4].reshape(4, gy, gxp, ts, ts)
    img = img.permute(0, 1, 3, 2, 4).reshape(4, gy * ts, gxp * ts)
    return img[:, :h, :w], t_final

