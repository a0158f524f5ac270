"""Block frame: 128-splat blocks with packed per-lane words, plus big lanes.

Counterpart of ``godotgaussiansplatting_tpu/ops/blocks2.py``: the block
build from the fused projection's words (``build_block_frame2_words``) and
from the readable projection's ProjectedSplats (``build_block_frame2``),
with their shared helpers.

  * big splats (anisotropic extent >= BIG_RADIUS) are extracted first into
    a globally depth-sorted BigSet lane table, binned per tile at lane
    granularity (ops/bigbin.py);
  * the remaining splats are cut into blocks of BLOCK_SIZE, either straight
    from the load-time curve order (cluster="bricks", no per-frame sort) or
    after a per-superblock stable row sort by (screen-cell Morton, depth16)
    (cluster="screen");
  * each block carries its lanes' packed words (words payload) or the
    cooked 16-row power features, plus tile rect, an 8x4 coverage bitmap
    over the rect and its depth range.

On the card the stage runs through hand-written kernels, the counterparts
of XLA's fusions of the JAX functions, each held bit-equal to its plain
version, which CPU tensors take:

  * ``screen_pack`` (csrc/screen_pack.cu; ``screen_pack_reference``): the
    readable projection's per-splat packing into chunk keys and stage-1
    words;
  * ``screen_sort`` (csrc/screen_sort.cu; ``screen_sort_reference``): the
    screen clustering's per-superblock stable row sort and its gathers;
  * ``big_window`` (csrc/big_lanes.cu; ``big_window_reference``): each
    chunk row's big-lane window;
  * ``big_set`` (csrc/big_set.cu; ``big_set_reference``): the taken big
    lanes' cooked table, rects and depths;
  * ``_frame_from_stage1`` (csrc/block_frame.cu;
    ``frame_from_stage1_reference``): each brick's payload, rect, bitmap,
    depth range and count.

What stays torch: the global stable sort of the big-lane window, the
``taken`` scatter and the pair count's sum.

Packed u32 words travel as int32 bit patterns (CPU torch lacks shifts and
compares on uint32); they are widened with ``& 0xFFFFFFFF`` into int64
before any shift, compare or sort.

Cooked payload layout (PAYLOAD_WIDTH=16 f32 rows per lane, shared by chain
blocks and BigSet lane tables):
    0..5   f0..f5   power features about the lane's centre (rows 14/15);
                    f0 includes ln(opacity) clamped to <= -1e-3; invalid
                    lanes: f0=-1e4, f1..f5=0
    6..8   r, g, b  colour (invalid: 0)
    9..10  ix, iy   image position (invalid: -1e6)
    11     rx|ry    anisotropic half-widths as a bf16 bit-pair
    12     rank (chain blocks: (depth16<<16 | idx>>7) ^ sign, bitcast) or
           depth16 as f32 (big tables)
    13     idx      source splat index, bitcast
    14..15 bcx, bcy feature centre
Words payload layout ((B, 8, S) int32): [key, ix, iy, pc1, pc2, rgb9e5,
idx, rx|ry bf16 pair].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..config import RasterizerConfig
from .blocks import BIG_RADIUS, SUPERBLOCK

BLOCK_SIZE = 128          # splats per block
PAYLOAD_WIDTH = 16        # f32 rows per lane of the cooked payload
DEPTH_INVALID = 3.0e38    # depth sentinel for culled/padded lanes
GATE_OFF = -1.0e4         # exp(GATE_OFF) == 0 in f32
_CULL_FAR = -1.0e6
U32_MAX = 0xFFFFFFFF      # the u32 "inf" sentinel of sort keys


# --- u32 words carried as int32 bit patterns ---------------------------------

def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the unsigned value."""
    return x.to(torch.int64) & U32_MAX


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> int32 bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _bits16(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 0xFFFF] -> int16 with the same bits."""
    return torch.where(x >= 2**15, x - 2**16, x).to(torch.int16)


def _f32_from_bits(x: torch.Tensor) -> torch.Tensor:
    """Exact power-of-two f32 from an integer tensor of biased exponents."""
    return (x.to(torch.int32) << 23).view(torch.float32)


def _pack_f16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> one int32 word of IEEE f16 halves (a low, b high),
    round-to-nearest-even with subnormals kept."""
    ah = a.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    bh = b.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return i32(ah | (bh << 16))


def _spread8(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 8 bits of int64 v to the even bit positions (Morton)."""
    v = (v | (v << 4)) & 0x0F0F
    v = (v | (v << 2)) & 0x3333
    v = (v | (v << 1)) & 0x5555
    return v


def _unpack_f16(w: torch.Tensor):
    wu = u32(w)
    a = _bits16(wu & 0xFFFF).view(torch.float16).float()
    b = _bits16(wu >> 16).view(torch.float16).float()
    return a, b


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _pack_rgb9e5(r, g, b) -> torch.Tensor:
    """Non-negative RGB -> one int32 word: 9-bit mantissas and a shared 5-bit
    exponent e with 2^(e-1) <= max channel < 2^e."""
    m = torch.maximum(torch.maximum(r, g), b)
    eb = ((torch.clamp(m, min=1e-12).view(torch.int32) >> 23) & 0xFF) - 126
    e = torch.clamp(eb, -15, 16)
    s = _f32_from_bits(9 - e + 127)

    def q(c):
        return torch.clamp(torch.round(c * s), 0.0, 511.0).to(torch.int64)

    return i32(q(r) | (q(g) << 9) | (q(b) << 18)
               | ((e.to(torch.int64) + 15) << 27))


def _unpack_rgb9e5(w: torch.Tensor):
    wu = u32(w)
    e = ((wu >> 27) & 0x1F) - 15
    s = _f32_from_bits(e - 9 + 127)

    def d(sh):
        return ((wu >> sh) & 0x1FF).float() * s

    return d(0), d(9), d(18)


def _pack_bf16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> one f32 tensor holding bf16 bit-pairs (a low)."""
    ah = a.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    bh = b.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return i32(ah | (bh << 16)).view(torch.float32)


def _unpack_bf16_pair(w: torch.Tensor):
    """int32 bf16 bit-pair word -> (low, high) as f32 (exact)."""
    wu = u32(w)
    return (i32((wu & 0xFFFF) << 16).view(torch.float32),
            i32((wu >> 16) << 16).view(torch.float32))


def extents_from_conic(ca, cb, cc, op):
    """Anisotropic alpha-reach half-widths (rx, ry), bf16-rounded.

    Per axis, beyond sigma_axis * sqrt(2 ln(255 op)) the splat's alpha is
    below 1/255, the reference's own cutoff; the cut is capped by the
    reference's square radius R = op^0.2 * 2.5 * sqrt(lambda_max). The
    values are rounded to bf16 so rects and the render gate agree exactly."""
    det = torch.clamp(ca * cc - cb * cb, min=1e-20)
    sxx = torch.clamp(cc / det, min=0.0)
    syy = torch.clamp(ca / det, min=0.0)
    m = 0.5 * (sxx + syy)
    lam = m + torch.sqrt(torch.clamp(m * m - 1.0 / det, min=0.0))
    R = torch.pow(torch.clamp(op, min=0.0), 0.2) * 2.5 * torch.sqrt(lam)
    vis = torch.sqrt(2.0 * torch.clamp(
        torch.log(torch.clamp(op, min=1e-8) * 255.0), min=0.125))
    rx = torch.minimum(R, vis * torch.sqrt(sxx))
    ry = torch.minimum(R, vis * torch.sqrt(syy))
    return _round_bf16(rx), _round_bf16(ry)


def adaptive_cell_shift(P: int, gx: int, gy: int,
                        blocks_per_cell: int = 8) -> int:
    """Smallest cell shift s (cell edge = 2^s tiles) such that each cell's
    depth column holds ~blocks_per_cell blocks of BLOCK_SIZE splats."""
    target_cells = max(P // (BLOCK_SIZE * blocks_per_cell), 1)
    s = 0
    while s < 8 and (-(-gx // (1 << s))) * (-(-gy // (1 << s))) > target_cells:
        s += 1
    return s


class BlockFrame2(NamedTuple):
    """Per-frame block-level state feeding binning and the render kernel."""

    payload: torch.Tensor     # (B, 8, S) i32 words or (B, 16, S) f32 cooked
    rect: torch.Tensor        # (B, 4) i32 block tile rect [x0, y0, x1, y1)
    bitmap: torch.Tensor      # (B,) i32 bits of the 8x4 coverage bitmap
    min_depth: torch.Tensor   # (B,) i32 min depth16 over valid members
    max_depth: torch.Tensor   # (B,) i32 max depth16 over valid members
    num_valid: torch.Tensor   # (B,) i32 surviving splats per block
    num_culled_pairs: torch.Tensor  # () i32 splat-tile pair count


class BigSet(NamedTuple):
    """Globally depth-sorted big-splat lanes (see module docstring)."""

    table: torch.Tensor     # (big_cap, PW) f32 cooked rows; centre = round(pos)
    depth16: torch.Tensor   # (big_cap,) i32 (invalid = 0xFFFF)
    rect: torch.Tensor      # (big_cap, 4) i32 per-lane tile rect
    valid: torch.Tensor     # (big_cap,) bool
    residual: torch.Tensor  # () i32 bigs beyond capacity (left in chains)


def default_big_cap(P: int) -> int:
    """Static lane capacity of the big-splat extraction (<= 40960)."""
    return min(P, max(BLOCK_SIZE * 8,
                      min(P // 64, 40960) // BLOCK_SIZE * BLOCK_SIZE))


def _big_chunk_width(P: int, sb_size: int) -> int:
    """Big-candidate chunk width: 1024, else a smaller power-of-two divisor
    of P."""
    for c in (1024, 512, 256, 128):
        if P % c == 0:
            return min(c, sb_size)
    return sb_size


def big_window_reference(bkey: torch.Tensor, KC: int):
    """Plain version of the big-lane window kernel (csrc/big_lanes.cu):
    (R, CW) int32 chunk keys ((depth16 << 10) | col, or U32_MAX) -> each
    row's KC smallest keys as (pos_w, gk), both (R, KC) int32: the flat
    source position (0 for a dead key) and the 22-bit global key
    ``key >> 10``."""
    R, CW = bkey.shape
    win = torch.sort(u32(bkey), dim=1).values[:, :KC]
    row0 = (torch.arange(R, dtype=torch.int64, device=bkey.device)
            * CW)[:, None]
    pos_w = torch.where(win != U32_MAX, row0 + (win & 0x3FF),
                        torch.zeros_like(win))
    return pos_w.to(torch.int32), (win >> 10).to(torch.int32)


def _big_window_cuda(bkey: torch.Tensor, KC: int):
    """The kernel (csrc/big_lanes.cu): one CTA a chunk row."""
    R, CW = bkey.shape
    if bkey.dtype != torch.int32 or CW > 1024 or not 0 < KC <= CW:
        raise ValueError(f"big_lanes: needs (R, CW <= 1024) int32 keys and "
                         f"0 < KC <= CW, got {bkey.dtype} {tuple(bkey.shape)}"
                         f" KC {KC}")
    kernels.require_cuda("big_lanes", bkey)
    pos_w = torch.empty((R, KC), dtype=torch.int32, device=bkey.device)
    gk = torch.empty_like(pos_w)
    err = kernels.library("big_lanes").gs_big_window(
        bkey.data_ptr(), pos_w.data_ptr(), gk.data_ptr(), R, CW, KC,
        kernels.stream_ptr(bkey.device))
    kernels.check(err, "big_lanes kernel launch")
    kernels.count_launch("big_lanes")
    return pos_w, gk


def big_window(bkey: torch.Tensor, KC: int):
    """Each chunk row's big-lane window (``big_window_reference``). CUDA
    tensors go to the kernel (csrc/big_lanes.cu), CPU tensors to the plain
    version."""
    if bkey.device.type == "cpu":
        return big_window_reference(bkey, KC)
    return _big_window_cuda(bkey, KC)


def _select_big_lanes(bkey: torch.Tensor, big_cap: int):
    """(R, CW) int32 chunk keys ((depth16 << 10) | col, or U32_MAX) -> the
    globally closest big_cap lanes: (tk_idx (big_cap,) int64 flat source
    positions, tk_ok (big_cap,) bool). Candidates beyond a chunk's window or
    the cap stay in their chains. The window's global keys fit in 22 bits,
    so the stable sort runs on int32 keys: the same permutation as on the
    u32 keys, in 32-bit radix passes."""
    R, CW = bkey.shape
    KC = min(CW, max(CW // 4, 4 * big_cap // max(R, 1)))
    pos_w, gk = big_window(bkey, KC)
    gks, order = torch.sort(gk.reshape(-1), stable=True)
    gidx = pos_w.reshape(-1)[order]
    cap = min(big_cap, R * KC)
    tk_idx = gidx[:cap].to(torch.int64)
    tk_ok = gks[:cap] != (U32_MAX >> 10)
    if cap < big_cap:
        pad = big_cap - cap
        tk_idx = torch.cat([tk_idx, tk_idx.new_zeros(pad)])
        tk_ok = torch.cat([tk_ok, tk_ok.new_zeros(pad)])
    return tk_idx, tk_ok


def _taken(tk_idx: torch.Tensor, tk_ok: torch.Tensor, P: int) -> torch.Tensor:
    """(P,) bool: the splats that ``_select_big_lanes`` took. A position is
    taken when any of its entries is ok; the pad entries all point at 0
    and are not ok. A scatter over every entry, with no boolean index:
    that would size its result from the data (a host read on the card,
    which a CUDA graph cannot capture)."""
    hits = torch.zeros(P, dtype=torch.int32, device=tk_idx.device)
    return hits.index_add_(0, tk_idx, tk_ok.to(torch.int32)) > 0


def _tile_rect(ix, iy, rx, ry, gx, gy, ts):
    """Tile rect [x0, y0, x1, y1) of centres +- half-widths (int32)."""
    x0 = torch.clamp((ix - rx) / ts, 0.0, float(gx)).to(torch.int32)
    y0 = torch.clamp((iy - ry) / ts, 0.0, float(gy)).to(torch.int32)
    x1 = torch.clamp(torch.ceil((ix + rx) / ts), 0.0, float(gx)).to(torch.int32)
    y1 = torch.clamp(torch.ceil((iy + ry) / ts), 0.0, float(gy)).to(torch.int32)
    return x0, y0, x1, y1


def big_set_reference(words, tk_idx: torch.Tensor, tk_ok: torch.Tensor,
                      residual: torch.Tensor, cfg: RasterizerConfig
                      ) -> BigSet:
    """Plain version of the big_set kernel (csrc/big_set.cu): the packed
    words (key, ix, iy, pc1, pc2, rgb9; int32, P each) of the lanes
    ``_select_big_lanes`` took -> BigSet (cooked table rows). A taken
    lane is valid, so its key's low 16 bits are its depth16."""
    gx, gy = cfg.tile_dims
    key, ix, iy, pc1, pc2, rgb9 = (w.reshape(-1)[tk_idx] for w in words)
    ix, iy = ix.view(torch.float32), iy.view(torch.float32)
    ca, cb = _unpack_f16(pc1)
    cc, op = _unpack_f16(pc2)
    r, g, b = _unpack_rgb9e5(rgb9)
    depth16 = torch.where(tk_ok, u32(key) & 0xFFFF, U32_MAX)
    valid = tk_ok
    bcx = torch.clamp(torch.round(ix), 0.0, 16383.0)
    bcy = torch.clamp(torch.round(iy), 0.0, 16383.0)
    ixr = ix - bcx
    iyr = iy - bcy
    ln_op = torch.clamp(torch.log(torch.clamp(op, min=1e-37)), max=-1e-3)
    f0q = -0.5 * (ca * ixr * ixr + cc * iyr * iyr) - cb * ixr * iyr
    zero = torch.zeros_like(ix)
    f0 = torch.where(valid, f0q + ln_op, torch.full_like(ix, GATE_OFF))
    f1 = torch.where(valid, ca * ixr + cb * iyr, zero)
    f2 = torch.where(valid, cc * iyr + cb * ixr, zero)
    f3 = torch.where(valid, -0.5 * ca, zero)
    f4 = torch.where(valid, -0.5 * cc, zero)
    f5 = torch.where(valid, -cb, zero)
    far = torch.full_like(ix, _CULL_FAR)
    ix_p = torch.where(valid, ix, far)
    iy_p = torch.where(valid, iy, far)
    rx, ry = extents_from_conic(ca, cb, cc, op)
    rx_p = torch.where(valid, rx, zero)
    ry_p = torch.where(valid, ry, zero)
    depth_f = torch.where(valid, (depth16 & 0xFFFF).float(),
                          torch.full_like(ix, DEPTH_INVALID))
    idx_f = tk_idx.to(torch.int32).view(torch.float32)
    table = torch.stack([
        f0, f1, f2, f3, f4, f5,
        torch.where(valid, r, zero), torch.where(valid, g, zero),
        torch.where(valid, b, zero),
        ix_p, iy_p, _pack_bf16_pair(rx_p, ry_p), depth_f, idx_f, bcx, bcy,
    ], dim=1)                                      # (big_cap, PW)
    x0, y0, x1, y1 = _tile_rect(ix_p, iy_p, rx_p, ry_p, gx, gy,
                                float(cfg.tile_size))
    rect = torch.where(valid[:, None], torch.stack([x0, y0, x1, y1], dim=-1),
                       torch.zeros((ix.shape[0], 4), dtype=torch.int32,
                                   device=ix.device))
    return BigSet(table=table, depth16=(depth16 & 0xFFFF).to(torch.int32),
                  rect=rect, valid=valid, residual=residual)


def _big_set_cuda(words, tk_idx: torch.Tensor, tk_ok: torch.Tensor,
                  residual: torch.Tensor, cfg: RasterizerConfig) -> BigSet:
    """The kernel (csrc/big_set.cu): one thread a lane."""
    flat = [w.reshape(-1) for w in words]
    P = flat[0].numel()
    for w in flat:
        if w.dtype != torch.int32 or w.numel() != P:
            raise ValueError(f"big_set: expected six words of {P} int32, "
                             f"got {w.dtype} {w.numel()}")
    N = tk_idx.shape[0]
    if (tk_idx.dtype != torch.int64 or tk_ok.dtype != torch.bool
            or tuple(tk_ok.shape) != (N,) or tk_idx.dim() != 1):
        raise ValueError(f"big_set: expected (N,) int64 tk_idx and bool "
                         f"tk_ok, got {tk_idx.dtype} {tuple(tk_idx.shape)} "
                         f"and {tk_ok.dtype} {tuple(tk_ok.shape)}")
    kernels.require_cuda("big_set", *flat, tk_idx, tk_ok)
    dev = tk_idx.device
    gx, gy = cfg.tile_dims
    table = torch.empty((N, PAYLOAD_WIDTH), dtype=torch.float32, device=dev)
    rect = torch.empty((N, 4), dtype=torch.int32, device=dev)
    depth16 = torch.empty((N,), dtype=torch.int32, device=dev)
    err = kernels.library("big_set").gs_big_set(
        *(w.data_ptr() for w in flat), tk_idx.data_ptr(), tk_ok.data_ptr(),
        table.data_ptr(), rect.data_ptr(), depth16.data_ptr(), N, gx, gy,
        cfg.tile_size, kernels.stream_ptr(dev))
    kernels.check(err, "big_set kernel launch")
    kernels.count_launch("big_set")
    return BigSet(table=table, depth16=depth16, rect=rect, valid=tk_ok,
                  residual=residual)


def big_set(words, tk_idx: torch.Tensor, tk_ok: torch.Tensor,
            residual: torch.Tensor, cfg: RasterizerConfig) -> BigSet:
    """The taken big lanes' BigSet (``big_set_reference``). CUDA tensors go
    to the kernel (csrc/big_set.cu), CPU tensors to the plain version."""
    if tk_idx.device.type == "cpu":
        return big_set_reference(words, tk_idx, tk_ok, residual, cfg)
    return _big_set_cuda(words, tk_idx, tk_ok, residual, cfg)


def _or_reduce(bits: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of non-negative int64 values (< 2^32) along ``dim``."""
    out = torch.zeros_like(bits.select(dim, 0))
    for j in range(32):
        out |= ((bits >> j) & 1).amax(dim=dim) << j
    return out


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, 2^k) -> (B,): the sum along dim 1 in a fixed pairwise tree,
    x[:, :n/2] + x[:, n/2:] down to one column (the block_frame kernel's
    order; torch's own reduction order on the card is not defined)."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def frame_from_stage1_reference(s1, B: int, S: int, cfg: RasterizerConfig,
                                num_culled_pairs, words: bool = False,
                                taken: torch.Tensor | None = None
                                ) -> BlockFrame2:
    """Stage-1 operand rows -> BlockFrame2: the plain version of the
    block_frame kernel (csrc/block_frame.cu).

    s1: 7-tuple of int32 word tensors (key, ix bits, iy bits, f16(ca|cb),
    f16(cc|op), rgb9e5, source idx), any shape reshapeable to (B, S).
    ``taken``, a bool tensor of the same size or None: a taken lane's key
    reads as -1 (invalid). words=True keeps the (B, 8, S) word image as the
    payload (the render kernel unpacks in-kernel); otherwise the 16-row f32
    payload is cooked. Block meta (rect, bitmap, depth range, num_valid) is
    the same either way."""
    gx, gy = cfg.tile_dims
    ts = float(cfg.tile_size)

    def blk(x):
        return x.reshape(B, S)

    key_w = blk(s1[0])
    if taken is not None:
        key_w = torch.where(blk(taken), -1, key_w).to(torch.int32)
    key_b = u32(key_w)
    depth_b = key_b & 0xFFFF
    ix = blk(s1[1]).view(torch.float32)
    iy = blk(s1[2]).view(torch.float32)
    ca, cb = _unpack_f16(blk(s1[3]))
    cc, op = _unpack_f16(blk(s1[4]))
    idx_s = blk(s1[6])
    valid = key_b != U32_MAX
    rx, ry = extents_from_conic(ca, cb, cc, op)

    nv = valid.sum(dim=1).to(torch.int32)
    far = torch.full_like(ix, _CULL_FAR)
    zero = torch.zeros_like(ix)
    ix_p = torch.where(valid, ix, far)
    iy_p = torch.where(valid, iy, far)
    rx_p = torch.where(valid, rx, zero)
    ry_p = torch.where(valid, ry, zero)

    if words:
        payload = torch.stack(
            [key_w, blk(s1[1]), blk(s1[2]), blk(s1[3]), blk(s1[4]),
             blk(s1[5]), blk(s1[6]),
             _pack_bf16_pair(rx_p, ry_p).view(torch.int32)], dim=1)
    else:
        r, g, b = _unpack_rgb9e5(blk(s1[5]))
        nv_safe = torch.clamp(nv, min=1).float()
        ix_v = torch.where(valid, ix, zero)
        iy_v = torch.where(valid, iy, zero)
        bcx = torch.clamp(torch.round(_tree_sum(ix_v) / nv_safe), 0.0,
                          16383.0)
        bcy = torch.clamp(torch.round(_tree_sum(iy_v) / nv_safe), 0.0,
                          16383.0)
        ixr = ix - bcx[:, None]
        iyr = iy - bcy[:, None]
        ln_op = torch.clamp(torch.log(torch.clamp(op, min=1e-37)), max=-1e-3)
        f0q = -0.5 * (ca * ixr * ixr + cc * iyr * iyr) - cb * ixr * iyr
        f0 = torch.where(valid, f0q + ln_op, torch.full_like(ix, GATE_OFF))
        f1 = torch.where(valid, ca * ixr + cb * iyr, zero)
        f2 = torch.where(valid, cc * iyr + cb * ixr, zero)
        f3 = torch.where(valid, -0.5 * ca, zero)
        f4 = torch.where(valid, -0.5 * cc, zero)
        f5 = torch.where(valid, -cb, zero)
        rank = ((depth_b << 16) | ((idx_s.to(torch.int64) >> 7) & 0xFFFF)) \
            ^ 0x80000000
        payload = torch.stack([
            f0, f1, f2, f3, f4, f5,
            torch.where(valid, r, zero), torch.where(valid, g, zero),
            torch.where(valid, b, zero),
            ix_p, iy_p, _pack_bf16_pair(rx_p, ry_p),
            i32(rank).view(torch.float32), idx_s.view(torch.float32),
            bcx[:, None].expand(B, S), bcy[:, None].expand(B, S),
        ], dim=1)

    # --- block tile rect / coverage bitmap / depth range --------------------
    srx0, sry0, srx1, sry1 = _tile_rect(ix_p, iy_p, rx_p, ry_p, gx, gy, ts)
    bigc = 1 << 20
    srx0 = torch.where(valid, srx0, bigc)
    sry0 = torch.where(valid, sry0, bigc)
    srx1 = torch.where(valid, srx1, -bigc)
    sry1 = torch.where(valid, sry1, -bigc)

    lo = torch.stack([srx0.amin(dim=1), sry0.amin(dim=1)], -1)
    hi = torch.stack([srx1.amax(dim=1), sry1.amax(dim=1)], -1)
    empty = ~valid.any(dim=1)
    block_rect = torch.where(
        empty[:, None], torch.zeros((B, 4), dtype=torch.int32,
                                    device=ix.device),
        torch.cat([lo, torch.maximum(hi, lo)], dim=-1).to(torch.int32))

    bx0g, by0g = block_rect[:, 0:1], block_rect[:, 1:2]
    sw = torch.clamp(-(-(block_rect[:, 2:3] - bx0g) // 8), min=1)
    sh_ = torch.clamp(-(-(block_rect[:, 3:4] - by0g) // 4), min=1)
    cx0 = torch.clamp((srx0 - bx0g) // sw, 0, 7)
    cx1 = torch.clamp(torch.maximum(-(-(srx1 - bx0g) // sw), cx0 + 1), max=8)
    cy0 = torch.clamp((sry0 - by0g) // sh_, 0, 3)
    cy1 = torch.clamp(torch.maximum(-(-(sry1 - by0g) // sh_), cy0 + 1), max=4)
    colmask = ((1 << cx1.to(torch.int64)) - (1 << cx0.to(torch.int64)))
    bits = torch.zeros_like(colmask)
    for yrow in range(4):
        bits = bits | torch.where((cy0 <= yrow) & (yrow < cy1),
                                  colmask << (8 * yrow), 0)
    bits = torch.where(valid, bits, 0)
    bitmap = i32(_or_reduce(bits, 1))

    min_depth = torch.where(valid, depth_b, 0xFFFF).amin(dim=1)
    max_depth = torch.where(valid, depth_b, 0).amax(dim=1)
    min_depth = torch.where(empty, 0xFFFF, min_depth).to(torch.int32)
    max_depth = torch.where(empty, 0xFFFF, max_depth).to(torch.int32)

    return BlockFrame2(
        payload=payload, rect=block_rect, bitmap=bitmap,
        min_depth=min_depth, max_depth=max_depth, num_valid=nv,
        num_culled_pairs=torch.as_tensor(num_culled_pairs).to(torch.int32),
    )


def _frame_from_stage1_cuda(s1, B: int, S: int, cfg: RasterizerConfig,
                            num_culled_pairs, words: bool = False,
                            taken: torch.Tensor | None = None
                            ) -> BlockFrame2:
    """The kernel (csrc/block_frame.cu): one CTA of 128 threads a brick."""
    if S != BLOCK_SIZE:
        raise ValueError(f"block_frame: bricks of {BLOCK_SIZE} lanes, got {S}")
    flat = [x.reshape(-1) for x in s1]
    for x in flat:
        if x.dtype != torch.int32 or x.numel() != B * S:
            raise ValueError(f"block_frame: expected {B * S} int32 words, "
                             f"got {x.dtype} {x.numel()}")
    extra = []
    if taken is not None:
        taken = taken.reshape(-1)
        if taken.dtype != torch.bool or taken.numel() != B * S:
            raise ValueError(f"block_frame: expected a {B * S} bool taken "
                             f"mask, got {taken.dtype} {taken.numel()}")
        extra = [taken]
    kernels.require_cuda("block_frame", *flat, *extra)
    dev = flat[0].device
    gx, gy = cfg.tile_dims

    def meta():
        return torch.empty((B,), dtype=torch.int32, device=dev)

    payload = (torch.empty((B, 8, S), dtype=torch.int32, device=dev) if words
               else torch.empty((B, PAYLOAD_WIDTH, S), device=dev))
    rect = torch.empty((B, 4), dtype=torch.int32, device=dev)
    bitmap, min_depth, max_depth, nv = meta(), meta(), meta(), meta()
    err = kernels.library("block_frame").gs_block_frame(
        *(x.data_ptr() for x in flat),
        taken.data_ptr() if taken is not None else None,
        *(t.data_ptr() for t in (payload, rect, bitmap, min_depth,
                                 max_depth, nv)),
        B, int(not words), gx, gy, cfg.tile_size, kernels.stream_ptr(dev))
    kernels.check(err, "block_frame kernel launch")
    kernels.count_launch("block_frame" if words else "block_frame_cooked")
    return BlockFrame2(
        payload=payload, rect=rect, bitmap=bitmap, min_depth=min_depth,
        max_depth=max_depth, num_valid=nv,
        num_culled_pairs=torch.as_tensor(num_culled_pairs).to(torch.int32))


def _frame_from_stage1(s1, B: int, S: int, cfg: RasterizerConfig,
                       num_culled_pairs, words: bool = False,
                       taken: torch.Tensor | None = None) -> BlockFrame2:
    """Stage-1 operand rows -> BlockFrame2 (``frame_from_stage1_reference``).
    CUDA tensors go to the kernel (csrc/block_frame.cu), CPU tensors to
    the plain version."""
    if s1[0].device.type == "cpu":
        return frame_from_stage1_reference(s1, B, S, cfg, num_culled_pairs,
                                           words, taken)
    return _frame_from_stage1_cuda(s1, B, S, cfg, num_culled_pairs, words,
                                   taken)


class ScreenWords(NamedTuple):
    """The readable projection's per-splat pack (``screen_pack``)."""

    key: torch.Tensor      # (P,) i32 (cell Morton << 16 | depth16) or -1
    ix: torch.Tensor       # (P,) i32 image x bits
    iy: torch.Tensor       # (P,) i32 image y bits
    pc1: torch.Tensor      # (P,) i32 f16(ca) | f16(cb) << 16
    pc2: torch.Tensor      # (P,) i32 f16(cc) | f16(opacity) << 16
    rgb9: torch.Tensor     # (P,) i32 rgb9e5
    bkey: torch.Tensor     # (P // CW, CW) i32 chunk keys (depth16 << 10 | col)
    num_big: torch.Tensor  # () i32 big splats


def screen_pack_reference(prj, cell: int, CW: int,
                          cfg: RasterizerConfig) -> ScreenWords:
    """Plain version of the screen_pack kernel (csrc/screen_pack.cu):
    ProjectedSplats -> the stage-1 key before the big-lane extraction (the
    screen cell's Morton code at edge 2^cell tiles over depth16, or -1 for
    a culled splat), the packed operand words, the big-candidate chunk keys
    ((depth16 << 10) | column for a valid splat whose anisotropic extent
    reaches BIG_RADIUS, else -1) and the count of big splats."""
    P = prj.valid.shape[0]
    R = P // CW
    gx, gy = cfg.tile_dims
    ts = float(cfg.tile_size)
    valid = prj.valid
    depth = prj.depth16.to(torch.int64)
    ipos, conic, color = prj.image_pos, prj.conic, prj.color
    ctx = torch.clamp((ipos[:, 0] / ts).to(torch.int32), 0, gx - 1).to(
        torch.int64) >> cell
    cty = torch.clamp((ipos[:, 1] / ts).to(torch.int32), 0, gy - 1).to(
        torch.int64) >> cell
    morton = _spread8(ctx & 0xFF) | (_spread8(cty & 0xFF) << 1)
    rx, ry = extents_from_conic(conic[:, 0], conic[:, 1], conic[:, 2],
                                color[:, 3])
    is_big = (torch.maximum(rx, ry) >= BIG_RADIUS) & valid
    colv = torch.arange(CW, dtype=torch.int64, device=valid.device)[None]
    bkey = torch.where(is_big.reshape(R, CW),
                       (depth.reshape(R, CW) << 10) | colv, U32_MAX)
    key = torch.where(valid, ((morton & 0x7FFF) << 16) | depth, U32_MAX)
    return ScreenWords(
        key=i32(key), ix=ipos[:, 0].contiguous().view(torch.int32),
        iy=ipos[:, 1].contiguous().view(torch.int32),
        pc1=_pack_f16(conic[:, 0], conic[:, 1]),
        pc2=_pack_f16(conic[:, 2], color[:, 3]),
        rgb9=_pack_rgb9e5(color[:, 0], color[:, 1], color[:, 2]),
        bkey=i32(bkey), num_big=is_big.sum().to(torch.int32))


def _screen_pack_cuda(prj, cell: int, CW: int,
                      cfg: RasterizerConfig) -> ScreenWords:
    """The kernel (csrc/screen_pack.cu): one thread a splat."""
    P = prj.valid.shape[0]
    fields = (("valid", torch.bool, (P,)), ("depth16", torch.int32, (P,)),
              ("image_pos", torch.float32, (P, 2)),
              ("conic", torch.float32, (P, 3)),
              ("color", torch.float32, (P, 4)))
    for name, dtype, shape in fields:
        t = getattr(prj, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"screen_pack: {name} must be {dtype} {shape},"
                             f" got {t.dtype} {tuple(t.shape)}")
    if CW <= 0 or P % CW:
        raise ValueError(f"screen_pack: {P} splats in chunks of {CW}")
    ins = [getattr(prj, name) for name, _, _ in fields]
    kernels.require_cuda("screen_pack", *ins)
    dev = prj.valid.device
    gx, gy = cfg.tile_dims
    out = torch.empty((7, P), dtype=torch.int32, device=dev)
    num_big = torch.empty((), dtype=torch.int32, device=dev)
    err = kernels.library("screen_pack").gs_screen_pack(
        *(t.data_ptr() for t in ins), *(out[k].data_ptr() for k in range(7)),
        num_big.data_ptr(), P, CW, cell, gx, gy, cfg.tile_size,
        kernels.stream_ptr(dev))
    kernels.check(err, "screen_pack kernel launch")
    kernels.count_launch("screen_pack")
    bkey, key, ix, iy, pc1, pc2, rgb9 = out.unbind(0)
    return ScreenWords(key=key, ix=ix, iy=iy, pc1=pc1, pc2=pc2, rgb9=rgb9,
                       bkey=bkey.reshape(P // CW, CW), num_big=num_big)


def screen_pack(prj, cell: int, CW: int,
                cfg: RasterizerConfig) -> ScreenWords:
    """The readable projection's per-splat pack (``screen_pack_reference``).
    CUDA tensors go to the kernel (csrc/screen_pack.cu), CPU tensors to
    the plain version."""
    if prj.valid.device.type == "cpu":
        return screen_pack_reference(prj, cell, CW, cfg)
    return _screen_pack_cuda(prj, cell, CW, cfg)


def screen_sort_reference(key: torch.Tensor, taken: torch.Tensor,
                          words) -> tuple:
    """Plain version of the screen_sort kernel (csrc/screen_sort.cu): each
    (SB, n) row's int32 keys, read as -1 where ``taken``, sorted stably as
    u32, and the stage-1 words in that order: (key, *words, source
    position), seven (SB, n) int32 tensors."""
    key = torch.where(taken, -1, key).to(torch.int32)
    SB, n = key.shape
    idx = torch.arange(SB * n, dtype=torch.int32,
                       device=key.device).reshape(SB, n)
    order = torch.sort(u32(key), dim=1, stable=True).indices
    return tuple(torch.gather(a, 1, order) for a in (key, *words, idx))


def _screen_sort_cuda(key: torch.Tensor, taken: torch.Tensor,
                      words) -> tuple:
    """The kernel (csrc/screen_sort.cu): one CTA a row of n <= 8192."""
    SB, n = key.shape
    if not 0 < n <= SUPERBLOCK or len(words) != 5:
        raise ValueError(f"screen_sort: rows of 1 to {SUPERBLOCK} keys and "
                         f"five words, got {tuple(key.shape)} and "
                         f"{len(words)}")
    if taken.dtype != torch.bool or taken.shape != key.shape:
        raise ValueError(f"screen_sort: expected a {tuple(key.shape)} bool "
                         f"taken mask, got {taken.dtype} "
                         f"{tuple(taken.shape)}")
    for w in (key, *words):
        if w.dtype != torch.int32 or w.shape != key.shape:
            raise ValueError(f"screen_sort: expected {tuple(key.shape)} "
                             f"int32 words, got {w.dtype} {tuple(w.shape)}")
    kernels.require_cuda("screen_sort", key, taken, *words)
    out = torch.empty((7, SB, n), dtype=torch.int32, device=key.device)
    err = kernels.library("screen_sort").gs_screen_sort(
        key.data_ptr(), taken.data_ptr(), *(w.data_ptr() for w in words),
        out.data_ptr(), SB, n, kernels.stream_ptr(key.device))
    kernels.check(err, "screen_sort kernel launch")
    kernels.count_launch("screen_sort")
    return tuple(out.unbind(0))


def screen_sort(key: torch.Tensor, taken: torch.Tensor, words) -> tuple:
    """The screen clustering's per-superblock stable row sort
    (``screen_sort_reference``). CUDA tensors go to the kernel
    (csrc/screen_sort.cu), CPU tensors to the plain version."""
    if key.device.type == "cpu":
        return screen_sort_reference(key, taken, words)
    return _screen_sort_cuda(key, taken, words)


def build_block_frame2_words(words, cfg: RasterizerConfig,
                             num_splats: int | None = None,
                             big_cap: int | None = None,
                             words_payload: bool = False):
    """Fused-projection outputs (ops/projection_kernel.ProjWords) ->
    (BlockFrame2, BigSet). The projection already packed every per-splat
    operand, so this runs only the big selection, the optional stage-1
    sort and the block build. ``num_splats`` is accepted for signature
    parity; the projection already chose the cell granularity."""
    del num_splats
    P = words.key.shape[1]
    S = BLOCK_SIZE
    sb_size = min(SUPERBLOCK, P)
    if P % sb_size:
        raise ValueError(f"splat capacity {P} must be a multiple of {sb_size}")
    SB = P // sb_size
    B = P // S

    cnt = words.cnt.reshape(-1, 128).to(torch.int64)
    num_big = cnt[:, 0].sum()
    nt_total = cnt[:, 1].sum()

    if big_cap is None:
        big_cap = default_big_cap(P)
    big_cap = max(big_cap, S)
    tk_idx, tk_ok = _select_big_lanes(words.bkey, big_cap)
    taken = _taken(tk_idx, tk_ok, P)
    packed = (words.key, words.ix, words.iy, words.pc1, words.pc2,
              words.rgb9)
    bigs = big_set(packed, tk_idx, tk_ok,
                   (num_big - tk_ok.sum()).to(torch.int32), cfg)

    def srows(a):
        return a.reshape(SB, sb_size)

    if cfg.cluster == "bricks":   # static curve-order bricks: no sort
        # the frame build reads a taken lane's key as -1
        idx = torch.arange(P, dtype=torch.int32, device=words.key.device)
        s1, mask = tuple(srows(a) for a in packed + (idx,)), taken
    else:
        s1 = screen_sort(srows(words.key), srows(taken),
                         tuple(srows(a) for a in packed[1:]))
        mask = None
    return _frame_from_stage1(s1, B, S, cfg, nt_total.to(torch.int32),
                              words=words_payload, taken=mask), bigs


def build_block_frame2(prj, cfg: RasterizerConfig,
                       num_splats: int | None = None,
                       big_cap: int | None = None,
                       words_payload: bool = False):
    """ProjectedSplats (ops/projection.py; padded P = B * S splats in load
    order) -> (BlockFrame2, BigSet).

    The per-splat operands are packed (``screen_pack``: f16 conic and
    opacity pairs, rgb9e5 colour), the big splats are extracted by chunked
    candidate keys ((depth16 << 10) | column), and the rest are clustered:
    per superblock, a stable sort by the stage-1 key (screen-cell Morton
    << 16 | depth16, with the cell edge from ``adaptive_cell_shift``;
    ``screen_sort``), or the static bricks of the load order.
    ``num_splats`` (default: the capacity) picks the cell. The JAX
    package's ``GS_BLOCKS_GATHER`` variant (a TPU A/B knob with the same
    result) is not carried over."""
    S = BLOCK_SIZE
    P = prj.valid.shape[0]
    sb_size = min(SUPERBLOCK, P)
    if P % sb_size:
        raise ValueError(f"splat capacity {P} must be a multiple of {sb_size}")
    B = P // S
    SB = P // sb_size
    gx, gy = cfg.tile_dims

    cell = adaptive_cell_shift(num_splats or P, gx, gy)
    CW = _big_chunk_width(P, sb_size)
    sw = screen_pack(prj, cell, CW, cfg)

    # --- big-lane extraction before clustering ------------------------------
    if big_cap is None:
        big_cap = default_big_cap(P)
    big_cap = max(big_cap, S)
    tk_idx, tk_ok = _select_big_lanes(sw.bkey, big_cap)
    taken = _taken(tk_idx, tk_ok, P)
    packed = (sw.key, sw.ix, sw.iy, sw.pc1, sw.pc2, sw.rgb9)
    bigs = big_set(packed, tk_idx, tk_ok,
                   (sw.num_big - tk_ok.sum()).to(torch.int32), cfg)

    # --- stage 1: per-superblock (cell Morton, depth16) clustering ----------
    def srows(a):
        return a.reshape(SB, sb_size)

    if cfg.cluster == "bricks":   # static curve-order bricks: no sort
        # the frame build reads a taken lane's key as -1
        idx = torch.arange(P, dtype=torch.int32, device=prj.valid.device)
        s1, mask = tuple(srows(a) for a in packed + (idx,)), taken
    else:
        s1 = screen_sort(srows(sw.key), srows(taken),
                         tuple(srows(a) for a in packed[1:]))
        mask = None
    frame = _frame_from_stage1(s1, B, S, cfg,
                               prj.num_tiles.sum().to(torch.int32),
                               words=words_payload, taken=mask)
    return frame, bigs
