"""Per-tile big-splat lane binning.

Counterpart of ``godotgaussiansplatting_tpu/ops/bigbin.py``. The BigSet
lanes (ops/blocks2.py) are binned per render GROUP of horizontally
contiguous tiles (GROUP = 1: per tile) at lane granularity with the same
two-level supertile compaction as ops/binning2.py. The BigSet table is
globally sorted by (depth16, source index), so lane index order is front to
back and each tile's list comes out exactly depth-sorted. Tiles with more
than ``obig`` lanes keep the closest ones; the dropped tail is counted in
``overflow``.

On the card the binning is a hand-written kernel, csrc/bin_bigs.cu, the
counterpart of XLA's sorts, gather and histogram in the JAX function; CPU
tensors take the plain version, ``bin_bigs_reference``, which keeps the JAX
function's stable sorts (each a compaction of the covering lanes in lane
order) and which the kernel is held bit-equal to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..config import RasterizerConfig
from .binning2 import SUPER, _i32s, supertile_origins
from .blocks2 import DEPTH_INVALID, GATE_OFF, PAYLOAD_WIDTH, _CULL_FAR

GROUP = 1  # tiles per render group; the render kernel runs one tile a block
#           (csrc/bin_bigs.cu bins single tiles)


class TileBigs(NamedTuple):
    bigpay: torch.Tensor      # (TG, PW, OBIG) f32 per-group lane payloads,
                              # front to back; dead lanes sanitized
    tile_nbig: torch.Tensor   # (TG,) i32 live lane count
    overflow: torch.Tensor    # () i32 group-lane pairs dropped by caps
    big_prefix: torch.Tensor  # (TG, 128) i32 inclusive prefix count of live
                              # lanes over 128 depth16 buckets (depth >> 9):
                              # the render kernel's straddle gate


def bin_bigs_reference(bigs, cfg: RasterizerConfig, obig: int = 128,
                       supertile_cap: int = 2048,
                       tile_row_offset: int = 0) -> TileBigs:
    """The plain version of the bin_bigs kernel: the JAX function's sorts,
    gather and bucket histogram."""
    gx, gy = cfg.tile_dims
    gx2 = -(-gx // GROUP)
    TG = gx2 * gy
    N = bigs.table.shape[0]
    C1 = min(supertile_cap, N)
    OB = min(obig, C1)
    dev = bigs.table.device
    sgx, sgy, ssx, ssy = supertile_origins(gx, gy, dev)
    NS = sgx * sgy

    r = bigs.rect.to(torch.int64)
    sup_x0 = ssx * SUPER
    sup_y0 = ssy * SUPER + tile_row_offset
    covers = ((r[:, 0][None] < sup_x0 + SUPER) & (r[:, 2][None] > sup_x0)
              & (r[:, 1][None] < sup_y0 + SUPER) & (r[:, 3][None] > sup_y0)
              & bigs.valid[None])                   # (NS, N)

    iota = torch.arange(N, dtype=torch.int64, device=dev)
    key1 = torch.where(covers, iota[None], N)
    k1s = torch.sort(key1, dim=1, stable=True).values[:, :C1]
    cand_valid = k1s != N
    cand = torch.where(cand_valid, k1s, 0)
    over_l1 = covers.sum() - cand_valid.sum()

    rects_c = r[cand]                               # (NS, C1, 4)

    GPR = SUPER // GROUP
    NGS = SUPER * GPR
    gxi = torch.arange(GPR, dtype=torch.int64, device=dev)
    gyi = torch.arange(SUPER, dtype=torch.int64, device=dev)
    wx0 = ssx[:, 0][:, None] * SUPER + gxi[None] * GROUP     # (NS, GPR)
    wy = ssy[:, 0][:, None] * SUPER + gyi[None] + tile_row_offset
    wxx = wx0[:, None, :].expand(NS, SUPER, GPR).reshape(NS, NGS)
    wyy = wy[:, :, None].expand(NS, SUPER, GPR).reshape(NS, NGS)

    covers_t = ((rects_c[:, None, :, 0] < wxx[:, :, None] + GROUP)
                & (wxx[:, :, None] < rects_c[:, None, :, 2])
                & (rects_c[:, None, :, 1] <= wyy[:, :, None])
                & (wyy[:, :, None] < rects_c[:, None, :, 3])
                & cand_valid[:, None])              # (NS, NGS, C1)

    # (position, lane) in one int64 key: the lane takes the low 32 bits
    # (the JAX package packs it into 16 of a u32 and asserts N <= 65535,
    # which a sharded frame's gathered big set exceeds at real sizes)
    pos = torch.arange(C1, dtype=torch.int64, device=dev)[None, None]
    key2 = torch.where(covers_t, (pos << 32) | cand[:, None, :], C1 << 32)
    k2s = torch.sort(key2, dim=2, stable=True).values[:, :, :OB]
    hit = (k2s >> 32) != C1
    sel = torch.where(hit, k2s & 0xFFFFFFFF, 0)
    nbig = covers_t.sum(dim=2)
    over_l2 = torch.clamp(nbig - OB, min=0).sum()
    nbig = torch.clamp(nbig, max=OB)

    def to_tiles(a):
        extra = a.shape[2:]
        a = a.reshape(sgy, sgx, SUPER, GPR, *extra).movedim(2, 1)
        a = a.reshape(sgy * SUPER, sgx * GPR, *extra)
        return a[:gy, :gx2].reshape(TG, *extra)

    sel_t = to_tiles(sel)                           # (TG, OB)
    hit_t = to_tiles(hit)
    tp = bigs.table[sel_t.reshape(-1)]
    tp = tp.reshape(TG, OB, PAYLOAD_WIDTH).transpose(1, 2)   # (TG, PW, OB)
    # a dead lane's row, made by fills (no copy from host memory, which a
    # CUDA graph cannot capture)
    dead = torch.zeros(PAYLOAD_WIDTH, dtype=torch.float32, device=dev)
    dead[0].fill_(GATE_OFF)
    dead[9:11].fill_(_CULL_FAR)
    dead[12].fill_(DEPTH_INVALID)
    tp = torch.where(hit_t[:, None, :], tp, dead[None, :, None]).contiguous()

    d_i = torch.clamp(tp[:, 12, :], 0.0, 65535.0).to(torch.int64) >> 9
    bkt = torch.arange(128, dtype=torch.int64, device=dev)[None, :, None]
    hist = ((d_i[:, None, :] == bkt) & hit_t[:, None, :]).sum(dim=2)
    prefix = torch.cumsum(hist, dim=1).to(torch.int32)

    return TileBigs(bigpay=tp, tile_nbig=to_tiles(nbig).to(torch.int32),
                    overflow=(over_l1 + over_l2).to(torch.int32),
                    big_prefix=prefix)


def _bin_bigs_cuda(bigs, cfg: RasterizerConfig, obig: int = 128,
                   supertile_cap: int = 2048,
                   tile_row_offset: int = 0) -> TileBigs:
    """The kernel (csrc/bin_bigs.cu): the L1 and L2 compactions, the lane
    gather and the bucket prefix, with no sort. Its payload stores are 16
    bytes wide where OB is a multiple of 4 (every configuration the repo
    runs: the default big-lane cap is a multiple of 128 and obig 128)."""
    gx, gy = cfg.tile_dims
    sgx, sgy = -(-gx // SUPER), -(-gy // SUPER)
    N = bigs.table.shape[0]
    C1 = min(supertile_cap, N)
    OB = min(obig, C1)
    table, rect, valid = (t.contiguous() for t in (bigs.table, bigs.rect,
                                                   bigs.valid))
    if (table.dtype != torch.float32 or table.shape[1:] != (PAYLOAD_WIDTH,)
            or rect.dtype != torch.int32 or valid.dtype != torch.bool):
        raise ValueError(f"bin_bigs: expected a (N, {PAYLOAD_WIDTH}) f32 "
                         f"table, int32 rects and a bool mask, got "
                         f"{table.dtype} {tuple(table.shape)}, {rect.dtype}, "
                         f"{valid.dtype}")
    kernels.require_cuda("bin_bigs", table, rect, valid)
    dev = table.device
    lib = kernels.library("bin_bigs")
    NS = sgx * sgy
    nchunks = -(-N // lib.gs_bin_bigs_chunk())
    TG = gx * gy

    # the supertile ranges, the chunk counts (then offsets) and totals, and
    # each supertile's candidates: lane id and rect
    scratch = (_i32s(dev, N), _i32s(dev, nchunks, NS), _i32s(dev, NS),
               _i32s(dev, NS, C1), _i32s(dev, NS, C1, 4))
    bigpay = torch.empty((TG, PAYLOAD_WIDTH, OB), device=dev)
    nbig, overflow, prefix = _i32s(dev, TG), _i32s(dev), _i32s(dev, TG, 128)
    err = lib.gs_bin_bigs(
        *(t.data_ptr() for t in (table, rect, valid, *scratch, bigpay, nbig,
                                 overflow, prefix)),
        N, gx, gy, C1, OB, tile_row_offset, kernels.stream_ptr(dev))
    kernels.check(err, "bin_bigs kernel launch")
    kernels.count_launch("bin_bigs")
    return TileBigs(bigpay=bigpay, tile_nbig=nbig, overflow=overflow,
                    big_prefix=prefix)


def bin_bigs(bigs, cfg: RasterizerConfig, obig: int = 128,
             supertile_cap: int = 2048, tile_row_offset: int = 0) -> TileBigs:
    """Per-tile big-lane lists (``bin_bigs_reference``). CUDA tensors go to
    the kernel (csrc/bin_bigs.cu), CPU tensors to the plain version."""
    if bigs.table.device.type == "cpu":
        return bin_bigs_reference(bigs, cfg, obig, supertile_cap,
                                  tile_row_offset)
    return _bin_bigs_cuda(bigs, cfg, obig, supertile_cap, tile_row_offset)
