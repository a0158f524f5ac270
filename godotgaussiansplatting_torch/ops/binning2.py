"""Two-level tile binning of blocks (supertile, then tile compaction).

Counterpart of ``godotgaussiansplatting_tpu/ops/binning2.py``. Tile lists
are ordered by block min depth (the v3 render composites blocks in list
order, exact within +-1 batch); the packed depth range (min16 << 16 |
max16) rides along to the per-tile rows.

On the card the binning is a hand-written kernel, csrc/bin_blocks.cu, the
counterpart of XLA's sorts in the JAX function; CPU tensors take the plain
version, ``bin_blocks2_reference``, which keeps the JAX function's sorts
(u32 keys widened to int64, since torch has no uint32 compares on the CPU;
every sort that orders ties is stable) and which the kernel is held
bit-equal to. The global pre-sort is a stable ranking of the depth keys,
which the kernel computes by chunks (each sorted in shared memory, then
each key placed by the other chunks' bucket prefixes and a short search);
each of the other sorts is a stable compaction (the covering positions in
order, then padding), which is what the kernel computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..config import RasterizerConfig
from .blocks2 import BlockFrame2, U32_MAX, i32, u32

SUPER = 8  # tiles per supertile edge


class TileBins2(NamedTuple):
    tile_blocks: torch.Tensor     # (T, C2) i32 block ids, -1 padded
    tile_nblocks: torch.Tensor    # (T,) i32
    tile_minmax: torch.Tensor     # (T, C2) i32 packed min16<<16|max16
    tile_candidates: torch.Tensor  # (T,) i32 candidate splat count
    overflow: torch.Tensor        # () i32 tile-block pairs dropped by caps


def supertile_origins(gx: int, gy: int, device):
    """Supertile grid: (sgx, sgy, ssx (NS, 1), ssy (NS, 1))."""
    sgx = -(-gx // SUPER)
    sgy = -(-gy // SUPER)
    sid = torch.arange(sgx * sgy, dtype=torch.int64, device=device)
    return sgx, sgy, (sid % sgx)[:, None], (sid // sgx)[:, None]


def _caps(bf: BlockFrame2, cfg: RasterizerConfig, supertile_cap: int,
          tile_cap: int) -> tuple:
    """(C1, C2, bid_bits), raising ValueError for a grid or a block count
    the packed rects and keys cannot hold."""
    gx, gy = cfg.tile_dims
    B = bf.rect.shape[0]
    C1 = min(supertile_cap, B)
    C2 = min(tile_cap, C1)
    if gx > 255 or gy > 255:
        raise ValueError("packed rects assume tile grids <= 255")
    bid_bits = 32 - (C1 + 1).bit_length()
    if B > (1 << bid_bits):
        raise ValueError(f"{B} blocks exceed the {bid_bits}-bit id field")
    return C1, C2, bid_bits


def bin_blocks2_reference(bf: BlockFrame2, cfg: RasterizerConfig,
                          supertile_cap: int = 1024, tile_cap: int = 256,
                          tile_row_offset: int = 0) -> TileBins2:
    """The plain version of the bin_blocks kernel: the JAX function's
    sorts."""
    gx, gy = cfg.tile_dims
    T = gx * gy
    B = bf.rect.shape[0]
    C1, C2, bid_bits = _caps(bf, cfg, supertile_cap, tile_cap)
    dev = bf.rect.device
    sgx, sgy, ssx, ssy = supertile_origins(gx, gy, dev)
    NS = sgx * sgy

    # global pre-sort of blocks by (min, max) depth: position == depth order
    minmax = (u32(bf.min_depth) << 16) | (u32(bf.max_depth) & 0xFFFF)
    gidx = torch.sort(minmax, stable=True).indices
    r = bf.rect[gidx].to(torch.int64)                 # (B, 4), depth-ordered
    nonempty = (r[:, 2] > r[:, 0]) & (r[:, 3] > r[:, 1])

    sup_x0 = ssx * SUPER
    sup_y0 = ssy * SUPER + tile_row_offset
    covers = ((r[:, 0][None] < sup_x0 + SUPER) & (r[:, 2][None] > sup_x0)
              & (r[:, 1][None] < sup_y0 + SUPER) & (r[:, 3][None] > sup_y0)
              & nonempty[None])                       # (NS, B)

    iota = torch.arange(B, dtype=torch.int64, device=dev)
    key1 = torch.where(covers, iota[None], B)
    k1s = torch.sort(key1, dim=1, stable=True).values[:, :C1]
    cand_valid = k1s != B                             # (NS, C1)
    cpos = torch.where(cand_valid, k1s, 0)
    cand_gidx = gidx[cpos]                            # (NS, C1) block ids
    rect_sorted = r[:, 0] | (r[:, 1] << 8) | (r[:, 2] << 16) | (r[:, 3] << 24)
    bid_nv = cand_gidx | (bf.num_valid[cand_gidx].to(torch.int64) << 24)
    cand_bidnv = torch.where(cand_valid, bid_nv, U32_MAX)
    cand_rect = rect_sorted[cpos]
    cbm = u32(bf.bitmap)[gidx][cpos]
    k1m = torch.where(cand_valid, minmax[cand_gidx], U32_MAX)
    n_cover_total = covers.sum()
    n_kept_l1 = cand_valid.sum()

    cx0 = cand_rect & 0xFF
    cy0 = (cand_rect >> 8) & 0xFF
    cx1 = (cand_rect >> 16) & 0xFF
    cy1 = (cand_rect >> 24) & 0xFF

    lx = torch.arange(SUPER, dtype=torch.int64, device=dev)
    tgx = ssx[:, 0][:, None] * SUPER + lx[None]       # (NS, SUPER)
    tgy = ssy[:, 0][:, None] * SUPER + lx[None] + tile_row_offset
    txx = tgx[:, None, :].expand(NS, SUPER, SUPER).reshape(NS, SUPER * SUPER)
    tyy = tgy[:, :, None].expand(NS, SUPER, SUPER).reshape(NS, SUPER * SUPER)

    sw = torch.clamp(-(-(cx1 - cx0) // 8), min=1)[:, None, :]
    sh_ = torch.clamp(-(-(cy1 - cy0) // 4), min=1)[:, None, :]
    sbx = torch.clamp((txx[:, :, None] - cx0[:, None, :]) // sw, 0, 7)
    sby = torch.clamp((tyy[:, :, None] - cy0[:, None, :]) // sh_, 0, 3)
    bit = (cbm[:, None, :] >> (8 * sby + sbx)) & 1
    covers_t = ((cx0[:, None, :] <= txx[:, :, None])
                & (txx[:, :, None] < cx1[:, None, :])
                & (cy0[:, None, :] <= tyy[:, :, None])
                & (tyy[:, :, None] < cy1[:, None, :])
                & (bit > 0)
                & cand_valid[:, None, :])             # (NS, 64, C1)

    # L2 compaction: the block id rides the position key's low bits
    pos = torch.arange(C1, dtype=torch.int64, device=dev)[None, None]
    key2 = torch.where(covers_t, (pos << bid_bits) | cand_gidx[:, None, :],
                       C1 << bid_bits)
    k2s, order = torch.sort(key2, dim=2, stable=True)
    k2s = k2s[:, :, :C2]
    mm_s = torch.gather(k1m[:, None, :].expand_as(key2), 2,
                        order[:, :, :C2])
    hit = (k2s >> bid_bits) != C1
    tb = torch.where(hit, k2s & ((1 << bid_bits) - 1), -1).to(torch.int32)
    tmm = i32(torch.where(hit, mm_s, U32_MAX))
    nb = covers_t.sum(dim=2)                          # (NS, 64)
    ncand = torch.where(covers_t, (cand_bidnv[:, None, :] >> 24), 0).sum(dim=2)
    n_kept_l2 = torch.clamp(nb, max=C2).sum()
    nb = torch.clamp(nb, max=C2)

    def to_tiles(a):
        extra = a.shape[2:]
        a = a.reshape(sgy, sgx, SUPER, SUPER, *extra).movedim(2, 1)
        a = a.reshape(sgy * SUPER, sgx * SUPER, *extra)
        return a[:gy, :gx].reshape(T, *extra)

    return TileBins2(
        tile_blocks=to_tiles(tb),
        tile_nblocks=to_tiles(nb).to(torch.int32),
        tile_minmax=to_tiles(tmm),
        tile_candidates=to_tiles(ncand).to(torch.int32),
        overflow=((n_cover_total - n_kept_l1)
                  + (covers_t.sum() - n_kept_l2)).to(torch.int32),
    )


def _i32s(dev, *shape):
    return torch.empty(shape, dtype=torch.int32, device=dev)


def _rank_keys_cuda(key: torch.Tensor) -> torch.Tensor:
    """The kernel's stable ranking alone (csrc/bin_blocks.cu, rank_sort and
    rank_place) of (n,) int32 keys on the card: int32 indices equal to
    ``torch.sort(key, stable=True).indices``, the pre-sort of
    ``bin_blocks2_reference``. For tests and timing; ``bin_blocks2`` runs
    the ranking inside its own launch."""
    if key.dtype != torch.int32 or key.dim() != 1:
        raise ValueError(f"rank: expected (n,) int32 keys, got {key.dtype} "
                         f"{tuple(key.shape)}")
    key = key.contiguous()
    kernels.require_cuda("bin_rank", key)
    n = key.shape[0]
    lib = kernels.library("bin_blocks")
    skey, sidx, gidx = (_i32s(key.device, n) for _ in range(3))
    prefix = _i32s(key.device, lib.gs_bin_rank_prefix_words(n))
    err = lib.gs_bin_rank(
        *(t.data_ptr() for t in (key, skey, sidx, prefix, gidx)), n,
        kernels.stream_ptr(key.device))
    kernels.check(err, "bin_rank kernel launch")
    kernels.count_launch("bin_rank")
    return gidx


def _bin_blocks2_cuda(bf: BlockFrame2, cfg: RasterizerConfig,
                      supertile_cap: int = 1024, tile_cap: int = 256,
                      tile_row_offset: int = 0) -> TileBins2:
    """The kernel (csrc/bin_blocks.cu): the stable ranking of the B (min,
    max) depth keys, the L1 and L2 compactions, with no library call."""
    gx, gy = cfg.tile_dims
    B = bf.rect.shape[0]
    C1, C2, _ = _caps(bf, cfg, supertile_cap, tile_cap)
    ins = [t.contiguous() for t in (bf.rect, bf.bitmap, bf.min_depth,
                                    bf.max_depth, bf.num_valid)]
    for t in ins:
        if t.dtype != torch.int32:
            raise ValueError(f"bin_blocks: expected int32 block meta, got "
                             f"{t.dtype}")
    kernels.require_cuda("bin_blocks", *ins)
    dev = ins[0].device
    lib = kernels.library("bin_blocks")
    NS = -(-gx // SUPER) * -(-gy // SUPER)
    nchunks = -(-B // lib.gs_bin_blocks_chunk())
    T = gx * gy
    # the ranking (sorted chunks, the order), the supertile ranges, the
    # ranking's bucket prefixes, the chunk counts (then offsets) and
    # totals, each supertile's candidate positions and its candidates
    # staged once: tile mask, id, range, count
    scratch = [_i32s(dev, B) for _ in range(4)]
    scratch += [_i32s(dev, lib.gs_bin_rank_prefix_words(B)),
                _i32s(dev, nchunks, NS), _i32s(dev, NS), _i32s(dev, NS, C1),
                torch.empty((NS, C1), dtype=torch.int64, device=dev)]
    scratch += [_i32s(dev, NS, C1) for _ in range(3)]
    tb, tmm = _i32s(dev, T, C2), _i32s(dev, T, C2)
    nb, ncand, overflow = _i32s(dev, T), _i32s(dev, T), _i32s(dev)
    err = lib.gs_bin_blocks(
        *(t.data_ptr() for t in (*ins, *scratch, tb, nb, tmm, ncand,
                                 overflow)),
        B, gx, gy, C1, C2, tile_row_offset, kernels.stream_ptr(dev))
    kernels.check(err, "bin_blocks kernel launch")
    kernels.count_launch("bin_blocks")
    return TileBins2(tile_blocks=tb, tile_nblocks=nb, tile_minmax=tmm,
                     tile_candidates=ncand, overflow=overflow)


def bin_blocks2(bf: BlockFrame2, cfg: RasterizerConfig,
                supertile_cap: int = 1024, tile_cap: int = 256,
                tile_row_offset: int = 0) -> TileBins2:
    """Per-tile block lists (``bin_blocks2_reference``). CUDA tensors go to
    the kernel (csrc/bin_blocks.cu), CPU tensors to the plain version."""
    if bf.rect.device.type == "cpu":
        return bin_blocks2_reference(bf, cfg, supertile_cap, tile_cap,
                                     tile_row_offset)
    return _bin_blocks2_cuda(bf, cfg, supertile_cap, tile_cap,
                             tile_row_offset)
