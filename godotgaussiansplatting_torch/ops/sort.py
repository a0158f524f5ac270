"""Exact path, stages 2 and 3: duplicated-key emission, the stable sort and
the per-tile [start, end) ranges.

Counterpart of ``godotgaussiansplatting_tpu/ops/sort.py``, bit for bit:
the same keys, values, ``num_pairs``, ``num_overflow``, ``start`` and
``end``. Keys are u32 ``tile << 16 | depth16`` up to ``INVALID_KEY``; torch
has no ``>>``, ``<`` or ``searchsorted`` on u32, so they are carried as
int64 holding the u32 value. Pairs are emitted in the JAX package's three
groups and order: the base ``(P, max_tiles_per_splat)`` slot matrix, each
``exact_tiers`` tier's compacted dense matrix, then the giants'
``(giant_splat_capacity, num_tiles)`` matrix. Each pair is dropped or kept
by its emission position against the ``k_max`` buffer before the sort
(never by slicing the sorted buffer), and the sort is stable, so equal
(tile, depth16) keys keep emission order.

Only the live pairs are emitted, in emission order: each splat's live base
slots are a prefix of its row of the slot matrix, so they are expanded from
per-splat counts, and the dense groups are masked. At most ``k_max`` pairs
are sorted (the base matrix alone is P * 32 slots, 186M at the 5.8M scene)
and the tail is padded with ``INVALID_KEY`` and 0. Invalid keys sort last
and the live pairs' stable order is their emission order, so the buffer
equals a sort of the whole slot matrices, dead slots carrying
``INVALID_KEY``: that is what the JAX package sorts, and
``tests/test_torch_sort.py`` holds the two bit-equal.

``num_pairs`` is the emitted total, not clamped to ``k_max``, as in the
JAX package (ROADMAP queue 3 #3).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import INVALID_KEY, RasterizerConfig


class SortedPairs(NamedTuple):
    keys: torch.Tensor         # (K_max,) int64 u32 values sorted; INVALID_KEY tail
    values: torch.Tensor       # (K_max,) i32 splat ids
    num_pairs: torch.Tensor    # () i32 emitted pair count (unclamped)
    num_overflow: torch.Tensor  # () i32 pairs dropped by the per-splat caps


def _keys(tile: torch.Tensor, depth16: torch.Tensor) -> torch.Tensor:
    """u32 ``tile << 16 | depth16`` as int64 (the JAX package's uint32 shift
    and or, wrapped to 32 bits)."""
    return ((tile.to(torch.int64) << 16)
            | (depth16.to(torch.int64) & 0xFFFFFFFF)) & 0xFFFFFFFF


def _compact(taken: torch.Tensor, rank: torch.Tensor, cap: int):
    """Splat ids of the taken splats at their rank, and the slot's live flag:
    the JAX package's ``zeros(cap).at[dest].set(ids, mode="drop")`` with
    ``dest = where(taken, rank, cap)``, built from the ``dest < cap`` mask."""
    dest = torch.where(taken, rank, torch.full_like(rank, cap))
    keep = dest < cap
    idx = torch.zeros((cap,), dtype=torch.int32, device=taken.device)
    alive = torch.zeros((cap,), dtype=torch.bool, device=taken.device)
    d = dest[keep].to(torch.int64)
    idx[d] = torch.nonzero(keep)[:, 0].to(torch.int32)
    alive[d] = True
    return idx, alive


def emit_and_sort(proj_valid: torch.Tensor, rect: torch.Tensor,
                  num_tiles: torch.Tensor, depth16: torch.Tensor,
                  cfg: RasterizerConfig, capacity: int | None = None,
                  tiers=None) -> SortedPairs:
    """Emit ``(tile << 16 | depth16, splat id)`` pairs and sort them.

    ``proj_valid`` (P,) bool, ``rect`` (P, 4) i32 ``[x0, y0, x1, y1)``,
    ``num_tiles`` (P,) i32 and ``depth16`` (P,) (the low 16 bits of a u32).
    ``tiers`` defaults to ``cfg.exact_tiers``: a splat wider than the base
    cap is compacted into the smallest tier that covers it and emitted
    densely; splats wider than the last tier go to the giant path."""
    dev = rect.device
    P = rect.shape[0]
    gx, _ = cfg.tile_dims
    k_max = capacity if capacity is not None else cfg.sort_buffer_factor * P
    max_t = cfg.max_tiles_per_splat
    if tiers is None:
        tiers = getattr(cfg, "exact_tiers", ()) or ()
    tiers = tuple((int(w), int(c)) for (w, c) in tiers if w > max_t)
    rect = rect.to(torch.int32)
    num_tiles = num_tiles.to(torch.int32)

    def rank_of(mask):
        return torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1

    nt_capped = torch.clamp(num_tiles, max=max_t)
    tier_taken = []
    prev_w = max_t
    for (w_t, cap_t) in tiers:
        elig = proj_valid & (num_tiles > prev_w) & (num_tiles <= w_t)
        trank = rank_of(elig)
        taken = elig & (trank < cap_t)
        nt_capped = torch.where(taken, 0, nt_capped)
        tier_taken.append((w_t, cap_t, taken, trank))
        prev_w = w_t
    gcap = cfg.giant_splat_capacity
    if gcap:
        is_giant = proj_valid & (num_tiles > prev_w)
        grank = rank_of(is_giant)
        g_taken = is_giant & (grank < gcap)
        nt_capped = torch.where(g_taken, 0, nt_capped)
    cum = torch.cumsum(nt_capped, 0, dtype=torch.int64)
    offsets = cum - nt_capped                         # exclusive prefix
    total = cum[-1] if P else torch.zeros((), dtype=torch.int64, device=dev)

    rect_w = torch.clamp(rect[:, 2] - rect[:, 0], min=1)
    base_tile = rect[:, 1] * gx + rect[:, 0]          # top-left tile id

    # slot t of splat i is the t-th tile of its rect in row-major order;
    # its live slots are the prefix t < n_live of its row
    n_live = torch.where(
        proj_valid,
        torch.clamp(torch.minimum(nt_capped.to(torch.int64),
                                  k_max - offsets), min=0), 0)
    first = torch.cumsum(n_live, 0) - n_live
    L = int(n_live.sum()) if P else 0
    sid = torch.repeat_interleave(
        torch.arange(P, device=dev), n_live, output_size=L)
    tt = (torch.arange(L, device=dev) - first[sid]).to(torch.int32)
    w_s = rect_w[sid]
    ty = tt // w_s
    tx = tt - ty * w_s
    key_parts = [_keys(base_tile[sid] + ty * gx + tx, depth16[sid])]
    val_parts = [sid.to(torch.int32)]

    def dense_emit(idx, alive, width, pos0):
        """Compacted splat ids (C,) and their live flags -> the (C, width)
        dense emission over each splat's full row-major rect, and its pair
        count. pos0: the emission position of the group's first pair."""
        idx64 = idx.to(torch.int64)
        rect_c = rect[idx64]
        nt_c = torch.where(alive, num_tiles[idx64], 0)
        w_c = torch.clamp(rect_c[:, 2] - rect_c[:, 0], min=1)
        base_c = rect_c[:, 1] * gx + rect_c[:, 0]
        off_c = torch.cumsum(nt_c, 0, dtype=torch.int64) - nt_c
        ttc = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        tyc = ttc // w_c[:, None]
        txc = ttc - tyc * w_c[:, None]
        live_c = ((ttc < nt_c[:, None])
                  & (pos0 + off_c[:, None] + ttc < k_max))
        key_c = _keys(base_c[:, None] + tyc * gx + txc, depth16[idx64][:, None])
        key_parts.append(key_c[live_c])
        val_parts.append(idx[:, None].expand(-1, width)[live_c])
        return nt_c.to(torch.int64).sum()

    total_extra = torch.zeros((), dtype=torch.int64, device=dev)
    for (w_t, cap_t, taken, trank) in tier_taken:
        tidx, talive = _compact(taken, trank, cap_t)
        total_extra = total_extra + dense_emit(tidx, talive, w_t,
                                               total + total_extra)
    if gcap:
        gidx, galive = _compact(g_taken, grank, gcap)
        total_extra = total_extra + dense_emit(gidx, galive, cfg.num_tiles,
                                               total + total_extra)
    total = total + total_extra
    overflow = num_tiles.to(torch.int64).sum() - total

    keys = torch.cat(key_parts)
    vals = torch.cat(val_parts)
    skeys, order = torch.sort(keys, stable=True)
    svals = vals[order]
    n = skeys.shape[0]
    if n > k_max:
        skeys, svals = skeys[:k_max], svals[:k_max]
    elif n < k_max:
        skeys = torch.cat([skeys, torch.full((k_max - n,), INVALID_KEY,
                                             dtype=torch.int64, device=dev)])
        svals = torch.cat([svals, torch.zeros((k_max - n,), dtype=torch.int32,
                                              device=dev)])
    return SortedPairs(keys=skeys, values=svals.to(torch.int32),
                       num_pairs=total.to(torch.int32),
                       num_overflow=overflow.to(torch.int32))


def tile_boundaries(sorted_keys: torch.Tensor, num_pairs: torch.Tensor,
                    cfg: RasterizerConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile ``[start, end)`` over the sorted pair buffer: two binary
    searches per tile over the sorted tile ids (``INVALID_KEY >> 16 =
    0xFFFF`` stays at or above the tile count).

    With ``cfg.reference_boundary_quirk`` the reference's quirk is kept
    (gsplat_boundaries.glsl:36-49): the last run in the buffer gets no end,
    so its tile's range collapses to empty, unless it is the bottom-right
    grid tile, whose end becomes ``num_pairs - 1``; a one-pair buffer is
    never patched. The last pair is read at ``num_pairs - 1`` clamped into
    the buffer, as the JAX package's gather clamps it. Returns (start, end),
    each (T,) i32, end >= start."""
    T = cfg.num_tiles
    dev = sorted_keys.device
    K = sorted_keys.shape[0]
    tids = sorted_keys >> 16
    queries = torch.arange(T, dtype=torch.int64, device=dev)
    start = torch.searchsorted(tids, queries, side="left")
    end = torch.searchsorted(tids, queries, side="right")
    if cfg.reference_boundary_quirk:
        n = num_pairs.to(torch.int64)
        has_pairs = n > 0
        last = tids[torch.clamp(n - 1, 0, K - 1)]
        last_tid = torch.where(has_pairs, last, -1)
        is_grid_last = last_tid == (T - 1)
        patched_end = torch.where(is_grid_last & (n > 1), n - 1, 0)
        end = torch.where((queries == last_tid) & has_pairs, patched_end, end)
    end = torch.maximum(end, start)
    return start.to(torch.int32), end.to(torch.int32)
