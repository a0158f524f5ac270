"""Exact path, stages 2 and 3: duplicated-key emission, the stable sort and
the per-tile [start, end) ranges.

Counterpart of ``godotgaussiansplatting_tpu/ops/sort.py``, bit for bit:
the same keys, values, ``num_pairs``, ``num_overflow``, ``start`` and
``end``. Keys are u32 ``tile << 16 | depth16`` up to ``INVALID_KEY``,
returned as int64 holding the u32 value (torch has no ``>>``, ``<`` or
``searchsorted`` on u32).

The emission follows the JAX package's design, with no host read: every
pair goes to its emission position in a static ``k_max`` key and value
buffer, positions ``>= k_max`` dropped:

  * the base group: splat i's slot t at ``offsets[i] + t`` for
    ``t < min(num_tiles[i], max_tiles_per_splat)``, the t-th tile of its
    rect in row-major order, ``offsets`` the exclusive prefix of the capped
    counts (culled splats' counts reserve their positions, as in JAX: those
    positions are holes);
  * each ``exact_tiers`` tier's compacted dense rows at
    ``total + total_extra + off_c + t``;
  * the giants' dense rows after the tiers.

That is the order JAX's stable sort of its whole slot matrices gives
(dead slots carry ``INVALID_KEY`` and sort last). The emission writes the
positions ``[0, n)``, ``n = min(total, k_max)``, each once, a hole as
``INVALID_KEY``; ``sort_pairs`` then sorts those n pairs stably and writes
the output's tail ``[n, k_max)`` as ``(INVALID_KEY, 0)``, which equals one
stable sort of the whole buffer. ``emit_plan`` (the groups' counts,
offsets and compacted splats), ``emit_base``, ``emit_dense`` and
``sort_pairs`` send CUDA tensors to the kernels of csrc/emit_plan.cu,
csrc/emit_exact.cu and csrc/sort_pairs.cu and CPU tensors to their plain
versions; the emission's plain versions scatter the same matrices into a
buffer whose last slot takes the dropped pairs. The buffer holds the keys
as int32 ``key ^ 0x80000000`` (the u32 order as a signed one).

``num_pairs`` is the emitted total, not clamped to ``k_max``, as in the
JAX package (ROADMAP queue 3 #3).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..config import INVALID_KEY, RasterizerConfig

SIGN = 1 << 31     # u32 key - SIGN = the key ^ 0x80000000 as an int32


class SortedPairs(NamedTuple):
    keys: torch.Tensor         # (K_max,) int64 u32 values sorted; INVALID_KEY tail
    values: torch.Tensor       # (K_max,) i32 splat ids
    num_pairs: torch.Tensor    # () i32 emitted pair count (unclamped)
    num_overflow: torch.Tensor  # () i32 pairs dropped by the per-splat caps


def _flipped_keys(tile: torch.Tensor, depth16: torch.Tensor) -> torch.Tensor:
    """int32 ``(tile << 16 | depth16) ^ 0x80000000``: the JAX package's u32
    shift and or, wrapped to 32 bits, in the sort's signed order."""
    k = (((tile.to(torch.int64) << 16)
          | (depth16.to(torch.int64) & 0xFFFFFFFF)) & 0xFFFFFFFF)
    return (k - SIGN).to(torch.int32)


def _compact(rank: torch.Tensor, cap: int):
    """Splat ids of a group's taken splats at their rank, and the slot's
    live flag: the JAX package's ``zeros(cap).at[dest].set(ids,
    mode="drop")`` with ``dest = where(taken, rank, cap)``. The taken
    splats are the first ``cap`` eligible ones and ``rank`` (the inclusive
    count of eligible splats, less one) steps up by one at each, so slot c
    holds the first splat whose rank is c: one binary search a slot.
    Scattering every splat instead, the untaken ones onto one drop slot,
    made the Sort stage of a 1080p frame of 5.8M splats 6.03 ms on an
    H100 against 4.81 (chip_smoke.py phase 8)."""
    slots = torch.arange(cap, dtype=torch.int32, device=rank.device)
    first = torch.searchsorted(rank, slots, out_int32=True)
    alive = slots <= (rank[-1] if rank.numel() else -1)
    return torch.where(alive, first, 0), alive


def emit_base_reference(keys, vals, valid, rect, nt, offsets, depth16,
                        gx: int, max_t: int) -> None:
    """Plain version of the base emission: the (P, max_t) slot matrix,
    each of splat i's ``nt[i]`` slots scattered to its position in
    ``keys`` / ``vals`` ((k_max + 1,) int32; the last slot takes the
    dropped ones), an invalid splat's slots as holes (INVALID_KEY, 0)."""
    dev = rect.device
    k_max = keys.shape[0] - 1
    P = rect.shape[0]
    tt = torch.arange(max_t, dtype=torch.int64, device=dev)[None, :]
    pos = offsets[:, None] + tt
    written = (tt < nt[:, None]) & (pos < k_max)
    w = torch.clamp(rect[:, 2] - rect[:, 0], min=1).to(torch.int64)[:, None]
    ty = tt // w
    tx = tt - ty * w
    tile = (rect[:, 1] * gx + rect[:, 0]).to(torch.int64)[:, None] \
        + ty * gx + tx
    dest = torch.where(written, pos, k_max).reshape(-1)
    ids = torch.arange(P, dtype=torch.int32, device=dev)[:, None]
    live = valid[:, None]
    key = torch.where(live, _flipped_keys(tile, depth16[:, None]),
                      INVALID_KEY - SIGN)
    keys.scatter_(0, dest, key.reshape(-1))
    vals.scatter_(0, dest, torch.where(live, ids, 0).expand(-1, max_t)
                  .reshape(-1))


def emit_dense_reference(keys, vals, idx, nt_c, off_c, pos0, rect, depth16,
                         width: int, gx: int) -> None:
    """Plain version of one dense group: the (C, width) matrix of the
    compacted splats ``idx`` over their full row-major rects, slot t of row
    c at ``pos0 + off_c[c] + t`` for ``t < nt_c[c]`` (at most ``width``:
    a tier takes splats of at most its width, the giants' width is the
    grid's tile count)."""
    dev = rect.device
    k_max = keys.shape[0] - 1
    idx64 = idx.to(torch.int64)
    rect_c = rect[idx64]
    tt = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    pos = pos0 + off_c[:, None] + tt
    live = (tt < nt_c[:, None]) & (pos < k_max)
    w = torch.clamp(rect_c[:, 2] - rect_c[:, 0], min=1).to(torch.int64)
    ty = tt // w[:, None]
    tx = tt - ty * w[:, None]
    tile = (rect_c[:, 1] * gx + rect_c[:, 0]).to(torch.int64)[:, None] \
        + ty * gx + tx
    dest = torch.where(live, pos, k_max).reshape(-1)
    keys.scatter_(0, dest,
                  _flipped_keys(tile, depth16[idx64][:, None]).reshape(-1))
    vals.scatter_(0, dest, idx[:, None].expand(-1, width).reshape(-1))


def _check_emit(what: str, keys, vals, *tensors) -> None:
    if keys.dtype != torch.int32 or vals.dtype != torch.int32 \
            or keys.shape != vals.shape or keys.ndim != 1:
        raise ValueError(f"{what}: keys and values must be (k_max + 1,) "
                         "int32")
    kernels.require_cuda(what, keys, vals, *tensors)


def emit_base(keys, vals, valid, rect, nt, offsets, depth16, gx: int,
              max_t: int) -> None:
    """The base emission into ``keys`` / ``vals`` ((k_max + 1,) int32):
    CUDA tensors go to the kernel (csrc/emit_exact.cu, ``gs_emit_base``),
    which writes the group's positions below k_max once each, CPU tensors
    to ``emit_base_reference``. ``valid`` (P,) bool, ``rect`` (P, 4) i32,
    ``nt`` (P,) i32 capped counts, ``offsets`` (P,) int64 and ``depth16``
    (P,) i32."""
    if keys.device.type == "cpu":
        emit_base_reference(keys, vals, valid, rect, nt, offsets, depth16,
                            gx, max_t)
        return
    _emit_base_cuda(keys, vals, valid, rect, nt, offsets, depth16, gx)


def _emit_base_cuda(keys, vals, valid, rect, nt, offsets, depth16,
                    gx: int) -> None:
    P = rect.shape[0]
    if (valid.dtype != torch.bool or rect.shape != (P, 4)
            or rect.dtype != torch.int32 or nt.dtype != torch.int32
            or offsets.dtype != torch.int64 or depth16.dtype != torch.int32
            or not (valid.shape == nt.shape == offsets.shape
                    == depth16.shape == (P,))):
        raise ValueError("emit_base: unexpected input shapes/dtypes")
    _check_emit("emit_base", keys, vals, valid, rect, nt, offsets, depth16)
    dev = keys.device
    err = kernels.library("emit_exact").gs_emit_base(
        valid.data_ptr(), rect.data_ptr(), nt.data_ptr(), offsets.data_ptr(),
        depth16.data_ptr(), keys.data_ptr(), vals.data_ptr(), P, gx,
        keys.shape[0] - 1, kernels.stream_ptr(dev))
    kernels.check(err, "emit_exact base launch")
    kernels.count_launch("emit_exact")


def emit_dense(keys, vals, idx, nt_c, off_c, pos0, rect, depth16,
               width: int, gx: int) -> None:
    """One dense group into ``keys`` / ``vals``: CUDA tensors go to the
    kernel (``gs_emit_dense``), CPU tensors to ``emit_dense_reference``.
    ``idx`` (C,) i32 splat ids, ``nt_c`` (C,) i32 counts (0 for a dead
    row), ``off_c`` (C,) int64 exclusive prefix of ``nt_c``, ``pos0`` ()
    int64 the group's first position."""
    if keys.device.type == "cpu":
        emit_dense_reference(keys, vals, idx, nt_c, off_c, pos0, rect,
                             depth16, width, gx)
        return
    _emit_dense_cuda(keys, vals, idx, nt_c, off_c, pos0, rect, depth16,
                     width, gx)


def _emit_dense_cuda(keys, vals, idx, nt_c, off_c, pos0, rect, depth16,
                     width: int, gx: int) -> None:
    C = idx.shape[0]
    if (idx.dtype != torch.int32 or nt_c.dtype != torch.int32
            or off_c.dtype != torch.int64 or pos0.dtype != torch.int64
            or pos0.numel() != 1 or rect.dtype != torch.int32
            or rect.ndim != 2 or rect.shape[1] != 4
            or depth16.dtype != torch.int32
            or not (nt_c.shape == off_c.shape == (C,))):
        raise ValueError("emit_dense: unexpected input shapes/dtypes")
    _check_emit("emit_dense", keys, vals, idx, nt_c, off_c, pos0, rect,
                depth16)
    dev = keys.device
    err = kernels.library("emit_exact").gs_emit_dense(
        idx.data_ptr(), nt_c.data_ptr(), off_c.data_ptr(), pos0.data_ptr(),
        rect.data_ptr(), depth16.data_ptr(), keys.data_ptr(),
        vals.data_ptr(), C, width, gx, keys.shape[0] - 1,
        kernels.stream_ptr(dev))
    kernels.check(err, "emit_exact dense launch")
    kernels.count_launch("emit_exact")


def _pair_buffers(k_max: int, dev: torch.device) -> tuple:
    """The emission's (k_max + 1,) int32 key and value buffers, left
    unwritten: the emission writes every position the sort reads."""
    return (torch.empty((k_max + 1,), dtype=torch.int32, device=dev),
            torch.empty((k_max + 1,), dtype=torch.int32, device=dev))


class EmitGroup(NamedTuple):
    """One dense group of the plan: ``cap`` slots, the first
    ``min(eligible, cap)`` live."""
    idx: torch.Tensor      # (cap,) i32 the taken splats in splat order; 0 dead
    nt_c: torch.Tensor     # (cap,) i32 their num_tiles; 0 in a dead slot
    off_c: torch.Tensor    # (cap,) int64 exclusive prefix of nt_c
    pos0: torch.Tensor     # () int64 the group's first emission position
    width: int             # the tier's width, the giants' the grid's tiles


class EmitPlan(NamedTuple):
    """Where the emission puts each group's pairs (``emit_plan``)."""
    nt_capped: torch.Tensor   # (P,) i32 base slots; 0 for a taken splat
    offsets: torch.Tensor     # (P,) int64 their exclusive prefix
    base_total: torch.Tensor  # () int64 the base group's positions
    groups: tuple             # EmitGroup of each tier, then the giants
    total: torch.Tensor       # () int64 every group's positions
    overflow: torch.Tensor    # () int64 sum of num_tiles less total


EMIT_PLAN_MAX_GROUPS = 4    # the kernel's (csrc/emit_plan.cu MAX_GROUPS)
EMIT_PLAN_TILE = 4096       # splats a tile of its scan (TILE there)


def _tiers(cfg: RasterizerConfig, tiers) -> tuple:
    """The tier ladder: ``tiers`` (default ``cfg.exact_tiers``) less the
    tiers no wider than the base cap."""
    if tiers is None:
        tiers = getattr(cfg, "exact_tiers", ()) or ()
    return tuple((int(w), int(c)) for (w, c) in tiers
                 if w > cfg.max_tiles_per_splat)


def emit_plan_reference(proj_valid: torch.Tensor, num_tiles: torch.Tensor,
                        cfg: RasterizerConfig, tiers=None) -> EmitPlan:
    """Plain version of ``emit_plan``, the JAX package's plan in torch: a
    tier takes the valid splats wider than the tier before it (the base cap
    for the first) and at most its width, the giants those wider than the
    last tier, each the first ``cap`` of them in splat order; a taken
    splat's base count becomes 0. ``proj_valid`` (P,) bool, ``num_tiles``
    (P,) i32."""
    dev = num_tiles.device
    P = num_tiles.shape[0]
    max_t = cfg.max_tiles_per_splat

    def rank_of(mask):
        return torch.cumsum(mask, 0, dtype=torch.int32) - 1

    nt_capped = torch.clamp(num_tiles, max=max_t)
    ranked = []
    prev_w = max_t
    for (w_t, cap_t) in _tiers(cfg, tiers):
        elig = proj_valid & (num_tiles > prev_w) & (num_tiles <= w_t)
        trank = rank_of(elig)
        taken = elig & (trank < cap_t)
        nt_capped = torch.where(taken, 0, nt_capped)
        ranked.append((w_t, cap_t, trank))
        prev_w = w_t
    gcap = cfg.giant_splat_capacity
    if gcap:
        is_giant = proj_valid & (num_tiles > prev_w)
        grank = rank_of(is_giant)
        g_taken = is_giant & (grank < gcap)
        nt_capped = torch.where(g_taken, 0, nt_capped)
        ranked.append((cfg.num_tiles, gcap, grank))
    cum = torch.cumsum(nt_capped, 0, dtype=torch.int64)
    offsets = cum - nt_capped                         # exclusive prefix
    base_total = (cum[-1] if P
                  else torch.zeros((), dtype=torch.int64, device=dev))
    total = base_total
    groups = []
    for (width, cap, rank) in ranked:
        idx, alive = _compact(rank, cap)
        # no splat: nothing to gather (JAX's gather clamps into the array)
        picked = num_tiles[idx.to(torch.int64)] if P else torch.zeros_like(idx)
        nt_c = torch.where(alive, picked, 0)
        cum_c = torch.cumsum(nt_c, 0, dtype=torch.int64)
        groups.append(EmitGroup(idx, nt_c, cum_c - nt_c, total, width))
        total = total + nt_c.sum(dtype=torch.int64)
    return EmitPlan(nt_capped, offsets, base_total, tuple(groups), total,
                    num_tiles.sum(dtype=torch.int64) - total)


def emit_ladder(cfg: RasterizerConfig, tiers=None) -> tuple:
    """(lo, hi, cap, width) of each dense group, tiers then giants: a
    group is eligible for the valid splats with ``lo < num_tiles <= hi``
    (hi None: no bound). Raises ValueError unless the tiers' widths
    strictly ascend (the kernel's closed form needs disjoint groups) and
    there are at most EMIT_PLAN_MAX_GROUPS groups."""
    lo, ladder = cfg.max_tiles_per_splat, []
    for (w, cap) in _tiers(cfg, tiers):
        if w <= lo:
            raise ValueError(f"emit_plan: the tier widths must strictly "
                             f"ascend from max_tiles_per_splat, got "
                             f"{_tiers(cfg, tiers)}")
        ladder.append((lo, w, cap, w))
        lo = w
    if cfg.giant_splat_capacity:
        ladder.append((lo, None, cfg.giant_splat_capacity, cfg.num_tiles))
    if len(ladder) > EMIT_PLAN_MAX_GROUPS:
        raise ValueError(f"emit_plan: {len(ladder)} groups, the kernel "
                         f"takes at most {EMIT_PLAN_MAX_GROUPS}")
    return tuple(ladder)


def emit_plan_widths(ladder: tuple, max_t: int) -> None:
    """The kernel keeps a tile's sum of min(num_tiles, max_t) and the nt
    sum of each group but the last in 32 bits: raises ValueError unless
    EMIT_PLAN_TILE * max_t and EMIT_PLAN_TILE * hi of each such group stay
    below 2^31 (``ladder`` from ``emit_ladder``)."""
    widths = [("max_tiles_per_splat", max_t)] + [
        (f"group {g}'s width", hi) for g, (_, hi, _, _) in
        enumerate(ladder[:-1])]
    for what, w in widths:
        if EMIT_PLAN_TILE * w >= 1 << 31:
            raise ValueError(f"emit_plan: {what} {w} times the kernel's tile "
                             f"of {EMIT_PLAN_TILE} splats reaches 2^31")


def emit_plan(proj_valid: torch.Tensor, num_tiles: torch.Tensor,
              cfg: RasterizerConfig, tiers=None) -> EmitPlan:
    """The emission's plan (``EmitPlan``): CUDA tensors go to the scan
    kernel of csrc/emit_plan.cu (a memset and two launches, no host read;
    ``num_tiles`` counts, >= 0, as the projection's are), CPU tensors to
    ``emit_plan_reference``."""
    if num_tiles.device.type == "cpu":
        return emit_plan_reference(proj_valid, num_tiles, cfg, tiers)
    return _emit_plan_cuda(proj_valid, num_tiles, cfg, tiers)


def _emit_plan_cuda(proj_valid, num_tiles, cfg: RasterizerConfig,
                    tiers=None) -> EmitPlan:
    ladder = emit_ladder(cfg, tiers)
    emit_plan_widths(ladder, cfg.max_tiles_per_splat)
    P = num_tiles.shape[0]
    if (proj_valid.dtype != torch.bool or num_tiles.dtype != torch.int32
            or num_tiles.shape != (P,) or proj_valid.shape != (P,)):
        raise ValueError("emit_plan: expected (P,) bool valid and (P,) int32 "
                         "num_tiles")
    if P >= 1 << 31:
        raise ValueError(f"emit_plan: {P} splats, at most 2^31 - 1")
    kernels.require_cuda("emit_plan", proj_valid, num_tiles)
    dev = num_tiles.device
    lib = kernels.library("emit_plan")
    caps = [cap for (_, _, cap, _) in ladder]
    slots = sum(caps)

    def empty(n, dtype):
        return torch.empty((n,), dtype=dtype, device=dev)

    nt_capped, offsets = empty(P, torch.int32), empty(P, torch.int64)
    idx, nt_c = empty(slots, torch.int32), empty(slots, torch.int32)
    off_c = empty(slots, torch.int64)
    sums = empty(3 + len(ladder), torch.int64)
    scratch = empty(lib.gs_emit_plan_scratch_words(P), torch.int64)
    words = [len(ladder), cfg.max_tiles_per_splat]
    for (lo, hi, cap, _) in ladder:
        words += [lo, (1 << 31) - 1 if hi is None else hi, cap]
    host = (ctypes.c_int * len(words))(*words)
    err = lib.gs_emit_plan(
        proj_valid.data_ptr(), num_tiles.data_ptr(), nt_capped.data_ptr(),
        offsets.data_ptr(), idx.data_ptr(), nt_c.data_ptr(),
        off_c.data_ptr(), sums.data_ptr(), scratch.data_ptr(),
        ctypes.addressof(host), P, kernels.stream_ptr(dev))
    kernels.check(err, "emit_plan launch")
    kernels.count_launch("emit_plan")
    groups, s = [], 0
    for g, (_, _, cap, width) in enumerate(ladder):
        groups.append(EmitGroup(idx[s:s + cap], nt_c[s:s + cap],
                                off_c[s:s + cap], sums[3 + g], width))
        s += cap
    return EmitPlan(nt_capped, offsets, sums[0], tuple(groups), sums[1],
                    sums[2])


def emit_pairs(proj_valid: torch.Tensor, rect: torch.Tensor,
               num_tiles: torch.Tensor, depth16: torch.Tensor,
               cfg: RasterizerConfig, capacity: int | None = None,
               tiers=None, base=emit_base, dense=emit_dense) -> tuple:
    """The emission into the static buffer (see the module docstring):
    (keys, values, num_pairs, num_overflow), keys and values (k_max + 1,)
    int32 (flipped keys; positions [0, min(num_pairs, k_max)) written, the
    rest unwritten), the counts () int64.
    ``emit_plan`` places the groups; ``base`` and ``dense`` write them
    (``emit_base`` and ``emit_dense``; a comparison passes their plain
    versions). The inputs are taken as int32 and contiguous:
    the projection's are, so these conversions launch nothing on its
    outputs."""
    dev = rect.device
    P = rect.shape[0]
    gx, _ = cfg.tile_dims
    k_max = capacity if capacity is not None else cfg.sort_buffer_factor * P
    rect = rect.to(torch.int32).contiguous()
    depth16 = depth16.to(torch.int32).contiguous()
    proj_valid = proj_valid.contiguous()
    p = emit_plan(proj_valid, num_tiles.to(torch.int32).contiguous(), cfg,
                  tiers)
    keys, vals = _pair_buffers(k_max, dev)
    base(keys, vals, proj_valid, rect, p.nt_capped, p.offsets, depth16, gx,
         cfg.max_tiles_per_splat)
    for g in p.groups:
        dense(keys, vals, g.idx, g.nt_c, g.off_c, g.pos0, rect, depth16,
              g.width, gx)
    return keys, vals, p.total, p.overflow


def sort_key_bits(num_tiles: int) -> int:
    """``end_bit``: the low bits of the u32 key the sort orders,
    ``min(32, 16 + bit_length(num_tiles))``. A live key ``tile << 16 |
    depth16`` (tile below ``num_tiles``) is at most ``(num_tiles << 16) -
    1``, below ``2^end_bit - 1``, the key of a hole (``INVALID_KEY``) masked
    to those bits; so holes sort after every live pair, and the masked sort
    equals the full 32-bit one."""
    return min(32, 16 + int(num_tiles).bit_length())


def sort_pairs_reference(keys, vals, total, k_max: int, end_bit: int):
    """Plain version of ``sort_pairs``: the live pairs ``[0, n)``, ``n =
    min(total, k_max)``, of the emission's int32 buffers, each slot past
    them read as (INVALID_KEY, 0), stably sorted by the key's low
    ``end_bit`` bits with ``torch.sort``, the values gathered and the keys
    widened to int64 u32 values. Returns (keys (k_max,) int64, values
    (k_max,) int32)."""
    dev = keys.device
    live = (torch.arange(k_max, dtype=torch.int64, device=dev)
            < torch.clamp(total, max=k_max))
    u = torch.where(live, keys[:k_max].to(torch.int64) + SIGN, INVALID_KEY)
    v = torch.where(live, vals[:k_max], 0)
    masked = ((u & ((1 << end_bit) - 1)) - SIGN).to(torch.int32)
    order = torch.sort(masked, stable=True).indices
    return u.gather(0, order), v.gather(0, order)


def sort_pairs(keys, vals, total, k_max: int, end_bit: int):
    """The stable key-value sort of the emission's live pairs: CUDA tensors
    go to the radix sort of csrc/sort_pairs.cu (which reads ``total`` on
    the device and overwrites ``keys`` and ``vals``), CPU tensors to
    ``sort_pairs_reference``. ``keys`` / ``vals`` int32 of at least
    ``k_max`` slots, ``total`` () int64. Returns (keys (k_max,) int64,
    values (k_max,) int32)."""
    if keys.device.type == "cpu":
        return sort_pairs_reference(keys, vals, total, k_max, end_bit)
    return _sort_pairs_cuda(keys, vals, total, k_max, end_bit)


def _sort_pairs_cuda(keys, vals, total, k_max: int, end_bit: int):
    if (keys.dtype != torch.int32 or vals.dtype != torch.int32
            or keys.ndim != 1 or keys.shape != vals.shape
            or keys.shape[0] < k_max or total.dtype != torch.int64
            or total.numel() != 1):
        raise ValueError("sort_pairs: keys and values must be int32 of at "
                         "least k_max slots, total a () int64")
    if not (0 <= k_max < 1 << 30 and 1 <= end_bit <= 32):
        raise ValueError(f"sort_pairs: k_max {k_max} or end_bit {end_bit} "
                         "out of range")
    kernels.require_cuda("sort_pairs", keys, vals, total)
    dev = keys.device
    lib = kernels.library("sort_pairs")
    tmp = [torch.empty((k_max,), dtype=torch.int32, device=dev)
           for _ in range(2)]
    scratch = torch.empty((lib.gs_sort_pairs_scratch_words(k_max, end_bit),),
                          dtype=torch.int32, device=dev)
    out_k = torch.empty((k_max,), dtype=torch.int64, device=dev)
    out_v = torch.empty((k_max,), dtype=torch.int32, device=dev)
    err = lib.gs_sort_pairs(
        keys.data_ptr(), vals.data_ptr(), tmp[0].data_ptr(),
        tmp[1].data_ptr(), scratch.data_ptr(), total.data_ptr(),
        out_k.data_ptr(), out_v.data_ptr(), k_max, end_bit,
        kernels.stream_ptr(dev))
    kernels.check(err, "sort_pairs launch")
    kernels.count_launch("sort_pairs")
    return out_k, out_v


def emit_and_sort(proj_valid: torch.Tensor, rect: torch.Tensor,
                  num_tiles: torch.Tensor, depth16: torch.Tensor,
                  cfg: RasterizerConfig, capacity: int | None = None,
                  tiers=None) -> SortedPairs:
    """Emit ``(tile << 16 | depth16, splat id)`` pairs and sort them.

    ``proj_valid`` (P,) bool, ``rect`` (P, 4) i32 ``[x0, y0, x1, y1)``
    inside the tile grid, ``num_tiles`` (P,) i32 and ``depth16`` (P,) (the
    low 16 bits of a u32). ``tiers`` defaults to ``cfg.exact_tiers``: a
    splat wider than the base cap is compacted into the smallest tier that
    covers it and emitted densely; splats wider than the last tier go to
    the giant path."""
    keys, vals, total, overflow = emit_pairs(proj_valid, rect, num_tiles,
                                             depth16, cfg, capacity, tiers)
    skeys, svals = sort_pairs(keys, vals, total, keys.shape[0] - 1,
                              sort_key_bits(cfg.num_tiles))
    return SortedPairs(keys=skeys, values=svals,
                       num_pairs=total.to(torch.int32),
                       num_overflow=overflow.to(torch.int32))


def tile_boundaries(sorted_keys: torch.Tensor, num_pairs: torch.Tensor,
                    cfg: RasterizerConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile ``[start, end)`` over the sorted pair buffer: one binary
    search of the T + 1 tile bounds ``t << 16`` in the sorted keys (tile
    t's pairs are the keys in ``[t << 16, (t + 1) << 16)``; ``INVALID_KEY
    >> 16 = 0xFFFF`` stays at or above the tile count).

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
    bounds = torch.searchsorted(
        sorted_keys, torch.arange(T + 1, dtype=torch.int64, device=dev) << 16)
    start, end = bounds[:-1], bounds[1:]
    if cfg.reference_boundary_quirk:
        queries = torch.arange(T, dtype=torch.int64, device=dev)
        n = num_pairs.to(torch.int64)
        has_pairs = n > 0
        last = sorted_keys.index_select(
            0, torch.clamp(n - 1, 0, K - 1).reshape(1)).reshape(()) >> 16
        last_tid = torch.where(has_pairs, last, -1)
        is_grid_last = last_tid == (T - 1)
        patched_end = torch.where(is_grid_last & (n > 1), n - 1, 0)
        end = torch.where((queries == last_tid) & has_pairs, patched_end, end)
    end = torch.maximum(end, start)
    return start.to(torch.int32), end.to(torch.int32)
