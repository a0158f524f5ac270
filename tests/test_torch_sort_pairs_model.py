"""The exact path's sort: a numpy model of the sort_pairs kernels' algorithm
(csrc/sort_pairs.cu), held to the plain version (``sort.sort_pairs_reference``)
and to the JAX package's sort, ``jax.lax.sort_key_val(..., is_stable=True)``
(godotgaussiansplatting_tpu/ops/sort.py:187), of the same buffer.

The model repeats the kernels' steps: the low end_bit bits of the u32 key
split evenly over ceil(end_bit / 8) digits, the wider ones first (8 + 7 +
7 + 7 at end_bit 29); one histogram of every pass's digits; then each pass
over tiles of 4096 pairs in order, a tile's pair of digit d placed at the
pass's start of d, plus the count of d in the tiles before it (the
decoupled look-back, over the digits the pass has), plus its rank among
the tile's pairs of d (warp w of 8 holding pairs [512 w, 512 w + 512), 32
a step); the last pass widens the keys; the tail [n, k_max) is (INVALID_KEY,
0). Everything is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godotgaussiansplatting_torch.ops import sort as so

TILE, BITS = 4096, 8
INVALID = 0xFFFFFFFF


def digit_bits(end_bit: int):
    """[(shift, width)] of each pass: end_bit split evenly over ceil(end_bit
    / 8) digits, the wider ones first."""
    passes = -(-end_bit // BITS)
    w, wide = divmod(end_bit, passes)
    out, shift = [], 0
    for p in range(passes):
        width = w + (p < wide)
        out.append((shift, width))
        shift += width
    return out


def onesweep_pass(keys, vals, shift: int, width: int, hist):
    """One pass: every tile's pairs scattered by digit, stably."""
    d = ((keys >> np.uint64(shift)) & np.uint64((1 << width) - 1)).astype(
        np.int64)
    base = np.concatenate([[0], np.cumsum(hist)[:-1]])
    before = np.zeros(1 << BITS, dtype=np.int64)      # the look-back's sum
    dest = np.empty(keys.size, dtype=np.int64)
    for t0 in range(0, keys.size, TILE):
        td = d[t0:t0 + TILE]
        seen = np.zeros(1 << BITS, dtype=np.int64)
        for w0 in range(0, td.size, 512):               # warps in order
            for j0 in range(w0, min(w0 + 512, td.size), 32):   # steps
                for e in range(j0, min(j0 + 32, td.size)):      # lanes
                    dest[t0 + e] = base[td[e]] + before[td[e]] + seen[td[e]]
                    seen[td[e]] += 1
        before += seen
    assert np.all(before[1 << width:] == 0)   # no key past the width
    out_k, out_v = np.empty_like(keys), np.empty_like(vals)
    out_k[dest], out_v[dest] = keys, vals
    return out_k, out_v


def model_sort(keys_i32, vals, total: int, k_max: int, end_bit: int):
    """The kernels' (keys (k_max,) int64, values (k_max,) int32) and the
    passes' (shift, width)."""
    n = max(0, min(total, k_max))
    keys = (keys_i32[:n].astype(np.int64) + (1 << 31)).astype(np.uint64)
    v = vals[:n].copy()
    split = digit_bits(end_bit)
    hists = [np.bincount(((keys >> np.uint64(s)) & np.uint64((1 << w) - 1))
                         .astype(np.int64), minlength=1 << BITS)
             for s, w in split]
    for (shift, width), hist in zip(split, hists):
        keys, v = onesweep_pass(keys, v, shift, width, hist)
    out_k = np.full(k_max, INVALID, dtype=np.int64)
    out_v = np.zeros(k_max, dtype=np.int32)
    out_k[:n], out_v[:n] = keys.astype(np.int64), v
    return out_k, out_v, split


def _case(kind: str, T: int, k_max: int, total: int, seed: int):
    """int32 (flipped) keys and values of a (k_max + 1,) buffer whose live
    keys are ``tile << 16 | depth16`` over T tiles."""
    rng = np.random.default_rng(seed)
    size = k_max + 1
    tile = rng.integers(0, T, size)
    depth = rng.integers(0, 1 << 16, size)
    if kind == "ties":          # few tiles, few depths: mostly ties
        tile = rng.integers(0, min(T, 5), size)
        depth = rng.choice(np.array([3, 4, 40000, 0xFFFF]), size)
    if kind == "one tile":      # most pairs on one tile, many of one depth
        tile[rng.random(size) < 0.6] = T // 2
        depth[rng.random(size) < 0.3] = 1234
    u = (tile.astype(np.int64) << 16) | depth
    if kind == "holes":
        u[rng.random(size) < 0.1] = INVALID
    keys = (u - (1 << 31)).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, size).astype(np.int32)
    return keys, vals, total


CASES = {   # kind, tiles, k_max, total
    "n0": ("random", 8160, 5000, 0),
    "full": ("random", 8160, 9000, 9007),
    "holes": ("holes", 8160, 12000, 10001),
    "ties": ("ties", 8160, 10000, 10000),
    "one tile": ("one tile", 8160, 12000, 11000),
    "end_bit 31": ("random", 32400, 9000, 8500),
    "tiny grid": ("random", 1, 3000, 2900),
}


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_plain_and_jax(name):
    kind, T, k_max, total = CASES[name]
    keys, vals, total = _case(kind, T, k_max, total, seed=len(name) * 7 + T)
    end_bit = so.sort_key_bits(T)
    assert end_bit == {8160: 29, 32400: 31, 1: 17}[T]
    mk, mv, split = model_sort(keys, vals, total, k_max, end_bit)
    rk, rv = so.sort_pairs_reference(
        torch.from_numpy(keys), torch.from_numpy(vals),
        torch.tensor(total, dtype=torch.int64), k_max, end_bit)
    np.testing.assert_array_equal(mk, rk.numpy())
    np.testing.assert_array_equal(mv, rv.numpy())
    # JAX's stable sort of the whole buffer, each slot past n a hole
    n = max(0, min(total, k_max))
    live = np.arange(k_max) < n
    u = np.where(live, keys[:k_max].astype(np.int64) + (1 << 31), INVALID)
    jk, jv = jax.lax.sort_key_val(jnp.asarray(u.astype(np.uint32)),
                                  jnp.asarray(np.where(live, vals[:k_max],
                                                       0)),
                                  is_stable=True)
    np.testing.assert_array_equal(mk, np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(mv, np.asarray(jv))
    assert sum(w for _, w in split) == end_bit


@pytest.mark.parametrize("end_bit,widths", [
    (29, [8, 7, 7, 7]), (31, [8, 8, 8, 7]), (32, [8, 8, 8, 8]),
    (30, [8, 8, 7, 7]), (17, [6, 6, 5]), (24, [8, 8, 8]), (8, [8]),
    (1, [1])])
def test_digits_split_evenly(end_bit, widths):
    """The end_bit bits over ceil(end_bit / 8) passes, the wider digits
    first, each digit's bits right after the one before's."""
    split = digit_bits(end_bit)
    assert [w for _, w in split] == widths
    assert [s for s, _ in split] == list(np.cumsum([0] + widths[:-1]))
