"""The port's emit_and_sort and tile_boundaries against the JAX package's:
keys, values, num_pairs, num_overflow, start and end bit-equal, on random
rects, depths and valid masks, with the tier ladder and the giant path on
and off, a giant capacity below the giant count, the emission-order
overflow of a small sort buffer and the boundary quirk on and off. The
port sorts only the live pairs; the JAX package sorts every slot of its
slot matrices, dead ones carrying INVALID_KEY, so each case also holds the
masked sort bit-equal to the unmasked one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.config import INVALID_KEY
from godotgaussiansplatting_torch.ops import sort as ts
from godotgaussiansplatting_tpu.ops import sort as js



def _inputs(seed, P, gx, gy, valid_share=0.8, max_w=None, dead_tiles=False):
    """Random tile rects (some wide), depths and valid masks. Invalid splats
    have num_tiles 0 unless ``dead_tiles``: emit_and_sort takes the counts
    as given, and the projection zeroes them."""
    rng = np.random.default_rng(seed)
    max_w = max_w or gx
    x0 = rng.integers(0, gx, P)
    y0 = rng.integers(0, gy, P)
    wide = rng.random(P) < 0.3
    w = np.where(wide, rng.integers(1, max_w + 1, P), rng.integers(1, 3, P))
    h = np.where(wide, rng.integers(1, gy + 1, P), rng.integers(1, 3, P))
    x1 = np.minimum(x0 + w, gx)
    y1 = np.minimum(y0 + h, gy)
    rect = np.stack([x0, y0, x1, y1], 1).astype(np.int32)
    valid = rng.random(P) < valid_share
    area = ((x1 - x0) * (y1 - y0)).astype(np.int32)
    num_tiles = area if dead_tiles else np.where(valid, area, 0)
    depth16 = rng.integers(0, 0xFFFE, P).astype(np.uint32)
    # equal depths, so ties are decided by emission order
    depth16[rng.random(P) < 0.3] = 777
    return valid, rect, num_tiles.astype(np.int32), depth16


_JAX_PAIRS = {}


def _both(inputs, cfg_kw, capacity=None):
    """(JAX SortedPairs, (start, end)) and the port's. The JAX emission, which the quirk does not touch, is computed once per
    inputs and config."""
    valid, rect, num_tiles, depth16 = inputs
    cj = gj.RasterizerConfig(**cfg_kw)
    ct = gt.RasterizerConfig(**cfg_kw)
    memo = (tuple(np.concatenate([a.ravel().astype(np.int64)
                                  for a in inputs])),
            cj.replace(reference_boundary_quirk=True), capacity)
    if memo not in _JAX_PAIRS:
        _JAX_PAIRS[memo] = js.emit_and_sort(
            jnp.asarray(valid), jnp.asarray(rect), jnp.asarray(num_tiles),
            jnp.asarray(depth16), cj, capacity=capacity)
    pj = _JAX_PAIRS[memo]
    bj = js.tile_boundaries(pj.keys, pj.num_pairs, cj)
    pt = ts.emit_and_sort(torch.from_numpy(valid), torch.from_numpy(rect),
                          torch.from_numpy(num_tiles),
                          torch.from_numpy(depth16.astype(np.int32)), ct,
                          capacity=capacity)
    return (pj, bj), (pt, ts.tile_boundaries(pt.keys, pt.num_pairs, ct))


def _assert_equal(jax_side, port_side):
    (pj, (sj, ej)), (pt, (st, et)) = jax_side, port_side
    np.testing.assert_array_equal(np.asarray(pj.keys).astype(np.int64),
                                  pt.keys.numpy())
    np.testing.assert_array_equal(np.asarray(pj.values), pt.values.numpy())
    assert int(pj.num_pairs) == int(pt.num_pairs)
    assert int(pj.num_overflow) == int(pt.num_overflow)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())


# max_tiles_per_splat 4 on a 9x7 grid: most wide splats leave the base cap
CASES = {
    "base_cap_only": dict(exact_tiers=(), giant_splat_capacity=0),
    "tiers": dict(exact_tiers=((8, 64), (63, 64)), giant_splat_capacity=0),
    "tier_cap_below_count": dict(exact_tiers=((8, 3), (24, 2)),
                                 giant_splat_capacity=0),
    "giants": dict(exact_tiers=(), giant_splat_capacity=64),
    "tiers_and_giants": dict(exact_tiers=((8, 64), (24, 64)),
                             giant_splat_capacity=64),
    "giant_cap_below_count": dict(exact_tiers=((8, 2),),
                                  giant_splat_capacity=2),
}
TRUNCATING = ("base_cap_only", "tier_cap_below_count", "giant_cap_below_count")


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no_quirk"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emit_and_sort_bit_equal(case, quirk):
    kw = dict(width=144, height=112, max_tiles_per_splat=4,
              reference_boundary_quirk=quirk, **CASES[case])
    for seed, dead in ((0, False), (1, True)):
        inputs = _inputs(seed, 120, 9, 7, dead_tiles=dead)
        jax_side, port = _both(inputs, kw)
        _assert_equal(jax_side, port)
        if dead:   # the dead splats' tiles count as dropped
            continue
        overflow = int(port[0].num_overflow)
        if case in TRUNCATING:
            assert overflow > 0
        else:
            assert overflow == 0


@pytest.mark.parametrize("case", ["tiers_and_giants", "base_cap_only"])
def test_small_buffer_drops_in_emission_order(case):
    """A sort buffer below the pair count keeps the first pairs in emission
    order (base, tiers, giants), never the front of the sorted buffer, and
    num_pairs stays the unclamped total (ROADMAP queue 3 #3); the quirk then
    reads the last pair at the clamped index, as JAX's gather does."""
    kw = dict(width=144, height=112, max_tiles_per_splat=4,
              **CASES[case])
    inputs = _inputs(2, 120, 9, 7)
    full, _ = _both(inputs, kw)
    cap = int(full[0].num_pairs) * 2 // 3
    jax_side, port = _both(inputs, kw, capacity=cap)
    _assert_equal(jax_side, port)
    pt = port[0]
    assert pt.keys.shape == (cap,)
    assert int((pt.keys != INVALID_KEY).sum()) == cap
    assert int(pt.num_pairs) > cap


def test_overflow_drops_the_last_splats_pairs():
    """tests/test_pipeline_vs_oracle.py's emission-order case on the port:
    a buffer for half the pairs holds exactly the first half of the
    splats' pairs, equal to an emission of those splats alone."""
    cfg = gt.RasterizerConfig(width=128, height=128, max_tiles_per_splat=64,
                              reference_boundary_quirk=False)
    P, gx = 64, cfg.tile_dims[0]
    rng = np.random.default_rng(3)
    x0 = rng.integers(0, gx - 4, P)
    y0 = rng.integers(0, gx - 4, P)
    rect = torch.from_numpy(np.stack([x0, y0, x0 + 4, y0 + 4], 1)
                            .astype(np.int32))
    num_tiles = torch.full((P,), 16, dtype=torch.int32)
    depth16 = torch.from_numpy(rng.integers(0, 0xFFFE, P).astype(np.int32))
    valid = torch.ones((P,), dtype=torch.bool)
    cap = P * 16 // 2
    sp = ts.emit_and_sort(valid, rect, num_tiles, depth16, cfg, capacity=cap)
    live = sp.keys != INVALID_KEY
    assert int(live.sum()) == cap
    np.testing.assert_array_equal(np.sort(sp.values[live].numpy()),
                                  np.repeat(np.arange(P // 2), 16))
    half = ts.emit_and_sort(valid[:P // 2], rect[:P // 2],
                            num_tiles[:P // 2], depth16[:P // 2], cfg,
                            capacity=cap)
    assert torch.equal(sp.keys, half.keys)
    assert int(sp.num_pairs) == P * 16        # unclamped


def _one_splat(rect, gx, gy, depth=5):
    valid = np.array([True])
    rect = np.array([rect], np.int32)
    nt = np.array([(rect[0, 2] - rect[0, 0]) * (rect[0, 3] - rect[0, 1])],
                  np.int32)
    return valid, rect, nt, np.array([depth], np.uint32)


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no_quirk"])
@pytest.mark.parametrize("shape", ["one_pair", "last_grid_tile",
                                   "last_run_elsewhere"])
def test_boundary_quirk_edges(shape, quirk):
    """The quirk's edges: a last run on the bottom-right tile ends one pair
    short; any other last run is emptied, and so is a one-pair buffer's,
    which is never patched."""
    gx, gy = 9, 7
    if shape == "one_pair":
        inputs = _one_splat((3, 2, 4, 3), gx, gy)
    elif shape == "last_grid_tile":
        a = _one_splat((gx - 2, gy - 2, gx, gy), gx, gy)
        b = _one_splat((gx - 1, gy - 1, gx, gy), gx, gy, depth=9)
        inputs = tuple(np.concatenate([x, y]) for x, y in zip(a, b))
    else:
        inputs = _one_splat((1, 1, 4, 3), gx, gy)
    kw = dict(width=144, height=112, reference_boundary_quirk=quirk)
    jax_side, port = _both(inputs, kw)
    _assert_equal(jax_side, port)
    _, (st, et) = port
    n = int(port[0].num_pairs)
    last = int(port[0].keys[n - 1]) >> 16
    if not quirk:
        assert int(et[last] - st[last]) >= 1
    elif shape == "last_grid_tile":
        assert int(et[last]) == n - 1
    else:
        assert int(et[last] - st[last]) == 0


def _group_totals(inputs, kw):
    """(base group's pair total, [each tier's, the giants']) of an
    emission: the JAX package's grouping, in numpy."""
    valid, _, nt, _ = inputs
    max_t = kw["max_tiles_per_splat"]
    capped = np.minimum(nt, max_t).astype(np.int64)
    dense, prev = [], max_t
    groups = [(w, c, nt <= w) for w, c in kw["exact_tiers"]]
    if kw["giant_splat_capacity"]:
        groups.append((None, kw["giant_splat_capacity"], nt > -1))
    for w, cap, fits in groups:
        elig = valid & (nt > prev) & fits
        taken = elig & (np.cumsum(elig) - 1 < cap)
        capped[taken] = 0
        dense.append(int(nt[taken].sum()))
        prev = w
    return int(capped[valid].sum()), dense


@pytest.mark.parametrize("edge", ["all_culled", "below_base_total",
                                  "inside_tier"])
def test_static_emission_edges(edge):
    """The static-buffer emission at its edges, bit-equal to JAX: a view
    with every splat culled (no pair: the buffer stays INVALID_KEY and 0),
    a sort buffer below the base group's total (the tiers and giants drop
    whole) and one that cuts inside the first tier's dense rows."""
    kw = dict(width=144, height=112, max_tiles_per_splat=4,
              **CASES["tiers_and_giants"])
    inputs = _inputs(4, 160, 9, 7)
    capacity = None
    if edge == "all_culled":
        valid, rect, nt, depth16 = inputs
        inputs = (np.zeros_like(valid), rect, np.zeros_like(nt), depth16)
    base, dense = _group_totals(inputs, kw)
    if edge != "all_culled":
        assert base > 8 and dense[0] > 8, (base, dense)
        capacity = (base // 2 if edge == "below_base_total"
                    else base + dense[0] // 2)
    for quirk in (True, False):
        jax_side, port = _both(
            inputs, dict(kw, reference_boundary_quirk=quirk),
            capacity=capacity)
        _assert_equal(jax_side, port)
    pt = port[0]
    if edge == "all_culled":
        assert int(pt.num_pairs) == 0 and int(pt.num_overflow) == 0
        assert bool((pt.keys == INVALID_KEY).all())
        assert int(pt.values.abs().sum()) == 0
    else:
        assert int(pt.num_pairs) == base + sum(dense) > capacity
        assert int((pt.keys != INVALID_KEY).sum()) == capacity


# --- the write-once emission and the key-value sort, as the card runs them --

def _garbage_buffers(monkeypatch):
    """Make the emission's unwritten buffers start as seeded noise: a
    position the sort reads and the emission failed to write then shows
    in every run."""
    rng = np.random.default_rng(9)

    def buffers(k_max, dev):
        return tuple(torch.from_numpy(rng.integers(
            -2**31, 2**31, k_max + 1, dtype=np.int64).astype(np.int32))
            for _ in range(2))

    monkeypatch.setattr(ts, "_pair_buffers", buffers)


@pytest.mark.parametrize("kind", ["live", "dead_tiles", "capacity_below"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_write_once_path_bit_equal(monkeypatch, case, kind):
    """The emission's and the sort's plain versions called as the CUDA path
    calls them (buffers left unwritten, the sort reading [0, n) and the
    key's low end_bit bits) are bit-equal to JAX's emit_and_sort: with the
    dead splats' holes and with a sort buffer below the pair count."""
    kw = dict(width=144, height=112, max_tiles_per_splat=4,
              reference_boundary_quirk=True, **CASES[case])
    inputs = _inputs(5, 120, 9, 7, dead_tiles=kind == "dead_tiles")
    capacity = None
    if kind == "capacity_below":
        full, _ = _both(inputs, kw)
        capacity = int(full[0].num_pairs) * 2 // 3
    _garbage_buffers(monkeypatch)
    jax_side, port = _both(inputs, kw, capacity=capacity)
    _assert_equal(jax_side, port)
    if kind == "capacity_below":
        assert int(port[0].num_pairs) > capacity
        assert int((port[0].keys != INVALID_KEY).sum()) == capacity


# Tile counts just below, at and just above powers of two; 32767 sorts 31
# bits, 32768 and 32769 all 32.
TILE_COUNTS = (63, 64, 65, 8159, 8160, 8192, 8193, 32767, 32768, 32769)


@pytest.mark.parametrize("T", TILE_COUNTS)
def test_end_bit_keeps_holes_after_live_keys(T):
    """sort_pairs_reference at end_bit = sort_key_bits(T) equals the stable
    sort of the full u32 keys on a buffer whose holes come before its
    largest live key, (T - 1) << 16 | 0xFFFF; at a power of two one bit
    fewer would tie that key with the holes and put them first."""
    end_bit = ts.sort_key_bits(T)
    assert end_bit == min(32, 16 + len(bin(T)) - 2)
    rng = np.random.default_rng(T)
    n, k_max = 3000, 3500
    u = ((rng.integers(0, T, n) << 16) | rng.integers(0, 1 << 16, n))
    u[:40] = INVALID_KEY                      # holes, before the largest key
    u[40:80] = ((T - 1) << 16) | 0xFFFF
    u[80:400] = 777                           # ties keep emission order
    rng.shuffle(u[40:])
    junk = rng.integers(0, 2**32, k_max + 1 - n)
    keys = torch.from_numpy(np.concatenate([u, junk]) - ts.SIGN).to(
        torch.int32)
    vals = torch.from_numpy(rng.permutation(k_max + 1).astype(np.int32))
    total = torch.tensor(n, dtype=torch.int64)
    sk, sv = ts.sort_pairs_reference(keys, vals, total, k_max, end_bit)
    order = np.argsort(u, kind="stable")
    want_k = np.concatenate([u[order], np.full(k_max - n, INVALID_KEY)])
    want_v = np.concatenate([vals.numpy()[:n][order],
                             np.zeros(k_max - n, np.int32)])
    np.testing.assert_array_equal(sk.numpy(), want_k)
    np.testing.assert_array_equal(sv.numpy(), want_v)
    assert bool((sk[:n - 40] != INVALID_KEY).all())
    if end_bit < 32 and T & (T - 1) == 0:
        fewer = ts.sort_pairs_reference(keys, vals, total, k_max,
                                        end_bit - 1)[0]
        assert not torch.equal(fewer, sk)


# (gx, gy, tile size): 63, 64 and 65 tiles, and 32761 and 32768 tiles of
# one pixel (end_bit 31 and 32)
GRIDS = ((9, 7, 16), (8, 8, 16), (13, 5, 16), (181, 181, 1), (256, 128, 1))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_end_bit_emit_and_sort_matches_jax(grid):
    """emit_and_sort against JAX on grids whose tile count is near a power
    of two, with holes (dead splats' tiles) emitted before a last splat on
    the bottom-right tile at depth 0xFFFF: the largest live key."""
    gx, gy, ts_ = grid
    valid, rect, nt, depth16 = _inputs(6, 80, gx, gy, max_w=4,
                                       dead_tiles=True)
    last = _one_splat((gx - 1, gy - 1, gx, gy), gx, gy, depth=0xFFFF)
    inputs = tuple(np.concatenate([x, y])
                   for x, y in zip((valid, rect, nt, depth16), last))
    assert int(nt[~valid].sum()) > 0
    kw = dict(width=gx * ts_, height=gy * ts_, tile_size=ts_,
              max_tiles_per_splat=4, exact_tiers=(), giant_splat_capacity=0,
              reference_boundary_quirk=False)
    jax_side, port = _both(inputs, kw)
    _assert_equal(jax_side, port)
    keys = port[0].keys
    largest = int(torch.nonzero(keys == (((gx * gy - 1) << 16) | 0xFFFF))[0])
    assert largest < int(torch.nonzero(keys == INVALID_KEY)[0])
