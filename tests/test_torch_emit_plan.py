"""The exact emission's plan: a numpy model of csrc/emit_plan.cu's
arithmetic held to ``emit_plan_reference`` field by field, and the plain
version, through ``emit_and_sort``, held to the JAX package's.

The model follows the kernel: each tile of splats is summed into a vector
in the kernel's widths (A = sum of min(nt, max_t) and, for each dense
group, the count C_g of its eligible splats as int32, their nt sum E_g as
int32 but the last group's as int64; the sum of nt, N, as one int64 word
a tile, outside the scan), the vectors' exclusive prefixes (A and E int64,
C int32) give each splat's prefix, and from those the closed form gives
the offsets (A - max_t * sum_g min(cap_g, C_g)), the taken splats
(eligible and C_g < cap_g) and their slots (at C_g, off_c = E_g); the
finish writes the totals and the dead slots from the last prefix."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import sort as ts
from godotgaussiansplatting_tpu.ops import sort as js

KERNEL_TILE = ts.EMIT_PLAN_TILE      # csrc/emit_plan.cu TILE


def tile_vectors(valid, nt, max_t, ladder, tile):
    """(tiles, 2 + 2G) int64: each tile's A, N, then C_g and E_g of each
    group (a splat past P counts nothing), and the per-splat values."""
    P = nt.shape[0]
    tiles = -(-P // tile)
    pad = tiles * tile - P
    nt64 = np.concatenate([nt.astype(np.int64), np.zeros(pad, np.int64)])
    ok = np.concatenate([valid, np.zeros(pad, bool)])
    cols = [np.minimum(nt64, max_t), nt64]
    for (lo, hi, _, _) in ladder:
        elig = ok & (nt64 > lo) & (nt64 <= (hi if hi is not None else 2**31))
        cols += [elig.astype(np.int64), np.where(elig, nt64, 0)]
    per = np.stack(cols, 1).reshape(tiles, tile, len(cols))
    return per.sum(1), per


def _int32(x):
    """x as the kernel's 32-bit field: every value must fit."""
    assert np.all((x >= -2**31) & (x < 2**31)), "a 32-bit field overflows"
    return x.astype(np.int32)


def tile_sums(vec, G):
    """Each tile's sums in the kernel's widths: A (int32), C (tiles, G)
    int32, E (a list of G columns: int32 but the last group's, int64) and
    N (int64, added to one word, not scanned)."""
    A = _int32(vec[:, 0])
    C = _int32(vec[:, 2::2]).reshape(vec.shape[0], G)
    E = [_int32(vec[:, 3 + 2 * g]) if g + 1 < G else vec[:, 3 + 2 * g]
         for g in range(G)]
    return A, C, E, vec[:, 1]


def exclusive_scan(vectors):
    """The look-back's result: each tile's exclusive prefix, int64."""
    out = np.cumsum(vectors, 0, dtype=np.int64) - vectors
    return out


def tile_prefixes(A, C, E):
    """The look-back's result in its widths: each tile's exclusive prefix
    of A and each E as int64, of each C as int32 (a count below P), as one
    (tiles, 2 + 2G) int64 array in tile_vectors' layout (N left 0)."""
    G = C.shape[1]
    Ap = exclusive_scan(A.astype(np.int64))
    Cp = np.cumsum(C, 0, dtype=np.int64) - C
    Cp32 = _int32(Cp)
    out = np.zeros((A.shape[0], 2 + 2 * G), np.int64)
    out[:, 0] = Ap
    out[:, 2::2] = Cp32
    for g in range(G):
        out[:, 3 + 2 * g] = exclusive_scan(E[g].astype(np.int64))
    return out


def plan_model(valid, nt, cfg, tiers=None, tile=KERNEL_TILE):
    """The kernel's plan in numpy: a dict of EmitPlan's fields, groups as
    (idx, nt_c, off_c, pos0, width) tuples."""
    ladder = ts.emit_ladder(cfg, tiers)
    max_t = cfg.max_tiles_per_splat
    P = nt.shape[0]
    G = len(ladder)
    vec, per = tile_vectors(valid, nt, max_t, ladder, tile)
    A_t, C_t, E_t, N_t = tile_sums(vec, G)
    prefix = tile_prefixes(A_t, C_t, E_t)
    # each splat's exclusive prefix: its tile's, then the tile's own run
    run = prefix[:, None, :] + np.cumsum(per, 1) - per
    run = run.reshape(-1, per.shape[2])[:P]
    A = run[:, 0]
    C = run[:, 2::2]
    E = run[:, 3::2]
    caps = np.array([cap for (_, _, cap, _) in ladder], np.int64)
    offsets = A - max_t * np.minimum(C, caps[None, :]).sum(1) if G else A
    eligible = per.reshape(-1, per.shape[2])[:P, 2::2] == 1
    taken = eligible & (C < caps[None, :])
    capped = np.where(taken.any(1), 0, np.minimum(nt, max_t)).astype(np.int32)
    total_vec = (prefix[-1] + vec[-1]) if P else np.zeros(2 + 2 * G, np.int64)
    n_total = int(N_t.sum()) if P else 0       # the head's 64-bit word
    live = np.minimum(total_vec[2::2], caps)
    base_total = total_vec[0] - max_t * int(live.sum())
    groups, pos = [], base_total
    for g, (_, _, cap, width) in enumerate(ladder):
        idx = np.zeros(cap, np.int32)
        nt_c = np.zeros(cap, np.int32)
        off_c = np.zeros(cap, np.int64)
        ids = np.nonzero(taken[:, g])[0]
        idx[C[ids, g]] = ids
        nt_c[C[ids, g]] = nt[ids]
        off_c[C[ids, g]] = E[ids, g]
        n = int(live[g])
        if n == 0:
            gsum = 0
        elif total_vec[2 + 2 * g] <= cap:
            gsum = int(total_vec[3 + 2 * g])
        else:
            gsum = int(off_c[cap - 1]) + int(nt_c[cap - 1])
        off_c[n:] = gsum                           # the finish's dead slots
        groups.append((idx, nt_c, off_c, pos, width))
        pos += gsum
    return {"nt_capped": capped, "offsets": offsets, "base_total": base_total,
            "groups": groups, "total": pos, "overflow": n_total - pos,
            "tile_n": N_t, "tile_e": E_t}


def assert_model_matches(valid, nt, cfg, tiers=None, tile=KERNEL_TILE):
    m = plan_model(valid, nt, cfg, tiers, tile)
    r = ts.emit_plan_reference(torch.from_numpy(valid), torch.from_numpy(nt),
                               cfg, tiers)
    np.testing.assert_array_equal(m["nt_capped"], r.nt_capped.numpy())
    assert r.nt_capped.dtype == torch.int32
    np.testing.assert_array_equal(m["offsets"], r.offsets.numpy())
    assert r.offsets.dtype == torch.int64
    assert int(m["base_total"]) == int(r.base_total)
    assert int(m["total"]) == int(r.total)
    assert int(m["overflow"]) == int(r.overflow)
    assert len(m["groups"]) == len(r.groups)
    for (idx, nt_c, off_c, pos0, width), g in zip(m["groups"], r.groups):
        np.testing.assert_array_equal(idx, g.idx.numpy())
        np.testing.assert_array_equal(nt_c, g.nt_c.numpy())
        np.testing.assert_array_equal(off_c, g.off_c.numpy())
        assert (g.idx.dtype, g.nt_c.dtype, g.off_c.dtype) == (
            torch.int32, torch.int32, torch.int64)
        assert int(pos0) == int(g.pos0) and width == g.width
    return m


def _cfg(**kw):
    base = dict(width=1024, height=128, tile_size=16, max_tiles_per_splat=4,
                exact_tiers=((8, 64), (24, 32)), giant_splat_capacity=16)
    base.update(kw)
    return gt.RasterizerConfig(**base)


# nt at the base cap, at each tier width, one past each, and wide
EDGE_NT = np.array([0, 1, 3, 4, 5, 8, 9, 24, 25, 63, 64], np.int32)


def _counts(seed, P, valid_share=0.7, wide_share=0.3, dead_tiles=True,
            edges=True):
    """Seeded (valid, nt): most splats narrow, some wide, a share at the
    ladder's edges; culled splats keep their counts (holes) where
    ``dead_tiles``."""
    rng = np.random.default_rng(seed)
    nt = np.where(rng.random(P) < wide_share, rng.integers(5, 65, P),
                  rng.integers(0, 5, P)).astype(np.int32)
    if edges:
        at = rng.random(P) < 0.3
        nt[at] = rng.choice(EDGE_NT, int(at.sum()))
    valid = rng.random(P) < valid_share
    if not dead_tiles:
        nt[~valid] = 0
    return valid, nt


# (cfg kw, P, model tile): caps that bite in every group, caps never
# reached, P = 0 and 1, a P that is no multiple of the tile, no tiers, no
# giants, neither
CASES = {
    "caps_bite": (dict(exact_tiers=((8, 5), (24, 3)),
                       giant_splat_capacity=2), 3000, 64),
    "caps_never_reached": (dict(exact_tiers=((8, 100000), (24, 100000)),
                                giant_splat_capacity=100000), 3000, 64),
    "defaults_shape": ({}, 5000, 64),
    "p_zero": ({}, 0, 64),
    "p_one": ({}, 1, 64),
    "p_not_a_tile_multiple": ({}, 64 * 7 + 13, 64),
    "kernel_tile_partial": ({}, KERNEL_TILE * 2 + 1001, KERNEL_TILE),
    "no_tiers": (dict(exact_tiers=()), 2000, 64),
    "no_giants": (dict(giant_splat_capacity=0), 2000, 64),
    "no_groups": (dict(exact_tiers=(), giant_splat_capacity=0), 2000, 64),
    "tiers_below_base_cap": (dict(exact_tiers=((2, 9), (8, 64)),
                                  giant_splat_capacity=3), 2000, 64),
}


@pytest.mark.parametrize("dead_tiles", [True, False],
                         ids=["holes", "culled_zero"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_the_plain_plan(case, dead_tiles):
    kw, P, tile = CASES[case]
    valid, nt = _counts(len(case) * 7 + dead_tiles, P, dead_tiles=dead_tiles)
    m = assert_model_matches(valid, nt, _cfg(**kw), tile=tile)
    if case == "caps_bite":
        # every group has more eligible splats than slots
        assert all(int(g[1].astype(bool).sum()) == g[0].shape[0]
                   for g in m["groups"])
        assert int(m["overflow"]) > 0


@pytest.mark.parametrize("P", [1, 31, 4095, 4096, 4097])
def test_model_every_splat_culled(P):
    """No splat valid: no group takes one, every count is a hole."""
    rng = np.random.default_rng(P)
    nt = rng.choice(EDGE_NT, P).astype(np.int32)
    valid = np.zeros(P, bool)
    m = assert_model_matches(valid, nt, _cfg(), tile=KERNEL_TILE)
    assert all(not g[1].any() for g in m["groups"])
    np.testing.assert_array_equal(m["nt_capped"], np.minimum(nt, 4))


def test_model_edges_of_the_ladder():
    """nt at exactly max_t, at each tier width and one past each, all
    valid: each lands in the group whose range holds it."""
    cfg = _cfg(exact_tiers=((8, 1000), (24, 1000)), giant_splat_capacity=1000)
    nt = np.repeat(EDGE_NT, 3)
    valid = np.ones(nt.shape[0], bool)
    m = assert_model_matches(valid, nt, cfg, tile=8)
    taken = [set(nt[g[0][:int((g[1] > 0).sum())]].tolist())
             for g in m["groups"]]
    assert taken == [{5, 8}, {9, 24}, {25, 63, 64}]


def test_model_scan_keeps_int64_prefixes():
    """The scan of given per-tile vectors whose A and E sums run past 2^31
    keeps them exact (int64), as the kernel's look-back does."""
    rng = np.random.default_rng(5)
    tiles = 3000
    vec = np.stack([rng.integers(2**20, 2**21, tiles),       # A
                    rng.integers(2**21, 2**22, tiles),       # N
                    rng.integers(0, 4096, tiles),            # C_0
                    rng.integers(2**20, 2**22, tiles)], 1)   # E_0
    prefix = exclusive_scan(vec)
    want = [0, 0, 0, 0]
    for t in range(tiles):
        assert prefix[t].tolist() == want
        want = [w + int(v) for w, v in zip(want, vec[t])]
    assert want[0] > 2**31 and want[3] > 2**31
    assert prefix.dtype == np.int64


# ladders of 0 to 4 groups (the last group's E is the 64-bit one)
LADDERS = {
    "0_none": dict(exact_tiers=(), giant_splat_capacity=0),
    "1_giants": dict(exact_tiers=(), giant_splat_capacity=16),
    "1_tier": dict(exact_tiers=((8, 64),), giant_splat_capacity=0),
    "2_tier_giants": dict(exact_tiers=((8, 64),), giant_splat_capacity=16),
    "3_defaults_shape": {},
    "4_three_tiers_giants": dict(exact_tiers=((8, 64), (16, 40), (24, 32))),
    "4_four_tiers": dict(exact_tiers=((8, 64), (16, 40), (24, 32), (40, 8)),
                         giant_splat_capacity=0),
}


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_model_matches_at_every_number_of_groups(ladder):
    """Each number of groups the kernel is built for, with caps that bite,
    across two tiles and a part."""
    cfg = _cfg(**LADDERS[ladder])
    assert len(ts.emit_ladder(cfg)) == int(ladder[0])
    valid, nt = _counts(len(ladder), KERNEL_TILE * 2 + 333)
    m = assert_model_matches(valid, nt, cfg)
    assert [e.dtype for e in m["tile_e"]] == (
        [np.int32] * (len(m["groups"]) - 1) + [np.int64])[:len(m["groups"])]


# the widest tier nt whose tile sum the kernel keeps in 32 bits
HI_32 = (2**31 - 1) // KERNEL_TILE

# (cfg kw, every splat's nt): a tile's N and the giants' E past 2^31; a
# tier's E at exactly TILE * hi
WIDE = {
    "tile_n_and_giants_e_past_2_31": ({}, 2**20),
    "tier_e_at_tile_times_hi": (dict(exact_tiers=((8, 64), (HI_32, 32))),
                                HI_32),
}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_model_holds_the_widest_fields(case):
    """Every splat as wide as the case says, a few culled: the narrow
    fields stay exact in 32 bits, the wide ones pass 2^31, and the plan
    equals the plain one."""
    kw, w = WIDE[case]
    cfg = _cfg(**kw)
    ts.emit_plan_widths(ts.emit_ladder(cfg), cfg.max_tiles_per_splat)
    P = KERNEL_TILE * 3 + 100
    nt = np.full(P, w, np.int32)
    valid = np.ones(P, bool)
    valid[KERNEL_TILE + 5:KERNEL_TILE + 60] = False
    m = assert_model_matches(valid, nt, cfg)
    if case.startswith("tile_n"):
        assert m["tile_n"].max() >= 2**32
        assert m["tile_e"][-1].dtype == np.int64
        assert m["tile_e"][-1].max() >= 2**32
        assert int(m["overflow"]) > 2**31
    else:
        assert m["tile_e"][1].dtype == np.int32
        assert int(m["tile_e"][1].max()) == KERNEL_TILE * HI_32


def test_ladder_check_refuses_fields_past_32_bits():
    """The wrapper refuses a config where TILE * max_t, or TILE * hi of a
    group whose E the kernel keeps in 32 bits (every group but the last),
    reaches 2^31, before any tensor is looked at; one below passes, as does
    a last group that wide (its E is 64-bit). The plain version takes
    them all."""
    valid = torch.ones(8, dtype=torch.bool)
    nt = torch.arange(8, dtype=torch.int32) * 10
    wide = 2**31 // KERNEL_TILE
    refused = (_cfg(max_tiles_per_splat=wide, exact_tiers=()),
               _cfg(exact_tiers=((8, 64), (wide, 32))))
    passed = (_cfg(max_tiles_per_splat=wide - 1, exact_tiers=()),
              _cfg(exact_tiers=((8, 64), (wide - 1, 32))),
              _cfg(exact_tiers=((8, 64), (wide, 32)), giant_splat_capacity=0))
    for cfg in refused:
        with pytest.raises(ValueError, match="2\\^31"):
            ts._emit_plan_cuda(valid, nt, cfg)
        ts.emit_plan_reference(valid, nt, cfg)
    for cfg in passed:
        with pytest.raises(ValueError, match="CUDA"):
            ts._emit_plan_cuda(valid, nt, cfg)
        ts.emit_plan_reference(valid, nt, cfg)


def test_ladder_check_refuses_a_ladder_that_does_not_ascend():
    """The kernel's wrapper needs disjoint groups: tier widths that do not
    strictly ascend raise (before any tensor is looked at), and so do more
    groups than the kernel holds; the plain version keeps its generality."""
    valid = torch.ones(8, dtype=torch.bool)
    nt = torch.arange(8, dtype=torch.int32) * 10
    for tiers in (((24, 8), (8, 8)), ((8, 8), (8, 4))):
        cfg = _cfg(exact_tiers=tiers)
        with pytest.raises(ValueError, match="ascend"):
            ts._emit_plan_cuda(valid, nt, cfg)
        ts.emit_plan_reference(valid, nt, cfg)
    cfg = _cfg(exact_tiers=((8, 1), (16, 1), (24, 1), (32, 1)))
    with pytest.raises(ValueError, match="groups"):
        ts._emit_plan_cuda(valid, nt, cfg)
    # an ascending ladder passes the check and then wants the card
    with pytest.raises(ValueError, match="CUDA"):
        ts._emit_plan_cuda(valid, nt, _cfg())
    assert ts.emit_ladder(_cfg()) == ((4, 8, 64, 8), (8, 24, 32, 24),
                                      (24, None, 16, 512))


def test_emit_plan_dispatches_cpu_tensors_to_the_plain_version():
    valid, nt = _counts(3, 500)
    cfg = _cfg()
    a = ts.emit_plan(torch.from_numpy(valid), torch.from_numpy(nt), cfg)
    b = ts.emit_plan_reference(torch.from_numpy(valid), torch.from_numpy(nt),
                               cfg)
    for x, y in zip(a[:3] + a[4:], b[:3] + b[4:]):
        assert torch.equal(x, y)
    for ga, gb in zip(a.groups, b.groups):
        assert all(torch.equal(x, y) for x, y in zip(ga[:4], gb[:4]))


def _rects(nt, gx, seed):
    """One-row rects of nt tiles (nt <= gx), so num_tiles is each rect's
    area."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, gx - nt + 1)
    y0 = rng.integers(0, 8, nt.shape[0])
    return np.stack([x0, y0, x0 + np.maximum(nt, 0), y0 + 1], 1).astype(
        np.int32)


# (cfg kw, P): the plain plan through emit_and_sort against JAX's
JAX_CASES = {
    "caps_bite": (dict(exact_tiers=((8, 5), (24, 3)),
                       giant_splat_capacity=2), 600),
    "defaults_shape": ({}, 700),
    "no_tiers": (dict(exact_tiers=()), 300),
    "no_giants": (dict(giant_splat_capacity=0), 300),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_plain_plan_through_emit_and_sort_matches_jax(case):
    """emit_and_sort (the plain plan, base and dense groups and sort)
    bit-equal to JAX's on the edge-heavy counts, culled splats zeroed as
    the projection zeroes them."""
    kw, P = JAX_CASES[case]
    cfg_kw = dict(width=1024, height=128, tile_size=16, max_tiles_per_splat=4,
                  exact_tiers=((8, 64), (24, 32)), giant_splat_capacity=16)
    cfg_kw.update(kw)
    valid, nt = _counts(P, P, dead_tiles=False)
    gx = 1024 // 16
    rect = _rects(nt, gx, P)
    depth = np.random.default_rng(P + 1).integers(0, 0xFFFE, P)
    depth[::3] = 99                                   # ties
    pj = js.emit_and_sort(jnp.asarray(valid), jnp.asarray(rect),
                          jnp.asarray(nt), jnp.asarray(depth.astype(np.uint32)),
                          gj.RasterizerConfig(**cfg_kw))
    pt = ts.emit_and_sort(torch.from_numpy(valid), torch.from_numpy(rect),
                          torch.from_numpy(nt),
                          torch.from_numpy(depth.astype(np.int32)),
                          gt.RasterizerConfig(**cfg_kw))
    np.testing.assert_array_equal(np.asarray(pj.keys).astype(np.int64),
                                  pt.keys.numpy())
    np.testing.assert_array_equal(np.asarray(pj.values), pt.values.numpy())
    assert int(pj.num_pairs) == int(pt.num_pairs)
    assert int(pj.num_overflow) == int(pt.num_overflow)
    assert_model_matches(valid, nt, gt.RasterizerConfig(**cfg_kw), tile=64)
