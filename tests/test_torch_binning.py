"""The fast frame's Binning stage: the port's plain versions against the
JAX package, and a numpy model of the port's binning kernels.

``bin_blocks2_reference`` (ops/binning2.py) and ``bin_bigs_reference``
(ops/bigbin.py) must be bit-equal to the JAX package's ``bin_blocks2`` and
``bin_bigs`` on seeded block frames and big sets made with numpy, in the
cases tests/test_torch_blocks.py does not reach: the supertile cap (C1)
biting, a tile grid whose last supertile row and column are padded with
rects touching its edge, a slab's non-zero ``tile_row_offset`` (one not a
multiple of the supertile), an all-invalid big set and an all-empty brick
frame.

The numpy model repeats the algorithm of csrc/bin_l1.cuh, bin_blocks.cu
and bin_bigs.cu: each supertile's covering positions counted by chunks of
CHUNK and placed at the chunk's offset plus their rank (the first C1 kept),
then each tile's covering candidates compacted (the first C2 or OB kept),
the overflow summed over every tile of the padded supertile grid. It is
held equal to the plain versions, whose row sorts it says are stable
compactions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotgaussiansplatting_tpu as gj
import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch.ops import bigbin as bigbin_t
from godotgaussiansplatting_torch.ops import binning2 as binning_t
from godotgaussiansplatting_torch.ops import blocks2 as blocks_t
from godotgaussiansplatting_tpu.ops import bigbin as bigbin_j
from godotgaussiansplatting_tpu.ops import binning2 as binning_j
from godotgaussiansplatting_tpu.ops import blocks2 as blocks_j

from _torch_parity import np_, port_tuple

SUPER = 8
CHUNK = 512           # positions a first-level CTA (csrc/bin_l1.cuh)
PW = 16
DEAD = np.array([-1.0e4] + [0.0] * 8 + [-1.0e6, -1.0e6, 0.0, 3.0e38, 0.0,
                                        0.0, 0.0], np.float32)

# name -> (width, height, tile, tile_row_offset, slab rows or None)
GRIDS = {
    "l1_cap": (512, 384, 32, 0, None),
    "padded_edges": (400, 272, 16, 0, None),          # 25 x 17 tiles
    "row_offset": (512, 640, 32, 13, 7),              # rows 13..19 of 20
    "empty": (256, 160, 16, 0, None),
}


def _cfgs(name):
    w, h, ts, off, rows = GRIDS[name]
    gy_all = -(-h // ts)
    if rows is not None:
        h = rows * ts
    kw = dict(width=w, height=h, tile_size=ts)
    return (gj.RasterizerConfig(**kw), gt.RasterizerConfig(**kw), off,
            gy_all)


def _rects(rng, n, gx, gy, wmax):
    """Rects clamped to the grid, a tenth of them touching its far edge."""
    x0 = rng.integers(0, gx + 1, n)
    y0 = rng.integers(0, gy + 1, n)
    x1 = np.minimum(x0 + rng.integers(0, wmax + 1, n), gx)
    y1 = np.minimum(y0 + rng.integers(0, wmax + 1, n), gy)
    edge = rng.random(n) < 0.1
    x1 = np.where(edge, gx, x1)
    y1 = np.where(edge, gy, y1)
    return np.stack([x0, y0, x1, y1], 1).astype(np.int32)


def block_frame(name, seed=0, B=3000):
    """A seeded BlockFrame2 (JAX dtypes) on the named grid: rects up to 6
    tiles wide in the full frame's rows, random coverage bitmaps, depth
    ranges with many ties, and a fifth of the bricks (or all, for "empty")
    empty as the brick build leaves them."""
    rng = np.random.default_rng(seed)
    cfg_j, _, _, gy_all = _cfgs(name)
    gx = cfg_j.tile_dims[0]
    rect = _rects(rng, B, gx, gy_all, 6)
    lo = rng.integers(0, 3000, B)
    hi = lo + rng.integers(0, 500, B)
    empty = (rng.random(B) < 0.2) | (name == "empty")
    return blocks_j.BlockFrame2(
        payload=jnp.zeros((B, 1), jnp.int32),
        rect=jnp.asarray(np.where(empty[:, None], 0, rect).astype(np.int32)),
        bitmap=jnp.asarray(np.where(empty, 0, rng.integers(
            0, 2**32, B, dtype=np.uint64)).astype(np.uint32)),
        min_depth=jnp.asarray(np.where(empty, 0xFFFF, lo).astype(np.uint32)),
        max_depth=jnp.asarray(np.where(empty, 0xFFFF, hi).astype(np.uint32)),
        num_valid=jnp.asarray(np.where(empty, 0, rng.integers(
            1, 129, B)).astype(np.int32)),
        num_culled_pairs=jnp.int32(0))


def big_set(name, seed=1, N=2048):
    """A seeded BigSet (JAX dtypes): lanes sorted by depth16 (ties kept),
    rects up to half the grid wide, valid lanes with empty rects at the
    edge, and depths of -0.0; for "empty" no lane is valid."""
    rng = np.random.default_rng(seed)
    cfg_j, _, _, gy_all = _cfgs(name)
    gx = cfg_j.tile_dims[0]
    valid = (rng.random(N) < 0.7) & (name != "empty")
    rect = _rects(rng, N, gx, gy_all, max(gx // 2, 2))
    at_edge = valid & (rng.random(N) < 0.03)
    rect[at_edge] = [gx, gy_all, gx, gy_all]
    depth = np.sort(rng.integers(0, 65536, N))
    table = rng.standard_normal((N, PW)).astype(np.float32)
    table[:, 12] = depth.astype(np.float32)
    table[valid & (rng.random(N) < 0.02), 12] = -0.0
    table[~valid] = DEAD
    return blocks_j.BigSet(
        table=jnp.asarray(table),
        depth16=jnp.asarray(np.where(valid, depth, 0xFFFF).astype(np.uint32)),
        rect=jnp.asarray(np.where(valid[:, None], rect, 0).astype(np.int32)),
        valid=jnp.asarray(valid), residual=jnp.int32(0))


# --- the numpy model of the kernels ------------------------------------------

def model_first_level(rect, live, sgx, sgy, C1, off):
    """The first level (count, l1_scan, l1_emit): each supertile's first
    C1 covering positions (-1 past them) and its count of covering
    positions. A rect's supertiles form the range floor(x0 / 8) ..
    floor((x1 - 1) / 8) of the grid (and so for the rows, less the
    offset)."""
    n = rect.shape[0]
    x0, y0, x1, y1 = (rect[:, i].astype(np.int64) for i in range(4))
    lx = np.maximum(x0 // SUPER, 0)
    hx = np.minimum((x1 - 1) // SUPER, sgx - 1)
    ly = np.maximum((y0 - off) // SUPER, 0)
    hy = np.minimum((y1 - 1 - off) // SUPER, sgy - 1)
    sid = np.arange(sgx * sgy)
    sx, sy = (sid % sgx)[:, None], (sid // sgx)[:, None]
    cov = (live & (lx <= hx) & (ly <= hy))[None] & (lx <= sx) & (sx <= hx) \
        & (ly <= sy) & (sy <= hy)                        # (NS, n)
    nchunks = -(-n // CHUNK)
    padded = np.zeros((sgx * sgy, nchunks * CHUNK), bool)
    padded[:, :n] = cov
    per_chunk = padded.reshape(sgx * sgy, nchunks, CHUNK)
    cnt = per_chunk.sum(2)
    before = np.cumsum(cnt, 1) - cnt
    rank = np.cumsum(per_chunk, 2) - 1
    k = (before[:, :, None] + rank).reshape(sgx * sgy, -1)[:, :n]
    cand = np.full((sgx * sgy, C1), -1, np.int64)
    s_i, p_i = np.nonzero(cov & (k < C1))
    cand[s_i, k[s_i, p_i]] = p_i
    return cand, cnt.sum(1)


def _tiles(gx, gy, sgx, sgy):
    """(supertile, tx, grid row ty, real) over every tile of every
    supertile, padded ones included."""
    for s in range(sgx * sgy):
        for ly in range(SUPER):
            for lx in range(SUPER):
                tx = (s % sgx) * SUPER + lx
                ty = (s // sgx) * SUPER + ly
                yield s, tx, ty, tx < gx and ty < gy


def model_tile_mask(rect, bm, tx0, ty0):
    """StageBricks' tile_mask: (n, 64) bools, bit 8 ly + lx where the
    candidate's rect covers tile (tx0 + lx, ty0 + ly) and its 8x4 bitmap
    bit for the tile is set, from a column and a row shift computed once
    for each of the 8 columns and rows."""
    cx0, cy0, cx1, cy1 = (rect[:, i, None] & 0xFF for i in range(4))
    sw = np.maximum(-(-(cx1 - cx0) // 8), 1)
    sh = np.maximum(-(-(cy1 - cy0) // 4), 1)
    tx, ty = tx0 + np.arange(SUPER)[None], ty0 + np.arange(SUPER)[None]
    col = np.where((cx0 <= tx) & (tx < cx1),
                   np.clip((tx - cx0) // sw, 0, 7), -1)        # (n, 8)
    row = np.where((cy0 <= ty) & (ty < cy1),
                   8 * np.clip((ty - cy0) // sh, 0, 3), -1)
    ok = (row[:, :, None] >= 0) & (col[:, None, :] >= 0)       # (n, ly, lx)
    shift = np.maximum(row[:, :, None] + col[:, None, :], 0)
    bit = (bm[:, None, None] >> shift) & 1
    return (ok & (bit > 0)).reshape(-1, SUPER * SUPER)


def model_bin_blocks(bf, gx, gy, C1, C2, off):
    """bin_blocks.cu: TileBins2 fields as numpy. Each supertile's
    candidates are staged once with their tile mask (l2_stage's
    StageBricks); a tile takes the candidates whose mask bit is set."""
    rect = np_(bf.rect).astype(np.int64)
    bm = np_(bf.bitmap).astype(np.int64) & 0xFFFFFFFF
    mind = np_(bf.min_depth).astype(np.int64) & 0xFFFFFFFF
    maxd = np_(bf.max_depth).astype(np.int64) & 0xFFFFFFFF
    nv = np_(bf.num_valid).astype(np.int64)
    mm = (mind << 16) | (maxd & 0xFFFF)
    gidx = np.argsort(mm, kind="stable")
    r = rect[gidx]
    live = (r[:, 2] > r[:, 0]) & (r[:, 3] > r[:, 1])
    sgx, sgy = -(-gx // SUPER), -(-gy // SUPER)
    cand, total = model_first_level(r, live, sgx, sgy, C1, off)
    staged = []
    for s in range(sgx * sgy):
        g = gidx[cand[s, :min(total[s], C1)]]
        staged.append((g, model_tile_mask(rect[g], bm[g], (s % sgx) * SUPER,
                                          (s // sgx) * SUPER + off)))
    T = gx * gy
    tb = np.full((T, C2), -1, np.int64)
    tmm = np.full((T, C2), -1, np.int64)
    nb = np.zeros(T, np.int64)
    ncand = np.zeros(T, np.int64)
    overflow = int(np.maximum(total - C1, 0).sum())
    for s, tx, tyg, real in _tiles(gx, gy, sgx, sgy):
        g, mask = staged[s]
        bit = SUPER * (tyg % SUPER) + tx % SUPER
        hit = g[mask[:, bit]]
        overflow += max(len(hit) - C2, 0)
        if real:
            t = tyg * gx + tx
            k = min(len(hit), C2)
            tb[t, :k] = hit[:k]
            tmm[t, :k] = mm[hit[:k]]
            nb[t] = k
            ncand[t] = ((hit | (nv[hit] << 24)) >> 24).sum()
    i32 = lambda a: a.astype(np.uint32).view(np.int32)  # noqa: E731
    return dict(tile_blocks=i32(tb), tile_nblocks=i32(nb),
                tile_minmax=i32(tmm), tile_candidates=i32(ncand),
                overflow=np.int32(overflow))


def model_bin_bigs(bigs, gx, gy, C1, OB, off):
    """bin_bigs.cu: TileBigs fields as numpy."""
    table = np_(bigs.table)
    rect = np_(bigs.rect).astype(np.int64)
    sgx, sgy = -(-gx // SUPER), -(-gy // SUPER)
    cand, total = model_first_level(rect, np_(bigs.valid), sgx, sgy, C1, off)
    T = gx * gy
    pay = np.broadcast_to(DEAD[None, :, None], (T, PW, OB)).copy()
    nbig = np.zeros(T, np.int32)
    prefix = np.zeros((T, 128), np.int32)
    overflow = int(np.maximum(total - C1, 0).sum())
    for s, tx, tyg, real in _tiles(gx, gy, sgx, sgy):
        lanes = cand[s, :min(total[s], C1)]
        r = rect[lanes]
        ty = tyg + off
        hit = lanes[(r[:, 0] < tx + 1) & (tx < r[:, 2]) & (r[:, 1] <= ty)
                    & (ty < r[:, 3])]
        overflow += max(len(hit) - OB, 0)
        if real:
            t = tyg * gx + tx
            kept = hit[:OB]
            pay[t, :, :len(kept)] = table[kept].T
            nbig[t] = len(kept)
            b = np.clip(table[kept, 12], 0.0, 65535.0).astype(np.int64) >> 9
            prefix[t] = np.cumsum(np.bincount(b, minlength=128))
    return dict(bigpay=pay, tile_nbig=nbig, overflow=np.int32(overflow),
                big_prefix=prefix)


# --- the tests ---------------------------------------------------------------

def _bits(a):
    a = np_(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_fields_equal(want, got, fields):
    for f in fields:
        np.testing.assert_array_equal(_bits(want[f]), _bits(got[f]),
                                      err_msg=f)


# (supertile_cap, tile_cap) of each case: small caps where C1 is to bite
BLOCK_CAPS = {"l1_cap": (48, 6), "padded_edges": (1024, 256),
              "row_offset": (96, 8), "empty": (1024, 256)}
BIG_CAPS = {"l1_cap": (64, 24), "padded_edges": (2048, 128),
            "row_offset": (256, 32), "empty": (2048, 128)}


@pytest.mark.parametrize("name", list(GRIDS))
def test_bins_plain_matches_jax(name):
    cfg_j, cfg_t, off, _ = _cfgs(name)
    bj = block_frame(name)
    st, tc = BLOCK_CAPS[name]
    want = jax.jit(functools.partial(
        binning_j.bin_blocks2, cfg=cfg_j, supertile_cap=st, tile_cap=tc,
        tile_row_offset=off))(bj)
    got = binning_t.bin_blocks2(port_tuple(blocks_t.BlockFrame2, bj), cfg_t,
                                supertile_cap=st, tile_cap=tc,
                                tile_row_offset=off)
    _assert_fields_equal(want._asdict(), got._asdict(), want._fields)
    gx, gy = cfg_t.tile_dims
    if name == "empty":
        assert (np_(got.tile_blocks) == -1).all()
        assert (np_(got.tile_minmax) == -1).all()
        assert not np_(got.tile_nblocks).any()
        assert not np_(got.tile_candidates).any()
        assert int(got.overflow) == 0
    else:
        assert np_(got.tile_nblocks).max() > 1
    if name == "padded_edges":
        assert gx % SUPER and gy % SUPER
        rect = np_(bj.rect)
        assert ((rect[:, 2] == gx) & (rect[:, 3] == gy)).any()
        assert np_(got.tile_nblocks).reshape(gy, gx)[-1, -1] > 0


@pytest.mark.parametrize("name", list(GRIDS))
def test_bigbins_plain_matches_jax(name):
    cfg_j, cfg_t, off, _ = _cfgs(name)
    bj = big_set(name)
    st, ob = BIG_CAPS[name]
    want = jax.jit(functools.partial(
        bigbin_j.bin_bigs, cfg=cfg_j, obig=ob, supertile_cap=st,
        tile_row_offset=off))(bj)
    got = bigbin_t.bin_bigs(port_tuple(blocks_t.BigSet, bj), cfg_t,
                            obig=ob, supertile_cap=st, tile_row_offset=off)
    _assert_fields_equal(want._asdict(), got._asdict(), want._fields)
    if name == "empty":
        np.testing.assert_array_equal(
            np_(got.bigpay), np.broadcast_to(DEAD[None, :, None],
                                             got.bigpay.shape))
        assert not np_(got.tile_nbig).any()
        assert not np_(got.big_prefix).any()
        assert int(got.overflow) == 0
    else:
        assert np_(got.tile_nbig).max() > 4


@pytest.mark.parametrize("name", list(GRIDS))
def test_caps_bite_where_asked(name):
    """The small caps of "l1_cap" and "row_offset" drop entries at both
    levels of both functions: supertile candidates past C1 (an overflow
    with the tile cap at C1, where no tile can drop any) and tile entries
    past C2 or OB (more overflow with the case's tile cap); the default
    caps of "padded_edges" drop none at the first level."""
    _, cfg_t, off, _ = _cfgs(name)
    bf = port_tuple(blocks_t.BlockFrame2, block_frame(name))
    bigs = port_tuple(blocks_t.BigSet, big_set(name))
    st, tc = BLOCK_CAPS[name]
    sb, ob = BIG_CAPS[name]
    l1 = (int(binning_t.bin_blocks2_reference(bf, cfg_t, st, st,
                                              off).overflow),
          int(bigbin_t.bin_bigs_reference(bigs, cfg_t, sb, sb,
                                          off).overflow))
    both = (int(binning_t.bin_blocks2_reference(bf, cfg_t, st, tc,
                                                off).overflow),
            int(bigbin_t.bin_bigs_reference(bigs, cfg_t, ob, sb,
                                            off).overflow))
    if name in ("l1_cap", "row_offset"):
        assert 0 < l1[0] < both[0] and 0 < l1[1] < both[1], (l1, both)
    else:
        assert l1 == (0, 0), l1


@pytest.mark.parametrize("caps", ["case", "defaults"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_kernel_model_matches_plain_bins(name, caps):
    _, cfg_t, off, _ = _cfgs(name)
    bf = port_tuple(blocks_t.BlockFrame2, block_frame(name, seed=2))
    st, tc = BLOCK_CAPS[name] if caps == "case" else (1024, 256)
    B = bf.rect.shape[0]
    C1 = min(st, B)
    got = binning_t.bin_blocks2_reference(bf, cfg_t, st, tc, off)
    want = model_bin_blocks(bf, *cfg_t.tile_dims, C1, min(tc, C1), off)
    _assert_fields_equal(want, got._asdict(), got._fields)


@pytest.mark.parametrize("caps", ["case", "defaults"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_kernel_model_matches_plain_bigbins(name, caps):
    _, cfg_t, off, _ = _cfgs(name)
    bigs = port_tuple(blocks_t.BigSet, big_set(name, seed=3))
    st, ob = BIG_CAPS[name] if caps == "case" else (2048, 128)
    C1 = min(st, bigs.table.shape[0])
    got = bigbin_t.bin_bigs_reference(bigs, cfg_t, ob, st, off)
    want = model_bin_bigs(bigs, *cfg_t.tile_dims, C1, min(ob, C1), off)
    _assert_fields_equal(want, got._asdict(), got._fields)


def test_block_id_field_overflow_raises_on_every_path():
    """More blocks than the L2 key's id field holds raise ValueError
    before any dispatch, as in the JAX package's assertion."""
    _, cfg_t, _, _ = _cfgs("empty")
    B = 1 << 16        # C1 = B: a 15-bit id field
    bf = blocks_t.BlockFrame2(
        payload=torch.zeros((1,)), rect=torch.zeros((B, 4), dtype=torch.int32),
        bitmap=torch.zeros(B, dtype=torch.int32),
        min_depth=torch.zeros(B, dtype=torch.int32),
        max_depth=torch.zeros(B, dtype=torch.int32),
        num_valid=torch.zeros(B, dtype=torch.int32),
        num_culled_pairs=torch.zeros((), dtype=torch.int32))
    for fn in (binning_t.bin_blocks2, binning_t._bin_blocks2_cuda):
        with pytest.raises(ValueError, match="id field"):
            fn(bf, cfg_t, supertile_cap=B)
