"""The Binning kernels' new steps, as numpy models held to what they
replace.

``model_rank`` repeats csrc/bin_blocks.cu's stable ranking of the int32
depth keys: ``rank_sort`` sorts each chunk of RANK_CHUNK (key, index) pairs
with the kernel's bitonic network (its compare-and-keep rule, stage by
stage) and writes its bucket prefix, and ``rank_place`` gives each key its
rank in its chunk plus, for each other chunk, the count of keys <= it (a
chunk before) or < it (after): that chunk's keys of lower buckets, then a
binary lifting over its run of the key's bucket. It must equal ``np.argsort(kind=
"stable")``, the plain version's pre-sort (``torch.sort(stable=True)`` of
``bin_blocks2_reference``'s u32 keys) and the JAX package's ``lax.sort``,
at B = 0, 1, a chunk less one, a chunk, a chunk and one, several chunks,
with heavy ties and the extreme keys.

``model_scan_emit`` repeats csrc/bin_l1.cuh's first level: the (chunk,
supertile) counts, chunk-major, their prefix over the chunks computed once
(l1_scan), and l1_emit's placing of a chunk's covering positions at that
offset plus the warps' ballot counts, in batches of 32 supertiles. It must
equal ``model_first_level``'s candidates, and its first-level overflow
``max(total - C1, 0)``, with the C1 cap biting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godotgaussiansplatting_torch.ops import binning2 as binning_t
from godotgaussiansplatting_torch.ops import blocks2 as blocks_t

from _torch_parity import np_, port_tuple
from test_torch_binning import (SUPER, _cfgs, big_set, block_frame,
                                model_first_level)

RANK_CHUNK = 1024     # keys a rank_sort CTA (csrc/bin_blocks.cu)
CHUNK = 512           # positions an l1_count / l1_emit CTA (bin_l1.cuh)
WARPS = CHUNK // 32
U64_PAD = np.uint64(2**64 - 1)


# --- the ranking -------------------------------------------------------------

def model_rank_sort(keys):
    """rank_sort: each chunk's u64 ((key ^ 2^31) << 32 | index), padded with
    ~0, through the bitonic network one element a thread: thread t keeps
    the smaller of itself and t ^ j where (t & k == 0) == (t & j == 0), the
    larger otherwise. Returns the sorted keys and indices, chunk by chunk."""
    n = keys.shape[0]
    t = np.arange(RANK_CHUNK)
    skey = np.empty(n, np.int32)
    sidx = np.empty(n, np.int32)
    for base in range(0, n, RANK_CHUNK):
        m = min(RANK_CHUNK, n - base)
        v = np.full(RANK_CHUNK, U64_PAD, np.uint64)
        u = (keys[base:base + m].view(np.uint32) ^ np.uint32(0x80000000))
        v[:m] = (u.astype(np.uint64) << np.uint64(32)) | np.arange(
            base, base + m, dtype=np.uint64)
        k = 2
        while k <= RANK_CHUNK:
            j = k >> 1
            while j > 0:
                o = v[t ^ j]
                keep_min = ((t & k) == 0) == ((t & j) == 0)
                v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
                j >>= 1
            k <<= 1
        hi = (v[:m] >> np.uint64(32)).astype(np.uint32) ^ np.uint32(
            0x80000000)
        skey[base:base + m] = hi.view(np.int32)
        sidx[base:base + m] = (v[:m] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return skey, sidx


BUCKET_BITS = 11     # a chunk's bucket prefix (csrc/bin_blocks.cu)


def bucket_prefix(skey):
    """rank_sort's bucket prefix of a sorted chunk: pre[b] counts its keys
    whose top BUCKET_BITS bits (of key ^ 2^31) are below b, found by
    binary lifting over the chunk for each bucket."""
    u = skey.view(np.uint32) ^ np.uint32(0x80000000)
    pre = np.empty((1 << BUCKET_BITS) + 1, np.int64)
    for b in range(1 << BUCKET_BITS):
        lim = b << (32 - BUCKET_BITS)
        c, step = 0, RANK_CHUNK
        while step > 0:
            if c + step <= len(u) and u[c + step - 1] < lim:
                c += step
            step >>= 1
        pre[b] = c
    pre[-1] = len(u)
    return pre


def count_below(a, pre, k, le):
    """rank_place's count of a sorted chunk's keys <= k (le) or < k: the
    keys of lower buckets (the prefix), then binary lifting over the run of
    k's bucket, from its length's highest power of two."""
    b = int((np.int64(k) & 0xFFFFFFFF) ^ 0x80000000) >> (32 - BUCKET_BITS)
    lo, m = int(pre[b]), int(pre[b + 1] - pre[b])
    run = a[lo:lo + m]
    c, step = 0, (1 << (m.bit_length() - 1)) if m else 0
    while step > 0:
        if c + step <= m:
            x = run[c + step - 1]
            if x < k or (le and x == k):
                c += step
        step >>= 1
    return lo + c


def model_rank(keys):
    """rank_sort then rank_place: gidx[position] = index."""
    n = keys.shape[0]
    skey, sidx = model_rank_sort(keys)
    chunks = [skey[c:c + RANK_CHUNK] for c in range(0, n, RANK_CHUNK)]
    pres = [bucket_prefix(a) for a in chunks]
    gidx = np.full(n, -1, np.int64)
    for e in range(n):
        own = e // RANK_CHUNK
        pos = e % RANK_CHUNK + sum(
            count_below(a, pre, skey[e], ch < own)
            for ch, (a, pre) in enumerate(zip(chunks, pres)) if ch != own)
        assert gidx[pos] == -1, "two keys placed at one position"
        gidx[pos] = sidx[e]
    return gidx


def depth_meta(kind, B, seed):
    """(min16, max16) of B blocks: random, heavy ties (a few min16 values,
    few max16 values) or the extremes (min16 0xFFFF or 0, max16 0 or
    0xFFFF)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        lo = rng.integers(0, 65536, B)
        hi = rng.integers(0, 65536, B)
    elif kind == "ties":
        lo = rng.choice([3, 700, 701, 40000], B)
        hi = rng.choice([0, 5, 9], B)
    else:
        lo = rng.choice([0, 1, 0xFFFE, 0xFFFF], B)
        hi = rng.choice([0, 0xFFFF], B)
    return lo.astype(np.int32), hi.astype(np.int32)


def kernel_keys(lo, hi):
    """DepthKeys: (min16 << 16 | max16) ^ 2^31 as int32."""
    u = (lo.astype(np.uint32) << np.uint32(16)) | (hi.astype(np.uint32)
                                                   & np.uint32(0xFFFF))
    return (u ^ np.uint32(0x80000000)).view(np.int32)


@pytest.mark.parametrize("kind", ["random", "ties", "extreme"])
@pytest.mark.parametrize("B", [0, 1, RANK_CHUNK - 1, RANK_CHUNK,
                               RANK_CHUNK + 1, 5 * RANK_CHUNK + 17])
def test_rank_matches_stable_sorts(B, kind):
    lo, hi = depth_meta(kind, B, seed=B)
    got = model_rank(kernel_keys(lo, hi))
    u32 = (lo.astype(np.int64) << 16) | (hi.astype(np.int64) & 0xFFFF)
    np.testing.assert_array_equal(got, np.argsort(u32, kind="stable"))
    minmax = (binning_t.u32(torch.from_numpy(lo)) << 16) | (
        binning_t.u32(torch.from_numpy(hi)) & 0xFFFF)
    plain = torch.sort(minmax, stable=True).indices.numpy()
    np.testing.assert_array_equal(got, plain)
    ju = (jnp.asarray(lo.astype(np.uint32)) << 16) | (
        jnp.asarray(hi.astype(np.uint32)) & 0xFFFF)
    _, jidx = jax.lax.sort((ju, jnp.arange(B, dtype=jnp.uint32)),
                           dimension=0, num_keys=1, is_stable=True)
    np.testing.assert_array_equal(got, np.asarray(jidx))
    if kind != "random" and B > RANK_CHUNK:
        # ties cross the chunks: the "<=" before and "<" after decide them
        assert len(np.unique(u32)) <= 16


def test_rank_of_the_kernels_int32_keys_on_block_frames():
    """On a test block frame (many equal keys from empty bricks): the
    kernel's keys, as the wrapper takes them, ranked by the model equal the
    plain version's pre-sort."""
    bf = port_tuple(blocks_t.BlockFrame2, block_frame("l1_cap", B=2500))
    lo, hi = np_(bf.min_depth), np_(bf.max_depth)
    minmax = (binning_t.u32(bf.min_depth) << 16) | (
        binning_t.u32(bf.max_depth) & 0xFFFF)
    np.testing.assert_array_equal(
        model_rank(kernel_keys(lo, hi)),
        torch.sort(minmax, stable=True).indices.numpy())


# --- the first level ---------------------------------------------------------

def model_scan_emit(rect, live, sgx, sgy, C1, off):
    """l1_count / rank_place's counts, l1_scan and l1_emit: (cand (NS, C1),
    -1 past the kept ones, total (NS,), the first level's overflow)."""
    n = rect.shape[0]
    NS = sgx * sgy
    x0, y0, x1, y1 = (rect[:, i].astype(np.int64) for i in range(4))
    lx = np.maximum(x0 // SUPER, 0)
    hx = np.minimum((x1 - 1) // SUPER, sgx - 1)
    ly = np.maximum((y0 - off) // SUPER, 0)
    hy = np.minimum((y1 - 1 - off) // SUPER, sgy - 1)
    has = live & (lx <= hx) & (ly <= hy)
    nchunks = -(-n // CHUNK)
    cnt = np.zeros((nchunks, NS), np.int64)          # chunk-major
    for p in np.nonzero(has)[0]:
        for sy in range(ly[p], hy[p] + 1):
            for sx in range(lx[p], hx[p] + 1):
                cnt[p // CHUNK, sy * sgx + sx] += 1
    total = cnt.sum(0)
    offs = np.cumsum(cnt, 0) - cnt                   # l1_scan, once
    cand = np.full((NS, C1), -1, np.int64)
    for j in range(nchunks):
        p = j * CHUNK + np.arange(CHUNK)
        pp = np.minimum(p, n - 1)
        hit_p = (p < n) & has[pp]
        for sb in range(0, NS, 32):
            s = np.arange(sb, min(sb + 32, NS))
            if not (offs[j, s] < C1).any():
                continue
            sx, sy = s % sgx, s // sgx
            hit = (hit_p[:, None] & (lx[pp][:, None] <= sx)
                   & (sx <= hx[pp][:, None]) & (ly[pp][:, None] <= sy)
                   & (sy <= hy[pp][:, None]))        # (CHUNK, batch)
            by_warp = hit.reshape(WARPS, 32, -1)     # the warps' ballots
            before = np.cumsum(by_warp.sum(1), 0) - by_warp.sum(1)
            for w in range(WARPS):
                # each slot's first k and its kept hits, then the warp's
                # pairs, slot by slot, each slot's in lane order
                k0 = offs[j, s] + before[w]
                kept = np.clip(C1 - k0, 0, by_warp[w].sum(0))
                pairs = [(i, lane) for i in range(len(s))
                         for lane in np.nonzero(by_warp[w, :, i])[0][
                             :kept[i]]]
                for q, (i, lane) in enumerate(pairs):
                    first = sum(kept[:i])
                    k = k0[i] + q - first
                    assert k < C1 and cand[s[i], k] == -1
                    cand[s[i], k] = p[w * 32 + lane]
    return cand, total, int(np.maximum(total - C1, 0).sum())


@pytest.mark.parametrize("what,C1", [("blocks", 48), ("blocks", 1024),
                                     ("bigs", 64), ("bigs", 2048)])
@pytest.mark.parametrize("name", ["l1_cap", "row_offset", "padded_edges"])
def test_first_level_offsets_once(name, what, C1):
    _, cfg_t, off, _ = _cfgs(name)
    gx, gy = cfg_t.tile_dims
    sgx, sgy = -(-gx // SUPER), -(-gy // SUPER)
    if what == "blocks":
        bf = port_tuple(blocks_t.BlockFrame2, block_frame(name, seed=4,
                                                          B=2300))
        rect = np_(bf.rect)
        live = (rect[:, 2] > rect[:, 0]) & (rect[:, 3] > rect[:, 1])
    else:
        bigs = port_tuple(blocks_t.BigSet, big_set(name, seed=5, N=1500))
        rect, live = np_(bigs.rect), np_(bigs.valid)
    C1 = min(C1, rect.shape[0])
    want, want_total = model_first_level(rect, live, sgx, sgy, C1, off)
    got, total, over = model_scan_emit(rect, live, sgx, sgy, C1, off)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(total, want_total)
    assert over == int(np.maximum(want_total - C1, 0).sum())
    if C1 < 100 and name != "padded_edges":
        assert over > 0          # the cap bites
