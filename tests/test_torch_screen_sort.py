"""The screen clustering's per-superblock stable row sort: a numpy model of
the screen_sort kernel's algorithm (csrc/screen_sort.cu), held to numpy's
stable argsort, to the plain version (``blocks2.screen_sort_reference``)
and to the JAX package's ``lax.sort`` of the same operands.

The model repeats the kernel's steps: a row of n <= 8192 keys padded to
8192, a key read as dead (0xFFFFFFFF) where taken; the row narrowed to the
bits it has: its live keys' smallest lo and largest hi give b =
bit_length(hi - lo + 1) for the word key - lo, or, where fewer bits do,
the halves h = key >> 16 and d = key & 0xFFFF are narrowed apart into
(h - hl) << db | (d - dl); the row sorts its words, all ones of b bits for
a dead key or a pad, in ceil(b / 8) LSD passes of 8-bit digits; warp w of
32 owning elements [256 w, 256 w + 256) (8 a lane: element 256 w + 32 j +
lane), each pass a digit-major and warp-minor count table, its exclusive
scan, and a scatter in which a lane's slot is its digit group's base plus
the group's lanes below it (the group found bit by bit, as the kernel's
eight ballots find it); a pass where every element holds one digit is
skipped; the keys written are rebuilt from the sorted words, or
0xFFFFFFFF.
Everything is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godotgaussiansplatting_torch.ops import blocks2 as b2

THREADS, MAX_N, RADIX = 1024, 8192, 256
WARPS = THREADS // 32
SEG = MAX_N // WARPS
ITEMS = MAX_N // THREADS


def _same_digit(d):
    """(32,) digits -> (32,) masks of the lanes holding each lane's digit,
    built from one ballot a bit."""
    m = np.full(32, 0xFFFFFFFF, dtype=np.uint64)
    for b in range(8):
        bit = (d >> b) & 1
        ballot = np.uint64(int(np.sum(bit.astype(np.uint64)
                                      << np.arange(32, dtype=np.uint64))))
        m &= np.where(bit == 1, ballot, ~ballot & np.uint64(0xFFFFFFFF))
    return m


def _lowest(mask: int) -> int:
    """The lowest set lane of a mask (__ffs - 1)."""
    return (mask & -mask).bit_length() - 1


def narrow(k: np.ndarray):
    """A row's narrowing: (word, bits) with word(key) the live key's word
    and bits its width, (None, 0) where no key is live. The word is key -
    lo over bit_length(hi - lo + 1) bits, or, where fewer bits do, (h - hl)
    << db | (d - dl) with the halves h = key >> 16 and d = key & 0xFFFF
    narrowed apart, db = bit_length(dh - dl)."""
    live = k[k != 0xFFFFFFFF].astype(np.int64)
    if live.size == 0:
        return None, 0
    lo, hi = int(live.min()), int(live.max())
    whole = (hi - lo + 1).bit_length()
    h, d = live >> 16, live & 0xFFFF
    hl, dl = int(h.min()), int(d.min())
    db = (int(d.max()) - dl).bit_length()
    top = ((int(h.max()) - hl) << db) | (int(d.max()) - dl)
    halves = 32 if top == 0xFFFFFFFF else (top + 1).bit_length()
    if halves < whole:
        return (lambda x: ((x >> np.uint64(16)) - np.uint64(hl))
                << np.uint64(db) | ((x & np.uint64(0xFFFF)) - np.uint64(dl))
                ), halves
    return (lambda x: x - np.uint64(lo)), whole


def model_row(keys: np.ndarray, taken: np.ndarray):
    """One row's (sorted u32 keys, source positions, passes run), as the
    kernel computes them."""
    n = keys.size
    raw = np.full(MAX_N, 0xFFFFFFFF, dtype=np.uint64)
    raw[:n] = np.where(taken, 0xFFFFFFFF, keys.view(np.uint32))
    word, bits = narrow(raw)
    dead = np.uint64((1 << bits) - 1)
    live = raw != 0xFFFFFFFF
    k = np.full(MAX_N, dead, dtype=np.uint64)
    if word is not None:
        k[live] = word(raw[live])
    key_of = dict(zip(k[live].tolist(), raw[live].tolist()))
    p = np.arange(MAX_N, dtype=np.int64)
    lanes = np.arange(32, dtype=np.uint64)
    below = (np.uint64(1) << lanes) - np.uint64(1)
    run = []
    for pss in range((bits + 7) // 8):
        d = ((k >> np.uint64(8 * pss)) & np.uint64(0xFF)).astype(np.int64)
        table = np.zeros((RADIX, WARPS), dtype=np.int64)
        masks = {}
        for w in range(WARPS):
            for j in range(ITEMS):
                e = w * SEG + j * 32 + np.arange(32)
                m = _same_digit(d[e])
                masks[w, j] = m
                for lane in range(32):
                    leader = _lowest(int(m[lane]))
                    if lane == leader:
                        table[d[e[lane]], w] += bin(int(m[lane])).count("1")
        if np.all(d == d[0]):
            continue
        run.append(pss)
        flat = table.reshape(-1)
        table = (np.cumsum(flat) - flat).reshape(RADIX, WARPS)
        nk, npos = np.empty_like(k), np.empty_like(p)
        for w in range(WARPS):
            for j in range(ITEMS):
                e = w * SEG + j * 32 + np.arange(32)
                m = masks[w, j]
                dd = d[e]
                slot = table[dd, w]
                dst = slot + np.array([bin(int(x)).count("1")
                                       for x in (m & below)])
                nk[dst], npos[dst] = k[e], p[e]
                for lane in range(32):
                    leader = _lowest(int(m[lane]))
                    if lane == leader:
                        table[dd[lane], w] = slot[lane] + bin(
                            int(m[lane])).count("1")
        k, p = nk, npos
    out = np.array([0xFFFFFFFF if w == dead else key_of[w]
                    for w in k[:n].tolist()], dtype=np.uint64)
    return out.astype(np.uint32), p[:n], run


def _case(kind: str, SB: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "random":
        keys = rng.integers(0, 2**31, (SB, n), dtype=np.int64)
        keys[rng.random((SB, n)) < 0.2] = 0xFFFFFFFF
    elif kind == "ties":
        keys = rng.choice(np.array([5, 6, 900, 0x7FFF0000, 0xFFFFFFFF,
                                    0x80000000], dtype=np.int64),
                          size=(SB, n))
    elif kind == "invalid":
        keys = np.full((SB, n), 0xFFFFFFFF, dtype=np.int64)
    elif kind == "taken":
        keys = rng.integers(0, 2**31, (SB, n), dtype=np.int64)
    else:   # one cell: the top byte is the same in every key
        keys = (0x12 << 24) | rng.integers(0, 2**16, (SB, n),
                                           dtype=np.int64)
    keys = keys.astype(np.uint32).view(np.int32)
    share = {"taken": 1.0, "one_cell": 0.0}.get(kind, 0.05)
    taken = rng.random((SB, n)) < share
    words = [rng.integers(-2**31, 2**31, (SB, n), dtype=np.int64)
             .astype(np.int32) for _ in range(5)]
    return keys, taken, words


CASES = [("random", 2, 8192), ("random", 1, 1024), ("random", 3, 128),
         ("ties", 2, 8192), ("ties", 1, 1024), ("ties", 4, 128),
         ("invalid", 1, 8192), ("taken", 1, 8192), ("one_cell", 1, 8192)]


@pytest.mark.parametrize("kind,SB,n", CASES)
def test_model_matches_stable_sort_plain_and_jax(kind, SB, n):
    keys, taken, words = _case(kind, SB, n, seed=SB * 1000 + n)
    got = b2.screen_sort_reference(
        torch.from_numpy(keys), torch.from_numpy(taken),
        tuple(torch.from_numpy(w) for w in words))
    eff = np.where(taken, -1, keys).astype(np.int32)
    jax_keys, jax_idx = jax.lax.sort(
        (jnp.asarray(eff.view(np.uint32)),
         jnp.arange(SB * n, dtype=jnp.int32).reshape(SB, n)),
        dimension=1, num_keys=1, is_stable=True)
    jax_idx = np.asarray(jax_idx)
    for r in range(SB):
        mk, mp, run = model_row(keys[r], taken[r])
        want = np.argsort(eff[r].view(np.uint32), kind="stable")
        np.testing.assert_array_equal(mp, want)
        np.testing.assert_array_equal(mk, eff[r].view(np.uint32)[want])
        np.testing.assert_array_equal(mp + r * n, jax_idx[r])
        np.testing.assert_array_equal(
            mk.view(np.int32), np.asarray(jax_keys)[r].view(np.int32))
        # the plain version: key, five words, source position
        np.testing.assert_array_equal(got[0][r].numpy(), mk.view(np.int32))
        for w, g in zip(words, got[1:6]):
            np.testing.assert_array_equal(g[r].numpy(), w[r][mp])
        np.testing.assert_array_equal(got[6][r].numpy(), mp + r * n)
        if kind in ("invalid", "taken"):
            assert run == [] and np.all(mp == np.arange(n))
        if kind == "one_cell":   # a full row with one top byte
            assert 3 not in run


def test_model_skips_only_uniform_digits():
    """A pass runs unless every element (pads included) holds one digit:
    a full row of keys below 2^16 narrows to at most 17 bits, and the
    third pass, whose digit every live word shares, is skipped."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2**16, MAX_N, dtype=np.int64).astype(np.int32)
    _, p, run = model_row(keys, np.zeros(MAX_N, dtype=bool))
    assert run == [0, 1]
    np.testing.assert_array_equal(p, np.argsort(keys, kind="stable"))


def _narrow_row(kind: str, n: int, rng):
    """One row's keys and taken mask: no live key, one live key, every
    live key equal to its minimum, live keys whose span hi - lo is
    exactly ``2^b - 2`` or ``2^b - 1`` (kind "span b" or "span b+"), or
    keys of three cells whose depths span 8 bits ("halves")."""
    taken = rng.random(n) < 0.1
    if kind == "none":
        return rng.integers(0, 2**31, n).astype(np.int32), np.ones(n, bool)
    if kind == "one":
        keys = np.full(n, -1, dtype=np.int32)
        keys[n // 3] = 12345
        return keys, np.zeros(n, bool)
    if kind == "equal":
        keys = np.full(n, 0x00AB0CD0, dtype=np.int64)
        keys[rng.random(n) < 0.2] = 0xFFFFFFFF
        return keys.astype(np.uint32).view(np.int32), taken
    if kind == "halves":                  # a few cells, a narrow depth
        keys = (rng.choice(np.array([0x10, 0x20, 0x90]), n) << 16) \
            | rng.integers(100, 301, n)
        keys[:2] = ((0x10 << 16) | 100, (0x90 << 16) | 300)
        taken[:2] = False
        return keys.astype(np.uint32).view(np.int32), taken
    b = int(kind.split()[1].rstrip("+"))
    span = (1 << b) - (1 if kind.endswith("+") else 2)
    lo = 0x40000000 if b < 31 else 0
    keys = lo + rng.integers(0, span + 1, n)
    keys[:2] = (lo, lo + span)            # the extremes, live
    taken[:2] = False
    keys[rng.random(n) < 0.1] = 0xFFFFFFFF
    keys[1::97] = lo + span               # ties with the largest
    return keys.astype(np.uint32).view(np.int32), taken


NARROW = {"none": 0, "one": 1, "equal": 1, "span 8": 8, "span 8+": 9,
          "span 16": 16, "span 16+": 17, "span 24": 24, "span 24+": 25,
          "span 31": 31, "span 31+": 32, "halves": 16}


@pytest.mark.parametrize("kind", list(NARROW))
def test_model_narrows_each_row(kind):
    """Each row sorts over the bits its live keys span, with room for the
    dead word, its halves narrowed apart where that takes fewer: ceil(b /
    8) passes at most, bit-equal to numpy's stable argsort, the plain
    version and JAX's ``lax.sort``."""
    rng = np.random.default_rng(len(kind))
    n = 3000
    keys, taken = _narrow_row(kind, n, rng)
    eff = np.where(taken, -1, keys).astype(np.int32)
    raw = np.where(eff == -1, 0xFFFFFFFF, eff.view(np.uint32)).astype(
        np.uint64)
    assert narrow(raw)[1] == NARROW[kind]
    if kind == "halves":     # the whole keys would span 24 bits
        assert (int(raw[raw != 0xFFFFFFFF].max())
                - int(raw[raw != 0xFFFFFFFF].min()) + 1).bit_length() == 24
    mk, mp, run = model_row(keys, taken)
    assert len(run) <= (NARROW[kind] + 7) // 8
    want = np.argsort(eff.view(np.uint32), kind="stable")
    np.testing.assert_array_equal(mp, want)
    np.testing.assert_array_equal(mk, eff.view(np.uint32)[want])
    got = b2.screen_sort_reference(
        torch.from_numpy(keys[None]), torch.from_numpy(taken[None]),
        tuple(torch.from_numpy(np.arange(n, dtype=np.int32)[None] * (w + 1))
              for w in range(5)))
    jk, ji = jax.lax.sort((jnp.asarray(eff.view(np.uint32)),
                           jnp.arange(n, dtype=jnp.int32)), num_keys=1,
                          is_stable=True)
    np.testing.assert_array_equal(np.asarray(ji), mp)
    np.testing.assert_array_equal(np.asarray(jk), mk)
    np.testing.assert_array_equal(got[0][0].numpy(), mk.view(np.int32))
    np.testing.assert_array_equal(got[6][0].numpy(), mp)
