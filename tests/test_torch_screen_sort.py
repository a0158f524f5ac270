"""The screen clustering's per-superblock stable row sort: a numpy model of
the screen_sort kernel's algorithm (csrc/screen_sort.cu), held to numpy's
stable argsort, to the plain version (``blocks2.screen_sort_reference``)
and to the JAX package's ``lax.sort`` of the same operands.

The model repeats the kernel's steps: a row of n <= 8192 keys padded to
8192 with 0xFFFFFFFF, warp w of 16 owning elements [512 w, 512 w + 512)
(16 a lane: element 512 w + 32 j + lane), four LSD passes of 8-bit
digits, each a digit-major and warp-minor count table, its exclusive
scan, and a scatter in which a lane's slot is its digit group's base plus
the group's lanes below it (the group found bit by bit, as the kernel's
eight ballots find it); a pass where every element holds one digit is
skipped. Everything is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godotgaussiansplatting_torch.ops import blocks2 as b2

THREADS, MAX_N, RADIX, PASSES = 512, 8192, 256, 4
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


def model_row(keys: np.ndarray, taken: np.ndarray):
    """One row's (sorted u32 keys, source positions, passes run), as the
    kernel computes them."""
    n = keys.size
    k = np.full(MAX_N, 0xFFFFFFFF, dtype=np.uint64)
    k[:n] = np.where(taken, 0xFFFFFFFF, keys.view(np.uint32))
    p = np.arange(MAX_N, dtype=np.int64)
    lanes = np.arange(32, dtype=np.uint64)
    below = (np.uint64(1) << lanes) - np.uint64(1)
    run = []
    for pss in range(PASSES):
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
    return k[:n].astype(np.uint32), p[:n], run


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
    a full row of keys below 2^16 skips the two upper passes."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2**16, MAX_N, dtype=np.int64).astype(np.int32)
    _, p, run = model_row(keys, np.zeros(MAX_N, dtype=bool))
    assert run == [0, 1]
    np.testing.assert_array_equal(p, np.argsort(keys, kind="stable"))
