"""The Blocks stage's plain versions, as the block_frame and big_lanes
kernels (csrc/block_frame.cu, csrc/big_lanes.cu) repeat them, against the
JAX package.

  * the cooked payload's brick centres are summed in a fixed pairwise tree
    (the kernel's order) and stay within 1e-5 relative of JAX's;
  * the big-lane window's global stable sort runs on int32 keys: tk_idx
    and tk_ok are bit-equal to the int64 sort it replaced and to JAX's
    ``_select_big_lanes``, with rows of fewer than KC candidates, rows
    with none, and a capacity past the window;
  * the static bricks' ``taken`` mask, fused into the frame build's key
    read, gives the frame of ``torch.where(taken, -1, key)``;
  * an all-invalid brick and an all-invalid frame get JAX's rect, bitmap
    and depth sentinels.

Words are the port's plain fused projection on a small CPU scene, handed
to the JAX package as u32 arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import blocks2 as blocks_t
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_tpu.ops import blocks2 as blocks_j
from godotgaussiansplatting_tpu.ops.projection_pallas import ProjWords

from _torch_parity import np_

W, H = 384, 256


def _cfgs(cluster, payload_words):
    kw = dict(width=W, height=H, cluster=cluster,
              words_payload=payload_words)
    return (gj.RasterizerConfig(**kw).fast_defaults(),
            gt.RasterizerConfig(**kw).fast_defaults())


@pytest.fixture(scope="module")
def words():
    """The port's plain fused projection of a big-heavy 8,192-splat scene:
    (the port's ProjWords, the same words as the JAX package's)."""
    cloud = gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        8192, seed=5, extent=3.0, scale_range=(0.005, 0.2), device="cpu")))
    cfg = gt.RasterizerConfig(width=W, height=H).fast_defaults()
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    wt = pk.project_words(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                          cloud.upload_time, uni.view, uni.proj,
                          uni.camera_pos, uni.model_scale, uni.time, cfg,
                          num_splats=cloud.num_splats)
    wj = ProjWords(*(jnp.asarray(np_(w).view(np.uint32)) for w in wt[:7]),
                   cnt=jnp.asarray(np_(wt.cnt)))
    return wt, wj


def _stage1(wt):
    """The static bricks' stage-1 rows of the port's words (B, 128)."""
    P = wt.key.shape[1]
    idx = torch.arange(P, dtype=torch.int32)
    return tuple(a.reshape(-1, 128) for a in (wt.key, wt.ix, wt.iy, wt.pc1,
                                              wt.pc2, wt.rgb9, idx))


# --- the cooked centres' fixed order -----------------------------------------

def test_tree_sum_is_the_pairwise_tree():
    """``_tree_sum`` adds x[i] + x[i + n/2] level by level in f32."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 128)) * 10.0 ** rng.integers(
        -3, 4, (5, 128))).astype(np.float32)
    want = x.copy()
    while want.shape[1] > 1:
        h = want.shape[1] // 2
        want = (want[:, :h] + want[:, h:]).astype(np.float32)
    got = blocks_t._tree_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want[:, 0])


@pytest.mark.parametrize("cluster", ["bricks", "screen"])
def test_cooked_centres_in_fixed_order_match_jax(words, cluster):
    """The cooked payload's centres (rows 14-15) and the features about them
    (rows 0-2) within 1e-5 relative of JAX's; the integer rows and every
    block meta bit-equal."""
    wt, wj = words
    cfg_j, cfg_t = _cfgs(cluster, False)
    fj, _ = blocks_j.build_block_frame2_words(wj, cfg_j, words_payload=False)
    ft, _ = blocks_t.build_block_frame2_words(wt, cfg_t, words_payload=False)
    for f in ("rect", "bitmap", "min_depth", "max_depth", "num_valid"):
        np.testing.assert_array_equal(np_(getattr(fj, f)),
                                      np_(getattr(ft, f)), err_msg=f)
    pj, pt = np_(fj.payload), np_(ft.payload)
    live = np_(ft.num_valid) > 0
    assert live.sum() > 20
    for row in (11, 12, 13):
        np.testing.assert_array_equal(pj[:, row].view(np.int32),
                                      pt[:, row].view(np.int32))
    for row in (0, 1, 2, 14, 15):
        np.testing.assert_allclose(pt[:, row], pj[:, row], rtol=1e-5,
                                   atol=1e-5, err_msg=f"row {row}")
    assert float(np.abs(pt[live, 14, 0]).max()) > 16.0


# --- the big-lane window -----------------------------------------------------

def _select_int64(bkey, big_cap):
    """``_select_big_lanes`` as it was: the window's keys sorted as int64."""
    R, CW = bkey.shape
    KC = min(CW, max(CW // 4, 4 * big_cap // max(R, 1)))
    win = torch.sort(blocks_t.u32(bkey), dim=1).values[:, :KC]
    row0 = (torch.arange(R, dtype=torch.int64) * CW)[:, None]
    pos_w = torch.where(win != blocks_t.U32_MAX, row0 + (win & 0x3FF),
                        torch.zeros_like(win))
    gks, order = torch.sort((win >> 10).reshape(-1), stable=True)
    cap = min(big_cap, R * KC)
    tk_idx = pos_w.reshape(-1)[order][:cap]
    tk_ok = gks[:cap] != (blocks_t.U32_MAX >> 10)
    pad = big_cap - cap
    return (torch.cat([tk_idx, tk_idx.new_zeros(pad)]),
            torch.cat([tk_ok, tk_ok.new_zeros(pad)]))


def _chunk_keys(seed, R, CW, counts):
    """(R, CW) u32 chunk keys: row r holds counts[r] candidates at distinct
    columns with depths from a narrow range (many equal depths across and
    within rows), the rest 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    keys = np.full((R, CW), 0xFFFFFFFF, np.uint32)
    for r, n in enumerate(counts):
        cols = rng.choice(CW, n, replace=False)
        depth = rng.integers(40000, 40040, n).astype(np.uint32)
        keys[r, cols] = (depth << 10) | cols.astype(np.uint32)
    return keys


@pytest.mark.parametrize("case", ["few_candidates", "empty_rows",
                                  "cap_past_window"])
def test_window_sort_in_int32_matches_int64_and_jax(case):
    R, CW = 12, 256
    rng = np.random.default_rng(7)
    if case == "few_candidates":      # KC 64: one row past it
        counts, big_cap = rng.integers(0, 12, R), 192
        counts[0] = 100
    elif case == "empty_rows":        # KC 128: every other row all U32_MAX
        counts, big_cap = [0, 40] * (R // 2), 384
    else:                             # big_cap > R * KC: pad entries
        counts, big_cap = rng.integers(100, 256, R), R * CW + 512
    keys = _chunk_keys(3, R, CW, counts)
    bkey = torch.from_numpy(keys.view(np.int32))
    tk_idx, tk_ok = blocks_t._select_big_lanes(bkey, big_cap)
    old_idx, old_ok = _select_int64(bkey, big_cap)
    jk_idx, jk_ok = blocks_j._select_big_lanes(jnp.asarray(keys), big_cap)
    assert tk_idx.dtype == torch.int64 and tk_idx.shape == (big_cap,)
    assert torch.equal(tk_idx, old_idx) and torch.equal(tk_ok, old_ok)
    np.testing.assert_array_equal(tk_idx.numpy(), np.asarray(jk_idx))
    np.testing.assert_array_equal(tk_ok.numpy(), np.asarray(jk_ok))
    n_ok = int(tk_ok.sum())
    assert 0 < n_ok < big_cap
    assert not bool(tk_ok[n_ok:].any()) and not bool(tk_idx[n_ok:].any())


def test_big_window_reference_is_the_rows_first_keys():
    keys = _chunk_keys(4, 6, 128, [0, 5, 40, 128, 90, 1])
    pos_w, gk = blocks_t.big_window_reference(
        torch.from_numpy(keys.view(np.int32)), 32)
    win = np.sort(keys, axis=1)[:, :32]
    assert pos_w.dtype == gk.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), (win >> 10).astype(np.int32))
    row0 = (np.arange(6) * 128)[:, None]
    want = np.where(win != 0xFFFFFFFF, row0 + (win & 0x3FF), 0)
    np.testing.assert_array_equal(pos_w.numpy(), want)


# --- the taken mask, fused ---------------------------------------------------

@pytest.mark.parametrize("payload_words", [True, False],
                         ids=["words", "cooked"])
def test_taken_fused_into_the_key_read(words, payload_words):
    """The frame build given the taken mask equals the frame of the keys
    with taken lanes set to -1, bit for bit (f32 as bits); the dispatcher
    takes the plain version for CPU tensors."""
    wt, _ = words
    s1 = _stage1(wt)
    B = s1[0].shape[0]
    taken = torch.from_numpy(np.random.default_rng(1).random(B * 128)
                             < 0.2)
    taken[:128] = True                   # one brick wholly taken
    _, cfg = _cfgs("bricks", payload_words)
    masked = (torch.where(taken.reshape(B, 128), -1, s1[0]),) + s1[1:]
    want = blocks_t.frame_from_stage1_reference(
        masked, B, 128, cfg, 7, words=payload_words)
    for fn in (blocks_t.frame_from_stage1_reference,
               blocks_t._frame_from_stage1):
        got = fn(s1, B, 128, cfg, 7, words=payload_words, taken=taken)
        for f in blocks_t.BlockFrame2._fields:
            a, b = getattr(got, f), getattr(want, f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f
    assert int(want.num_valid[0]) == 0 and int(want.num_valid.sum()) > 1000


# --- sentinels ---------------------------------------------------------------

@pytest.mark.parametrize("frame", ["one_empty_brick", "empty_frame"])
@pytest.mark.parametrize("payload_words", [True, False],
                         ids=["words", "cooked"])
def test_empty_bricks_get_jax_sentinels(words, frame, payload_words):
    """An all-invalid brick gets rect 0, bitmap 0, depth range 0xFFFF and
    count 0, as in the JAX package; an all-invalid frame is all such
    bricks, and its payload is bit-equal to JAX's."""
    wt, _ = words
    s1 = list(_stage1(wt))
    B = s1[0].shape[0]
    key = s1[0].clone()
    if frame == "empty_frame":
        key[:] = -1
    else:
        key[3] = -1
    s1[0] = key
    _, cfg_t = _cfgs("bricks", payload_words)
    cfg_j, _ = _cfgs("bricks", payload_words)
    ft = blocks_t.frame_from_stage1_reference(tuple(s1), B, 128, cfg_t, 0,
                                              words=payload_words)
    fj = blocks_j._frame_from_stage1(
        tuple(jnp.asarray(np_(a).view(np.uint32)) for a in s1), B, 128,
        cfg_j, jnp.int32(0), words=payload_words)
    for f in ("rect", "bitmap", "min_depth", "max_depth", "num_valid"):
        np.testing.assert_array_equal(np_(getattr(fj, f)),
                                      np_(getattr(ft, f)), err_msg=f)
    empty = (np.arange(B) == 3) if frame == "one_empty_brick" else \
        np.ones(B, bool)
    assert not np_(ft.rect)[empty].any() and not np_(ft.bitmap)[empty].any()
    assert (np_(ft.min_depth)[empty] == 0xFFFF).all()
    assert (np_(ft.max_depth)[empty] == 0xFFFF).all()
    assert (np_(ft.num_valid)[empty] == 0).all()
    assert (np_(ft.num_valid)[~empty] > 0).any() == (frame != "empty_frame")
    if frame == "empty_frame":
        pj, pt = np_(fj.payload), np_(ft.payload)
        np.testing.assert_array_equal(pj.view(np.int32), pt.view(np.int32))
