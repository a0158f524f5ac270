"""Port vs JAX package: block build (ops/blocks2.py) and binning
(ops/binning2.py, ops/bigbin.py).

The JAX projection's ProjWords (as numpy) feed both packages'
``build_block_frame2_words``, and the JAX readable projection's
ProjectedSplats both packages' ``build_block_frame2``; integer outputs
must be bit-equal and the big table's float rows within 1e-5 relative (XLA
and torch round log, pow and sqrt differently by an ulp). The same JAX BlockFrame2/BigSet then feed both
packages' binning, which must agree bit for bit. The cases of
tests/test_bigs.py run on the port as parametrised cases.
"""

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import bigbin as bigbin_t
from godotgaussiansplatting_torch.ops import binning2 as binning_t
from godotgaussiansplatting_torch.ops import blocks2 as blocks_t
from godotgaussiansplatting_torch.ops.projection import ProjectedSplats
from godotgaussiansplatting_torch.ops.projection_kernel import ProjWords
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops import bigbin as bigbin_j
from godotgaussiansplatting_tpu.ops import binning2 as binning_j
from godotgaussiansplatting_tpu.ops import blocks2 as blocks_j
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection import project_splats
from godotgaussiansplatting_tpu.ops.projection_pallas import project_words

from _torch_parity import np_, port_tuple, t_

INT_TABLE_ROWS = (11, 13)


def _words(n, seed, scale_range, w, h):
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        n, seed=seed, extent=3.0, scale_range=scale_range)))
    cfg = gj.RasterizerConfig(width=w, height=h).fast_defaults()
    u = make_uniforms(gj.Camera.reset_pose(), cfg)
    wj = project_words(cj.means, cj.cov3d, cj.opacity, cj.sh,
                       cj.upload_time, u.view, u.proj, u.camera_pos,
                       u.model_scale, u.time, cfg, num_splats=cj.num_splats)
    return wj, port_tuple(ProjWords, wj)


@pytest.fixture(scope="module")
def words():
    return _words(16384, 3, (0.005, 0.2), 512, 384)


@pytest.fixture(scope="module")
def big_words():
    """A big-heavy scene (the tests/test_bigs.py kind, cut in size)."""
    return _words(16384, 9, (0.02, 0.25), 512, 512)


def _cfgs(cluster, w=512, h=384):
    kw = dict(width=w, height=h, cluster=cluster)
    return (gj.RasterizerConfig(**kw).fast_defaults(),
            gt.RasterizerConfig(**kw).fast_defaults())


def _assert_frames_equal(fj, bj, ft, bt):
    for f in ("payload", "rect", "bitmap", "min_depth", "max_depth",
              "num_valid", "num_culled_pairs"):
        np.testing.assert_array_equal(np_(getattr(fj, f)),
                                      np_(getattr(ft, f)), err_msg=f)
    for f in ("depth16", "rect", "valid", "residual"):
        np.testing.assert_array_equal(np_(getattr(bj, f)),
                                      np_(getattr(bt, f)), err_msg=f)
    tj, tt = np_(bj.table), np_(bt.table)
    for row in range(tj.shape[1]):
        if row in INT_TABLE_ROWS:
            np.testing.assert_array_equal(tj[:, row].view(np.int32),
                                          tt[:, row].view(np.int32))
        else:
            np.testing.assert_allclose(tt[:, row], tj[:, row], rtol=1e-5,
                                       atol=1e-6, err_msg=f"row {row}")


@pytest.mark.parametrize("cluster", ["bricks", "screen"])
def test_block_frame_words_bit_equal(words, cluster):
    wj, wt = words
    cfg_j, cfg_t = _cfgs(cluster)
    fj, bj = blocks_j.build_block_frame2_words(wj, cfg_j, words_payload=True)
    ft, bt = blocks_t.build_block_frame2_words(wt, cfg_t, words_payload=True)
    assert int(np_(fj.num_valid).sum()) > 1000
    _assert_frames_equal(fj, bj, ft, bt)


@pytest.fixture(scope="module")
def projected():
    """The JAX readable projection of a big-heavy scene at tile 16."""
    cj = gj.mortonize(gj.synthetic_scene(16384, seed=9, extent=3.0,
                                         scale_range=(0.01, 0.25)))
    cfg = gj.RasterizerConfig(width=384, height=320, quality="fast")
    u = make_uniforms(gj.Camera.reset_pose(), cfg)
    pj = project_splats(cj.means, cj.cov3d, cj.opacity, cj.sh,
                        cj.upload_time, u.view, u.proj, u.camera_pos,
                        u.model_scale, u.time, cfg)
    return pj, port_tuple(ProjectedSplats, pj)


@pytest.mark.parametrize("cluster,words_payload", [
    ("screen", True), ("bricks", True), ("screen", False)])
def test_block_frame_from_projection_matches_jax(projected, cluster,
                                                 words_payload):
    """build_block_frame2 (readable projection -> blocks): the screen
    clustering's per-superblock sort, the adaptive cell and the chunked
    big-candidate keys. Words, rects, bitmaps, depth ranges and BigSet
    integers are bit-equal; the cooked payload's rows are compared as the
    words' are (rank and idx bit-equal, the re-centred features within
    1e-5 relative)."""
    pj, pt = projected
    kw = dict(width=384, height=320, quality="fast", cluster=cluster)
    cfg_j, cfg_t = gj.RasterizerConfig(**kw), gt.RasterizerConfig(**kw)
    fj, bj = blocks_j.build_block_frame2(pj, cfg_j, num_splats=12000,
                                         words_payload=words_payload)
    ft, bt = blocks_t.build_block_frame2(pt, cfg_t, num_splats=12000,
                                         words_payload=words_payload)
    assert int(np_(bj.valid).sum()) > 100, "scene must have big lanes"
    assert int(np_(fj.num_valid).sum()) > 1000
    if words_payload:
        _assert_frames_equal(fj, bj, ft, bt)
        return
    _assert_frames_equal(fj._replace(payload=fj.num_valid), bj,
                         ft._replace(payload=ft.num_valid), bt)
    pa, pb = np_(fj.payload), np_(ft.payload)
    for row in range(16):
        if row in (11, 12, 13):
            np.testing.assert_array_equal(pa[:, row].view(np.int32),
                                          pb[:, row].view(np.int32))
        else:
            np.testing.assert_allclose(pb[:, row], pa[:, row], rtol=1e-5,
                                       atol=1e-5, err_msg=f"row {row}")


def test_block_frame_with_padded_big_lanes_matches_jax(projected):
    """A big-lane capacity above the candidates: the pad entries of
    ``_select_big_lanes`` all point at splat 0 and are not ok, so tk_idx
    holds duplicates and only some entries are ok. The taken splats (a
    scatter over every entry, with no boolean index) and the frame stay
    bit-equal to the JAX package's."""
    pj, pt = projected
    kw = dict(width=384, height=320, quality="fast")
    cfg_j, cfg_t = gj.RasterizerConfig(**kw), gt.RasterizerConfig(**kw)
    fj, bj = blocks_j.build_block_frame2(pj, cfg_j, num_splats=12000,
                                         words_payload=True, big_cap=4096)
    ft, bt = blocks_t.build_block_frame2(pt, cfg_t, num_splats=12000,
                                         words_payload=True, big_cap=4096)
    n_ok = int(bt.valid.sum())
    assert 1000 < n_ok < 4096 - 100, "the capacity must leave pad entries"
    assert not bool(pt.valid[0]), "splat 0 must not be a big lane here"
    _assert_frames_equal(fj, bj, ft, bt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_taken_splats_are_those_with_an_ok_entry(seed):
    """``_taken`` (the scatter) equals the boolean-index formula it
    replaced, on entries with duplicates whose ok flags disagree: a splat
    is taken when any of its entries is ok. (The JAX package's
    ``.at[tk_idx].set(tk_ok)`` lets the last duplicate win on XLA's CPU,
    so there a big splat 0 followed by pad entries is not taken.)"""
    rng = np.random.default_rng(seed)
    P = 512
    tk_idx = torch.from_numpy(rng.integers(0, 64, 300)).to(torch.int64)
    tk_idx[-41:] = 0                  # splat 0 taken, then 40 pads
    tk_ok = torch.from_numpy(rng.random(300) < 0.5)
    tk_ok[-41] = True
    tk_ok[-40:] = False
    old = torch.zeros(P, dtype=torch.bool)
    old[tk_idx[tk_ok]] = True
    new = blocks_t._taken(tk_idx, tk_ok, P)
    assert torch.equal(new, old) and bool(new[0])


def test_block_frame_cooked_meta_equal(words):
    """The cooked 16-row payload keeps the same block meta as the words."""
    wj, wt = words
    cfg_j, cfg_t = _cfgs("bricks")
    fj, _ = blocks_j.build_block_frame2_words(wj, cfg_j, words_payload=False)
    ft, _ = blocks_t.build_block_frame2_words(wt, cfg_t, words_payload=False)
    for f in ("rect", "bitmap", "min_depth", "max_depth", "num_valid"):
        np.testing.assert_array_equal(np_(getattr(fj, f)),
                                      np_(getattr(ft, f)), err_msg=f)
    pj, pt = np_(fj.payload), np_(ft.payload)
    np.testing.assert_array_equal(pj[:, 12].view(np.int32),
                                  pt[:, 12].view(np.int32))
    np.testing.assert_array_equal(pj[:, 13].view(np.int32),
                                  pt[:, 13].view(np.int32))
    for row in (3, 4, 5, 6, 7, 8, 9, 10):
        np.testing.assert_array_equal(pj[:, row], pt[:, row], err_msg=row)


@pytest.mark.parametrize("cluster,caps", [
    ("bricks", (1024, 256)), ("screen", (1024, 256)), ("bricks", (64, 16)),
])
def test_bins_bit_equal(words, cluster, caps):
    wj, _ = words
    cfg_j, cfg_t = _cfgs(cluster)
    fj, bj = blocks_j.build_block_frame2_words(wj, cfg_j, words_payload=True)
    st, tc = caps
    nj = binning_j.bin_blocks2(fj, cfg_j, supertile_cap=st, tile_cap=tc)
    nt = binning_t.bin_blocks2(port_tuple(blocks_t.BlockFrame2, fj), cfg_t,
                               supertile_cap=st, tile_cap=tc)
    for f in nj._fields:
        np.testing.assert_array_equal(np_(getattr(nj, f)),
                                      np_(getattr(nt, f)), err_msg=f)
    assert int(np_(nj.tile_nblocks).max()) > 1


@pytest.mark.parametrize("obig", [128, 32])
def test_bigbins_bit_equal(big_words, obig):
    wj, _ = big_words
    cfg_j, cfg_t = _cfgs("bricks", 512, 512)
    _, bj = blocks_j.build_block_frame2_words(wj, cfg_j, words_payload=True)
    gj_ = bigbin_j.bin_bigs(bj, cfg_j, obig=obig)
    gt_ = bigbin_t.bin_bigs(port_tuple(blocks_t.BigSet, bj), cfg_t,
                            obig=obig)
    for f in gj_._fields:
        np.testing.assert_array_equal(np_(getattr(gj_, f)),
                                      np_(getattr(gt_, f)), err_msg=f)
    assert int(np_(gj_.tile_nbig).max()) > 8


def test_bigbins_past_65535_lanes(big_words):
    """The port's bin_bigs takes more than 65,535 lanes (a sharded frame
    gathers n_tile big sets; the JAX package asserts N <= 65535): the big
    set with 70,000 dead lanes appended bins exactly as the big set
    alone."""
    _, wt = big_words
    _, cfg_t = _cfgs("bricks", 512, 512)
    _, bt = blocks_t.build_block_frame2_words(wt, cfg_t, words_payload=True)
    pad = 70_000
    wide = blocks_t.BigSet(
        table=torch.cat([bt.table, bt.table.new_zeros((pad, 16))]),
        depth16=torch.cat([bt.depth16, bt.depth16.new_full((pad,), 0xFFFF)]),
        rect=torch.cat([bt.rect, bt.rect.new_zeros((pad, 4))]),
        valid=torch.cat([bt.valid, bt.valid.new_zeros(pad)]),
        residual=bt.residual)
    assert wide.table.shape[0] > 0xFFFF
    a = bigbin_t.bin_bigs(bt, cfg_t, obig=32)
    b = bigbin_t.bin_bigs(wide, cfg_t, obig=32)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.tile_nbig.max()) > 8


# --- tests/test_bigs.py cases, on the port -----------------------------------

def _n_true_and_valid(wt):
    n_true = int(wt.cnt.reshape(-1, 128)[:, 0].sum())
    n_valid = int((wt.key != -1).sum())
    return n_true, n_valid


@pytest.mark.parametrize("case", ["complete", "overflow"])
def test_big_extraction(big_words, case):
    """Every big splat is extracted when the capacity allows (residual 0);
    past it the residual is counted and the bigs stay in their chains. Either
    way chain lanes + big lanes = every valid splat, and the port agrees
    with the JAX package."""
    wj, wt = big_words
    cfg_j, cfg_t = _cfgs("bricks", 512, 512)
    n_true, n_valid = _n_true_and_valid(wt)
    assert n_true > 100, "scene must actually contain big splats"
    cap = max(2048, n_true + 128) if case == "complete" else 256
    ft, bt = blocks_t.build_block_frame2_words(wt, cfg_t, big_cap=cap,
                                               words_payload=True)
    n_taken = int(bt.valid.sum())
    if case == "complete":
        assert n_taken == n_true and int(bt.residual) == 0
    else:
        assert n_taken == 256 and int(bt.residual) == n_true - 256
    assert int(ft.num_valid.sum()) + n_taken == n_valid
    fj, bj = blocks_j.build_block_frame2_words(wj, cfg_j, big_cap=cap,
                                               words_payload=True)
    _assert_frames_equal(fj, bj, ft, bt)


def test_per_tile_lists_front_to_back_and_closest_first(big_words):
    _, wt = big_words
    _, cfg_t = _cfgs("bricks", 512, 512)
    _, bigs = blocks_t.build_block_frame2_words(wt, cfg_t, words_payload=True)
    tb = bigbin_t.bin_bigs(bigs, cfg_t, obig=32)
    pay = tb.bigpay.numpy()
    nbig = tb.tile_nbig.numpy()
    assert nbig.max() == 32 and int(tb.overflow) > 0
    for t in np.argsort(-nbig)[:16]:
        n = nbig[t]
        d = pay[t, 12]
        assert np.all(np.diff(d[:n]) >= 0), "tile big list not depth-sorted"
        assert np.all(d[n:] >= blocks_t.DEPTH_INVALID * 0.99)
    full = bigbin_t.bin_bigs(bigs, cfg_t, obig=256)
    t = int(np.argmax(nbig))
    assert int(full.tile_nbig[t]) >= nbig[t]
    np.testing.assert_array_equal(pay[t, 12, :nbig[t]],
                                  full.bigpay[t, 12, :nbig[t]].numpy())
    # the straddle-gate prefix counts exactly the live lanes
    np.testing.assert_array_equal(tb.big_prefix[:, -1].numpy(), nbig)


def test_u32_word_helpers_round_trip():
    x = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                     dtype=torch.int64)
    assert torch.equal(blocks_t.u32(blocks_t.i32(x)), x)
    w = t_(np.array([0x3F80BF80], np.uint32))
    a, b = blocks_t._unpack_bf16_pair(w)
    assert float(a) == -1.0 and float(b) == 1.0
