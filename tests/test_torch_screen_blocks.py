"""The Blocks stage's plain versions, composed by hand, against the JAX
package: ``screen_pack_reference``, ``screen_sort_reference`` and
``big_set_reference`` (the plain versions of csrc/screen_pack.cu,
csrc/screen_sort.cu and csrc/big_set.cu) with ``_select_big_lanes``,
``_taken`` and ``frame_from_stage1_reference``, on clouds spanning several
8192-splat superblocks.

They must equal the JAX ``build_block_frame2`` (readable projection;
cooked and words payloads) and the screen branch of
``build_block_frame2_words`` (fused projection) at the tolerances of
tests/test_torch_blocks.py: integer outputs bit-equal, the big table's
and the cooked payload's float rows within 1e-5 relative (XLA and torch
round log, pow and sqrt differently by an ulp), their integer rows
bit-equal. The port's own ``build_block_frame2`` and
``build_block_frame2_words`` on CPU tensors must equal the composition
bit for bit: the dispatchers take exactly these plain versions.
"""

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import blocks2 as b2
from godotgaussiansplatting_torch.ops.blocks import SUPERBLOCK
from godotgaussiansplatting_torch.ops.projection import ProjectedSplats
from godotgaussiansplatting_torch.ops.projection_kernel import ProjWords
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops import blocks2 as blocks_j
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection import project_splats
from godotgaussiansplatting_tpu.ops.projection_pallas import project_words

from _torch_parity import np_, port_tuple
from test_torch_blocks import _assert_frames_equal

W, H = 512, 384


@pytest.fixture(scope="module")
def projected():
    """The JAX readable projection of a 24,576-splat scene (a capacity of
    four superblocks) at tile 16, with big splats."""
    cj = gj.mortonize(gj.synthetic_scene(24576, seed=13, extent=3.0,
                                         scale_range=(0.008, 0.22)))
    cfg = gj.RasterizerConfig(width=W, height=H, quality="fast")
    u = make_uniforms(gj.Camera.reset_pose(), cfg)
    pj = project_splats(cj.means, cj.cov3d, cj.opacity, cj.sh,
                        cj.upload_time, u.view, u.proj, u.camera_pos,
                        u.model_scale, u.time, cfg)
    return pj, port_tuple(ProjectedSplats, pj)


@pytest.fixture(scope="module")
def words():
    """The JAX fused projection's words of a 16,384-splat scene (two
    superblocks) under fast_defaults()."""
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        16384, seed=14, extent=3.0, scale_range=(0.008, 0.22))))
    cfg = gj.RasterizerConfig(width=W, height=H).fast_defaults()
    u = make_uniforms(gj.Camera.reset_pose(), cfg)
    wj = project_words(cj.means, cj.cov3d, cj.opacity, cj.sh,
                       cj.upload_time, u.view, u.proj, u.camera_pos,
                       u.model_scale, u.time, cfg, num_splats=cj.num_splats)
    return wj, port_tuple(ProjWords, wj)


def _rows(P):
    sb = min(SUPERBLOCK, P)
    return P // sb, sb


def _big_lanes(bkey, P, packed, num_big, cfg):
    big_cap = max(b2.default_big_cap(P), b2.BLOCK_SIZE)
    tk_idx, tk_ok = b2._select_big_lanes(bkey, big_cap)
    taken = b2._taken(tk_idx, tk_ok, P)
    bigs = b2.big_set_reference(packed, tk_idx, tk_ok,
                                (num_big - tk_ok.sum()).to(torch.int32),
                                cfg)
    return taken, bigs


def compose_projected(prj, cfg, num_splats, words_payload):
    """build_block_frame2's screen clustering from the plain versions."""
    P = prj.valid.shape[0]
    SB, sb = _rows(P)
    gx, gy = cfg.tile_dims
    cell = b2.adaptive_cell_shift(num_splats, gx, gy)
    sw = b2.screen_pack_reference(prj, cell, b2._big_chunk_width(P, sb), cfg)
    packed = (sw.key, sw.ix, sw.iy, sw.pc1, sw.pc2, sw.rgb9)
    taken, bigs = _big_lanes(sw.bkey, P, packed, sw.num_big, cfg)
    s1 = b2.screen_sort_reference(sw.key.reshape(SB, sb),
                                  taken.reshape(SB, sb),
                                  tuple(w.reshape(SB, sb)
                                        for w in packed[1:]))
    frame = b2.frame_from_stage1_reference(
        s1, P // b2.BLOCK_SIZE, b2.BLOCK_SIZE, cfg,
        prj.num_tiles.sum().to(torch.int32), words=words_payload)
    return frame, bigs, sw


def compose_words(wt, cfg, words_payload):
    """build_block_frame2_words' screen branch from the plain versions."""
    P = wt.key.shape[1]
    SB, sb = _rows(P)
    cnt = wt.cnt.reshape(-1, 128).to(torch.int64)
    packed = (wt.key, wt.ix, wt.iy, wt.pc1, wt.pc2, wt.rgb9)
    taken, bigs = _big_lanes(wt.bkey, P, packed, cnt[:, 0].sum(), cfg)
    s1 = b2.screen_sort_reference(wt.key.reshape(SB, sb),
                                  taken.reshape(SB, sb),
                                  tuple(w.reshape(SB, sb)
                                        for w in packed[1:]))
    frame = b2.frame_from_stage1_reference(
        s1, P // b2.BLOCK_SIZE, b2.BLOCK_SIZE, cfg,
        cnt[:, 1].sum().to(torch.int32), words=words_payload)
    return frame, bigs


def _assert_matches_jax(fj, bj, ft, bt, words_payload):
    if words_payload:
        _assert_frames_equal(fj, bj, ft, bt)
        return
    _assert_frames_equal(fj._replace(payload=fj.num_valid), bj,
                         ft._replace(payload=ft.num_valid), bt)
    pa, pb = np_(fj.payload), ft.payload.numpy()
    for row in range(b2.PAYLOAD_WIDTH):
        if row in (11, 12, 13):
            np.testing.assert_array_equal(pa[:, row].view(np.int32),
                                          pb[:, row].view(np.int32))
        else:
            np.testing.assert_allclose(pb[:, row], pa[:, row], rtol=1e-5,
                                       atol=1e-5, err_msg=f"row {row}")


def _bits_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert x.shape == y.shape and torch.equal(x, y), name


@pytest.mark.parametrize("words_payload", [False, True])
def test_plain_versions_match_jax_build_block_frame2(projected,
                                                     words_payload):
    pj, pt = projected
    kw = dict(width=W, height=H, quality="fast")
    cfg_j, cfg_t = gj.RasterizerConfig(**kw), gt.RasterizerConfig(**kw)
    P = pt.valid.shape[0]
    assert P // SUPERBLOCK >= 2
    fj, bj = blocks_j.build_block_frame2(pj, cfg_j, num_splats=20000,
                                         words_payload=words_payload)
    ft, bt, sw = compose_projected(pt, cfg_t, 20000, words_payload)
    assert int(ft.num_valid.sum()) > 10000
    assert int(bt.valid.sum()) > 100 and int(sw.num_big) > 100
    _assert_matches_jax(fj, bj, ft, bt, words_payload)
    # the dispatchers' CPU path is the composition
    fd, bd = b2.build_block_frame2(pt, cfg_t, num_splats=20000,
                                   words_payload=words_payload)
    _bits_equal(fd, ft)
    _bits_equal(bd, bt)


@pytest.mark.parametrize("words_payload", [False, True])
def test_plain_versions_match_jax_screen_words(words, words_payload):
    wj, wt = words
    # fast_defaults() sets the static bricks: the screen clustering after it
    cfg_j = gj.RasterizerConfig(width=W, height=H).fast_defaults().replace(
        cluster="screen")
    cfg_t = gt.RasterizerConfig(width=W, height=H).fast_defaults().replace(
        cluster="screen")
    assert wt.key.shape[1] // SUPERBLOCK >= 2
    fj, bj = blocks_j.build_block_frame2_words(wj, cfg_j,
                                               words_payload=words_payload)
    ft, bt = compose_words(wt, cfg_t, words_payload)
    assert int(ft.num_valid.sum()) > 5000 and int(bt.valid.sum()) > 50
    _assert_matches_jax(fj, bj, ft, bt, words_payload)
    fd, bd = b2.build_block_frame2_words(wt, cfg_t,
                                         words_payload=words_payload)
    _bits_equal(fd, ft)
    _bits_equal(bd, bt)


def test_screen_pack_words_are_the_stage1_words(projected):
    """The pack's words, sorted by the plain sort, are the JAX frame's word
    payload rows: key (with taken lanes read as -1), ix, iy, pc1, pc2,
    rgb9e5 and the source index, brick by brick; and its chunk keys mark
    exactly the valid splats whose extent reaches BIG_RADIUS."""
    pj, pt = projected
    kw = dict(width=W, height=H, quality="fast")
    cfg_j, cfg_t = gj.RasterizerConfig(**kw), gt.RasterizerConfig(**kw)
    fj, _ = blocks_j.build_block_frame2(pj, cfg_j, words_payload=True)
    ft, _, sw = compose_projected(pt, cfg_t, pt.valid.shape[0], True)
    np.testing.assert_array_equal(np_(fj.payload)[:, :7],
                                  ft.payload[:, :7].numpy())
    rx, ry = b2.extents_from_conic(pt.conic[:, 0], pt.conic[:, 1],
                                   pt.conic[:, 2], pt.color[:, 3])
    big = (torch.maximum(rx, ry) >= b2.BIG_RADIUS) & pt.valid
    assert torch.equal(sw.bkey.reshape(-1) != -1, big)
    assert int(sw.num_big) == int(big.sum())
    assert torch.equal(sw.key != -1, pt.valid)
