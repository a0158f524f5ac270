"""Port vs JAX package: the v3 composite (ops/render_v3.py).

The same JAX-built frame inputs (tile bins, tile big lanes, and the word or
the cooked payload) go to the port's ``render_tiles_v3_reference`` (what
the CUDA kernel computes, and what CPU tensors run) and to the JAX
``render_tiles_v3`` (Pallas, interpret mode, ``lowp=False``) at 160x112
with tile 32: a ragged tile row, tiles of many batches, and resident big
lanes. The two payloads share their block meta, so one set of bins serves
both.

Tolerances: RGB PSNR >= 45 dB and t_final within 1e-2. The JAX kernel
rounds alpha, colours and emit weights to bf16 even with ``lowp=False``
and splits its power matmul into bf16 halves; the port keeps f32. Near the
early-exit threshold that rounding can also move a tile's exit by a batch.
"""

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import render_v3 as rt
from godotgaussiansplatting_torch.ops.bigbin import TileBigs
from godotgaussiansplatting_torch.ops.binning2 import TileBins2
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops import render_pallas3 as rj
from godotgaussiansplatting_tpu.ops.bigbin import bin_bigs
from godotgaussiansplatting_tpu.ops.binning2 import bin_blocks2
from godotgaussiansplatting_tpu.ops.blocks2 import build_block_frame2_words
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection_pallas import project_words

from _torch_parity import np_, port_tuple, psnr, t_

W, H = 160, 112


@pytest.fixture(scope="module")
def frame_inputs():
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        16000, seed=5, extent=2.5, scale_range=(0.01, 0.25))))
    cfg_j = gj.RasterizerConfig(width=W, height=H).fast_defaults()
    cfg_t = gt.RasterizerConfig(width=W, height=H).fast_defaults()
    u = make_uniforms(gj.Camera.reset_pose(), cfg_j)
    words = project_words(cj.means, cj.cov3d, cj.opacity, cj.sh,
                          cj.upload_time, u.view, u.proj, u.camera_pos,
                          u.model_scale, u.time, cfg_j,
                          num_splats=cj.num_splats)
    bf, bigs = build_block_frame2_words(words, cfg_j, words_payload=True)
    bins = bin_blocks2(bf, cfg_j)
    tbig = bin_bigs(bigs, cfg_j, obig=cfg_j.big_tile_capacity)
    cooked, _ = build_block_frame2_words(words, cfg_j, words_payload=False)
    return cfg_j, cfg_t, bf, bins, tbig, cooked.payload


def test_inputs_exercise_the_kernel_paths(frame_inputs):
    cfg_j, _, _, bins, tbig, _ = frame_inputs
    gx, gy = cfg_j.tile_dims
    assert gy * cfg_j.tile_size > H                   # ragged tile row
    nb = np_(bins.tile_nblocks)
    assert (nb > 3 * cfg_j.batch_u).sum() >= 4        # multi-batch tiles
    assert (np_(tbig.tile_nbig) > 0).sum() >= 4       # resident big lanes


def _render_matches_jax(cfg_j, cfg_t, payload, bins, tbig, early_exit,
                        heatmap):
    tiles_j = rj.render_tiles_v3(payload, bins, tbig, np.float32(heatmap),
                                 cfg_j, early_exit=early_exit, lowp=False,
                                 interpret=True)
    tiles_t = rt.render_tiles_v3(t_(payload), port_tuple(TileBins2, bins),
                                 port_tuple(TileBigs, tbig),
                                 torch.tensor(heatmap), cfg_t,
                                 early_exit=early_exit)
    img_j, tf_j = rj.assemble_image_v3(tiles_j, cfg_j)
    img_t, tf_t = rt.assemble_image_v3(tiles_t, cfg_t)
    img_j, img_t = np_(img_j), np_(img_t)
    assert img_t.shape == (4, H, W) and np.isfinite(img_t).all()
    p = psnr(np.clip(img_j[:3], 0, 1), np.clip(img_t[:3], 0, 1))
    assert p >= 45.0, p
    assert np.abs(np_(tf_j) - np_(tf_t)).max() <= 1e-2
    # channels 5-7: blocks processed, nb and nbig per tile
    tj, tt = np_(tiles_j), np_(tiles_t)
    np.testing.assert_array_equal(tj[:, 6:8], tt[:, 6:8])
    if not early_exit:
        np.testing.assert_array_equal(tj[:, 5], tt[:, 5])


@pytest.mark.parametrize("early_exit,heatmap", [(True, 1.0), (False, 0.0)])
def test_render_matches_jax(frame_inputs, early_exit, heatmap):
    cfg_j, cfg_t, bf, bins, tbig, _ = frame_inputs
    _render_matches_jax(cfg_j, cfg_t, bf.payload, bins, tbig, early_exit,
                        heatmap)


@pytest.mark.parametrize("early_exit,heatmap", [(True, 1.0), (False, 0.0)])
def test_render_cooked_matches_jax(frame_inputs, early_exit, heatmap):
    """The cooked (B, 16, 128) f32 payload (_decode_cooked) against the
    JAX kernel's cooked branch, at the word payload's tolerances."""
    cfg_j, cfg_t, _, bins, tbig, cooked = frame_inputs
    assert np_(cooked).dtype == np.float32 and cooked.shape[1] == 16
    _render_matches_jax(cfg_j, cfg_t, cooked, bins, tbig, early_exit,
                        heatmap)


def test_pack_rows_and_assemble_bit_equal(frame_inputs):
    cfg_j, cfg_t, _, bins, tbig, _ = frame_inputs
    rows_j = rj.pack_tile_rows_v3(
        bins.tile_blocks, bins.tile_nblocks, tbig.tile_nbig,
        bins.tile_minmax, bins.tile_candidates, np.float32(0.37), cfg_j,
        tile_big_prefix=tbig.big_prefix)
    rows_t = rt.pack_tile_rows_v3(
        t_(bins.tile_blocks), t_(bins.tile_nblocks), t_(tbig.tile_nbig),
        t_(bins.tile_minmax), t_(bins.tile_candidates), torch.tensor(0.37),
        cfg_t, tile_big_prefix=t_(tbig.big_prefix))
    np.testing.assert_array_equal(np_(rows_j), np_(rows_t))
    rng = np.random.default_rng(0)
    gx, gy = cfg_j.tile_dims
    tiles = rng.normal(size=(gx * gy, rt.OUT_CH, cfg_j.tile_size ** 2)
                       ).astype(np.float32)
    for a, b in zip(rj.assemble_image_v3(tiles, cfg_j),
                    rt.assemble_image_v3(torch.from_numpy(tiles), cfg_t)):
        np.testing.assert_array_equal(np_(a), np_(b))
    np.testing.assert_array_equal(np_(rj.tile_channels_v3(tiles, cfg_j)),
                                  np_(rt.tile_channels_v3(
                                      torch.from_numpy(tiles), cfg_t)))


def test_prepass_big_la_matches_jax(frame_inputs):
    cfg_j, cfg_t, _, _, tbig, _ = frame_inputs
    a = np_(rj.prepass_big_la(tbig.bigpay, cfg_j, lowp=False))
    b = np_(rt.prepass_big_la(t_(tbig.bigpay), cfg_t))
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
