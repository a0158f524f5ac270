"""Port vs JAX package: the v4 lockstep composite (ops/render_v4.py).

JAX-built frame inputs on the cooked payload (96x64, tile 32, GT 4: six
tiles, so the second group of four is padded with two empty tiles) go to
the port's ``render_tiles_v4_reference`` (what the CUDA kernel computes,
and what CPU tensors run) and to the JAX ``render_tiles_v4`` (Pallas,
interpret mode, ``lowp=False``), at the v3 test's tolerances: RGB PSNR
>= 45 dB and t_final within 1e-2 (the JAX kernel rounds alpha, colours
and weights to bf16). The JAX v4 leaves out the big depth-bucket prefix,
so its straddle gate always fires; the port passes the prefix, and the
result is the same.

The port's v4 is v3 tile for tile: its plain version is bit-equal to the
cooked v3 plain version for every GT, and its layout helpers are
bit-equal to JAX's.
"""

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import render_v3 as r3
from godotgaussiansplatting_torch.ops import render_v4 as r4
from godotgaussiansplatting_torch.ops.bigbin import TileBigs
from godotgaussiansplatting_torch.ops.binning2 import TileBins2
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops import render_pallas4 as rj
from godotgaussiansplatting_tpu.ops.bigbin import bin_bigs
from godotgaussiansplatting_tpu.ops.binning2 import bin_blocks2
from godotgaussiansplatting_tpu.ops.blocks2 import build_block_frame2_words
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection_pallas import project_words

from _torch_parity import np_, port_tuple, psnr, t_

W, H = 96, 64


@pytest.fixture(scope="module")
def inputs():
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        12000, seed=6, extent=2.0, scale_range=(0.01, 0.25))))
    cfg_j = gj.RasterizerConfig(width=W, height=H, kernel="v4").fast_defaults()
    cfg_t = gt.RasterizerConfig(width=W, height=H, kernel="v4").fast_defaults()
    u = make_uniforms(gj.Camera.reset_pose(), cfg_j)
    words = project_words(cj.means, cj.cov3d, cj.opacity, cj.sh,
                          cj.upload_time, u.view, u.proj, u.camera_pos,
                          u.model_scale, u.time, cfg_j,
                          num_splats=cj.num_splats)
    bf, bigs = build_block_frame2_words(words, cfg_j, words_payload=False)
    bins = bin_blocks2(bf, cfg_j)
    tbig = bin_bigs(bigs, cfg_j, obig=cfg_j.big_tile_capacity)
    return (cfg_j, cfg_t, bf.payload, bins, tbig,
            (t_(bf.payload), port_tuple(TileBins2, bins),
             port_tuple(TileBigs, tbig)))


def test_inputs_exercise_the_kernel_paths(inputs):
    cfg_j, cfg_t, payload, bins, tbig, _ = inputs
    gx, gy = cfg_t.tile_dims
    assert cfg_t.lockstep_gt == 4 and (gx * gy) % 4 == 2   # a padded group
    assert not cfg_t.words_payload and np_(payload).shape[1] == 16
    assert (np_(bins.tile_nblocks) > 2 * cfg_t.batch_u).sum() >= 3
    assert (np_(tbig.tile_nbig) > 0).sum() >= 3


def test_render_v4_matches_jax(inputs):
    cfg_j, cfg_t, payload, bins, tbig, (pay_t, bins_t, tbig_t) = inputs
    tiles_j = rj.render_tiles_v4(payload, bins, tbig, np.float32(1.0), cfg_j,
                                 lowp=False, interpret=True)
    tiles_t = r4.render_tiles_v4(pay_t, bins_t, tbig_t, torch.tensor(1.0),
                                 cfg_t)
    tj, tt = np_(tiles_j), np_(tiles_t)
    assert tj.shape == tt.shape == (2, 4 * 32 * 32, r3.OUT_CH)
    img_j, tf_j = rj.assemble_image_v4(tiles_j, cfg_j)
    img_t, tf_t = r4.assemble_image_v4(tiles_t, cfg_t)
    img_j, img_t = np_(img_j), np_(img_t)
    assert img_t.shape == (4, H, W) and np.isfinite(img_t).all()
    p = psnr(np.clip(img_j[:3], 0, 1), np.clip(img_t[:3], 0, 1))
    assert p >= 45.0, p
    assert np.abs(np_(tf_j) - np_(tf_t)).max() <= 1e-2
    # channels 6-7 (nb, nbig), padded slots included
    np.testing.assert_array_equal(tj[..., 6:8], tt[..., 6:8])


@pytest.mark.parametrize("gt_", [4, 3, 2, 1])
def test_v4_bit_equal_to_cooked_v3(inputs, gt_):
    _, cfg_t, _, _, _, (pay_t, bins_t, tbig_t) = inputs
    cfg = cfg_t.replace(lockstep_gt=gt_)
    for early_exit in (True, False):
        t4 = r4.render_tiles_v4(pay_t, bins_t, tbig_t, torch.tensor(1.0),
                                cfg, early_exit=early_exit)
        t3 = r3.render_tiles_v3(pay_t, bins_t, tbig_t, torch.tensor(1.0),
                                cfg, early_exit=early_exit)
        for a, b in zip(r4.assemble_image_v4(t4, cfg),
                        r3.assemble_image_v3(t3, cfg)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(
            r4.tile_channels_v4(t4, cfg).numpy(),
            r3.tile_channels_v3(t3, cfg).numpy())


@pytest.mark.parametrize("chunk", [1, 4])
def test_plain_render_in_tile_chunks(inputs, chunk, monkeypatch):
    """Tiles are independent: the plain versions composited ``chunk`` tiles
    at a time (6 tiles: chunks of 4 and 2; v4's 8 padded slots: two of 4)
    give the whole frame's result."""
    _, cfg, _, _, _, (pay_t, bins_t, tbig_t) = inputs
    rows, bigla, U, mb = r3.tile_inputs(bins_t, tbig_t, torch.tensor(1.0),
                                        cfg)
    args = (rows, pay_t, tbig_t.bigpay, bigla, cfg, U, mb)
    GT = cfg.lockstep_gt
    whole3 = r3.render_tiles_v3_reference(*args, True).numpy()
    whole4 = r4.render_tiles_v4_reference(*args, GT, True).numpy()
    monkeypatch.setattr(r3, "REFERENCE_CHUNK",
                        chunk * cfg.tile_size ** 2 * U * 128)
    np.testing.assert_array_equal(
        r3.render_tiles_v3_reference(*args, True).numpy(), whole3)
    np.testing.assert_array_equal(
        r4.render_tiles_v4_reference(*args, GT, True).numpy(), whole4)


@pytest.mark.parametrize("size,gt_", [((96, 64), 4), ((160, 96), 4),
                                      ((64, 96), 2)])
def test_layout_helpers_bit_equal(size, gt_):
    w, h = size
    cfg_j = gj.RasterizerConfig(width=w, height=h, kernel="v4",
                                lockstep_gt=gt_).fast_defaults()
    cfg_t = gt.RasterizerConfig(width=w, height=h, kernel="v4",
                                lockstep_gt=gt_).fast_defaults()
    gx, gy = cfg_t.tile_dims
    T4 = -(-gx * gy // gt_)
    rng = np.random.default_rng(gt_)
    tiles = rng.normal(size=(T4, gt_ * 32 * 32, r3.OUT_CH)).astype(
        np.float32)
    for a, b in zip(rj.assemble_image_v4(tiles, cfg_j),
                    r4.assemble_image_v4(torch.from_numpy(tiles), cfg_t)):
        np.testing.assert_array_equal(np_(a), np_(b))
    np.testing.assert_array_equal(
        np_(rj.tile_channels_v4(tiles, cfg_j)),
        np_(r4.tile_channels_v4(torch.from_numpy(tiles), cfg_t)))
