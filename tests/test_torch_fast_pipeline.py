"""Port vs JAX package: the whole fast frame (ops/fast_pipeline.py).

``render_frame_fast`` under fast_defaults() at 128x128 on a mortonized
4000-splat scene, the port (CPU tensors: every stage's plain version)
against the JAX package with ``lowp=False``: RGB PSNR >= 40 dB (the render
test's bf16 allowance plus an ulp of projection difference feeding the
blocks), equal pair and overflow counts, and bit-equal picking. The ported
cases of tests/test_fast_pipeline.py follow.
"""

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops import fast_pipeline as fpj
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms

from _torch_parity import np_, port_cloud, psnr


@pytest.fixture(scope="module")
def frames():
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        4000, seed=5, extent=2.5, scale_range=(0.01, 0.08))))
    cfg_j = gj.RasterizerConfig(width=128, height=128).fast_defaults()
    cfg_t = gt.RasterizerConfig(width=128, height=128).fast_defaults()
    oj = fpj.render_frame_fast(cj, make_uniforms(gj.Camera.reset_pose(),
                                                 cfg_j), cfg_j, lowp=False)
    ct = port_cloud(cj)
    ot = gt.render_frame_fast(ct, gt.make_uniforms(gt.Camera.reset_pose(),
                                                   cfg_t), cfg_t)
    return cj, ct, cfg_j, cfg_t, oj, ot


def test_frame_matches_jax(frames):
    _, _, _, _, oj, ot = frames
    a, b = np_(oj.image), np_(ot.image)
    assert a.shape == b.shape == (4, 128, 128)
    assert np.isfinite(b).all()
    p = psnr(np.clip(a[:3], 0, 1), np.clip(b[:3], 0, 1))
    assert p >= 40.0, p
    assert int(oj.stats.num_pairs) == int(ot.stats.num_pairs) > 0
    assert int(oj.stats.num_overflow) == int(ot.stats.num_overflow)
    # same blocks in the same tile lists (the payload words themselves may
    # differ by the projection's ulp allowance, tests/test_torch_projection)
    np.testing.assert_array_equal(np_(oj.tile_blocks), np_(ot.tile_blocks))


def test_picking_matches_jax(frames):
    cj, ct, cfg_j, cfg_t, oj, ot = frames
    gx, gy = cfg_t.tile_dims
    nb = np_(ot.tile_nblocks)
    occupied = [t for t in range(gx * gy) if nb[t] > 0]
    assert occupied
    for tile in occupied:
        pj = np_(fpj.pick_splat_position_fast(oj, tile, cj, 1.0, cfg_j))
        pt = np_(gt.pick_splat_position_fast(ot, tile, ct, 1.0, cfg_t))
        np.testing.assert_array_equal(pj, pt)
    # a camera facing away from the cloud leaves every tile empty: +inf
    st = gt.render_frame_fast(ct, gt.make_uniforms(gt.Camera(), cfg_t), cfg_t)
    assert int(st.stats.num_pairs) == 0
    et = np_(gt.pick_splat_position_fast(st, 5, ct, 1.0, cfg_t))
    assert np.all(np.isinf(et))


def _scene(seed, extent):
    return gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        2000, seed=seed, extent=extent, scale_range=(0.02, 0.1))))


def test_early_exit_changes_nothing():
    cfg = gt.RasterizerConfig(width=64, height=64,
                              reference_boundary_quirk=False).fast_defaults()
    cloud = _scene(7, 2.0)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    a = gt.render_frame_fast(cloud, uni, cfg, early_exit=True)
    b = gt.render_frame_fast(cloud, uni, cfg, early_exit=False)
    np.testing.assert_allclose(a.image.numpy(), b.image.numpy(), atol=1e-6)


def test_heatmap_and_picking_fast():
    cfg = gt.RasterizerConfig(width=64, height=64,
                              reference_boundary_quirk=False).fast_defaults()
    cloud = _scene(3, 1.5)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    base = gt.render_frame_fast(cloud, uni, cfg)
    hm = gt.render_frame_fast(
        cloud, uni._replace(heatmap_factor=torch.tensor(1.0)), cfg)
    assert float((hm.image - base.image).abs().max()) > 1e-3

    gx, _ = cfg.tile_dims
    tile = gx + 1          # a centre tile of the 2x2 grid at tile 32
    pos = gt.pick_splat_position_fast(base, tile, cloud, 1.0, cfg).numpy()
    assert np.all(np.isfinite(pos))
    means = cloud.means[:cloud.num_splats].numpy()
    d = np.linalg.norm(means - pos[None, :], axis=1)
    assert d.min() < 1e-4, f"picked position is not a splat mean ({d.min()})"

    small = gt.render_frame_fast(cloud, uni._replace(
        model_scale=uni.model_scale * 0.05), cfg)
    empty = gt.pick_splat_position_fast(small, 0, cloud, 0.05, cfg).numpy()
    assert np.all(np.isinf(empty)), f"empty-tile pick returned {empty}"


@pytest.mark.parametrize("knob,value", [
    ("projection_kernel", False), ("kernel", "v4"), ("words_payload", False)])
def test_unported_branches_raise(knob, value):
    cfg = gt.RasterizerConfig(width=64, height=64).fast_defaults().replace(
        **{knob: value})
    cloud = _scene(3, 1.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.render_frame_fast(cloud, gt.make_uniforms(
            gt.Camera.reset_pose(), cfg), cfg)
