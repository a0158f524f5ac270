"""The port's engine against the JAX package's, on the CPU: render_scale
(tests/test_render_scale.py), the state round trip
(tests/test_state_and_multiview.py) and:

  * the port's ``Rasterizer.image()`` against the JAX ``Rasterizer``'s on
    the same .ply bytes and camera: within 1e-3 for quality "exact"; for
    quality "fast" PSNR >= 55 dB (61.4 measured) and equal picks: the JAX
    v3 kernel rounds alphas, colours and weights to bf16, with ``lowp``
    on (as its engine renders) and off alike, and the port keeps f32, so
    the two are 8.5e-3 apart at most, not 1e-3;
  * a state saved by the JAX package loads in the port and renders the
    same frame.
"""

import os

import numpy as np
import pytest

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.engine.state import load_state, save_state
from godotgaussiansplatting_torch.ops.oracle import oracle_render
from godotgaussiansplatting_tpu.engine.rasterizer import Rasterizer as JRast
from godotgaussiansplatting_tpu.engine.state import save_state as j_save

from _torch_parity import model_blob, psnr


def _rast(source, **kw):
    return gt.Rasterizer(source, device="cpu", **kw)


def test_half_scale_matches_oracle():
    cfg = gt.RasterizerConfig(width=256, height=192, render_scale=0.5)
    assert cfg.target_size == (128, 96)
    cloud = gt.synthetic_scene(800, seed=11, extent=2.0,
                               scale_range=(0.01, 0.12), device="cpu")
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    ref_img, _ = oracle_render(cloud, uni.view.numpy(), uni.proj.numpy(),
                               uni.camera_pos.numpy(), cfg)
    out = gt.render_frame(cloud, uni, cfg, tile_capacity=512)
    assert out.image.shape == (96, 128, 4)
    np.testing.assert_allclose(out.image.numpy(), ref_img, atol=1e-3)


def test_engine_resize_via_render_scale():
    cloud = gt.synthetic_scene(2000, seed=4, extent=2.0,
                               scale_range=(0.02, 0.1), device="cpu")
    r = _rast(cloud, texture_size=(192, 128), tile_capacity=512)
    full = r.rasterize(sync=True).image.numpy()
    assert full.shape == (128, 192, 4)
    r.render_scale = 0.5
    half = r.rasterize(sync=True).image.numpy()
    assert half.shape == (64, 96, 4)
    assert r.texture_size == (96, 64)
    ds = full.reshape(64, 2, 96, 2, 4).mean((1, 3))
    corr = np.corrcoef(ds[..., :3].ravel(), half[..., :3].ravel())[0, 1]
    assert corr > 0.95


def test_picking_roundtrip_under_render_scale():
    n = 64
    rng = np.random.default_rng(9)
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = rng.uniform(-0.8, 0.8, n)
    means[:, 1] = rng.uniform(-0.6, 0.6, n)
    means[:, 2] = rng.uniform(2.5, 3.5, n)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = 1.5
    cloud = gt.from_arrays(means, np.full((n, 3), 0.05, np.float32),
                           np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1)),
                           np.full(n, 0.95, np.float32), sh, device="cpu")
    for rs in (1.0, 0.5):
        r = _rast(cloud, texture_size=(256, 192), tile_capacity=256)
        r.render_scale = rs
        r.rasterize(sync=True)
        tw, th = r.texture_size
        view = r.camera.view_matrix()
        proj = r.camera.projection_matrix(tw, th)
        p = means[0]
        vp = view[:3, :3] @ p + view[:3, 3]
        clip = proj[:3, :3] @ vp + proj[:3, 3]
        cw = proj[3, :3] @ vp + proj[3, 3]
        win = ((clip[:2] / cw) * 0.5 + 0.5) * np.array([256, 192])
        pos = r.get_splat_position((float(win[0]), float(win[1])))
        assert np.all(np.isfinite(pos)), f"pick missed at render_scale {rs}"
        d = np.linalg.norm(pos - np.array([-p[0], -p[1], p[2]]) * [-1, -1, 1])
        assert d < 1.5


def test_state_roundtrip(tmp_path):
    cloud = gt.synthetic_scene(1500, seed=2, extent=2.0,
                               scale_range=(0.02, 0.1), device="cpu")
    r = _rast(cloud, texture_size=(64, 64), quality="exact",
              tile_capacity=256)
    r.model_scale = 1.5
    r.should_enable_heatmap = True
    img0 = r.image()
    p = os.path.join(tmp_path, "state.npz")
    save_state(p, r)
    r2 = load_state(p, device="cpu")
    assert r2.model_scale == 1.5 and r2.should_enable_heatmap
    assert r2.cloud.num_splats == r.cloud.num_splats
    np.testing.assert_allclose(r2.image(), img0, atol=1e-5)


def test_jax_saved_state_loads_in_the_port(tmp_path):
    cloud = gj.synthetic_scene(1500, seed=2, extent=2.0,
                               scale_range=(0.02, 0.1))
    rj = JRast(cloud, texture_size=(64, 48), quality="exact")
    rj.model_scale = 1.25
    rj.should_enable_heatmap = True
    rj.camera = rj.camera.with_yaw_pitch(175, -3)
    p = os.path.join(tmp_path, "jax_state.npz")
    j_save(p, rj)
    img_j = rj.image()
    r = load_state(p, device="cpu")
    assert (r.model_scale, r.should_enable_heatmap) == (1.25, True)
    assert r.texture_size == (64, 48)
    np.testing.assert_allclose(r.image(), img_j, atol=1e-3)


@pytest.mark.parametrize("quality", ["exact", "fast"])
def test_image_matches_the_jax_rasterizer(quality):
    blob = model_blob(600, seed=7)
    rj = JRast(blob, texture_size=(64, 64), quality=quality,
               tile_capacity=256)
    rt = _rast(blob, texture_size=(64, 64), quality=quality,
               tile_capacity=256)
    for r in (rj, rt):
        r.camera = r.camera.with_yaw_pitch(172, 4)
        r.rasterize(sync=True)
    img_j, img_t = rj.image(), rt.image()
    assert img_t.shape == img_j.shape == (64, 64, 4)
    if quality == "exact":
        np.testing.assert_allclose(img_t, img_j, atol=1e-3, rtol=0)
    else:
        assert psnr(img_t[..., :3], img_j[..., :3]) >= 55.0
    for px in ((32, 32), (20, 40), (50, 12)):
        np.testing.assert_array_equal(rt.get_splat_position(px),
                                      rj.get_splat_position(px))
