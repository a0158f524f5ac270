"""The port's exact path on the CPU against the JAX package's.

  * ``render_tiles``' plain version against JAX ``render_tiles`` (atol
    1e-5), heatmap 0 and 1, at tile 16 and 32, with a non-power-of-two
    ``tile_capacity`` (truncated at ceil(C / 512) * 512 slots, not C) and a
    ``pixel_offset``;
  * ``render_frame`` against the port's numpy oracle and JAX
    ``render_frame_jit`` (atol 1e-3; ``num_pairs`` equal to the oracle's)
    on the scenes of tests/test_pipeline_vs_oracle.py: three random scenes,
    the empty view, model scale and the fade-in, and the giant and tier
    configurations;
  * ``pick_splat_position`` equal to JAX's on every tile of a frame, and
    ``render_multiview`` equal to single frames.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import render_exact as tr
from godotgaussiansplatting_torch.ops.oracle import oracle_render
from godotgaussiansplatting_tpu.ops import render as jr

from _torch_parity import np_, port_cloud


def _tile_lists(seed, cfg, P=600, max_count=1400):
    """Random per-tile sorted lists over P random splats: positions over
    the frame, positive definite conics of 3-40 px, mostly faint opacities
    so that long lists stay unsaturated and the cap decides, some opaque."""
    rng = np.random.default_rng(seed)
    gx, gy = cfg.tile_dims
    T = gx * gy
    w, h = cfg.target_size
    pos = np.stack([rng.uniform(-8, w + 8, P), rng.uniform(-8, h + 8, P)],
                   1).astype(np.float32)
    sig = rng.uniform(3, 40, (P, 2))
    rho = rng.uniform(-0.6, 0.6, P)
    a = sig[:, 0] ** 2
    c = sig[:, 1] ** 2
    b = rho * sig[:, 0] * sig[:, 1]
    det = a * c - b * b
    conic = np.stack([c / det, -b / det, a / det], 1).astype(np.float32)
    alpha = np.where(rng.random(P) < 0.85, rng.uniform(0.001, 0.01, P),
                     rng.uniform(0.3, 0.99, P))
    color = np.concatenate([rng.uniform(0, 1.5, (P, 3)), alpha[:, None]],
                           1).astype(np.float32)
    counts = rng.integers(0, max_count, T)
    counts[rng.random(T) < 0.2] = 0
    end = np.cumsum(counts).astype(np.int32)
    start = (end - counts).astype(np.int32)
    K = int(end[-1]) + 7
    values = rng.integers(0, P, K).astype(np.int32)
    return values, start, end, pos, conic, color


@functools.lru_cache(maxsize=None)
def _jax_render(cfg, tile_capacity, pixel_offset):
    return jax.jit(functools.partial(jr.render_tiles, cfg=cfg,
                                     tile_capacity=tile_capacity,
                                     pixel_offset=pixel_offset))


@pytest.mark.parametrize("tile,capacity,offset", [
    (16, 1000, (0, 0)), (16, 2048, (16, 32)), (32, 300, (0, 0)),
    (16, 256, (5, 3))])
def test_render_tiles_plain_matches_jax(tile, capacity, offset):
    kw = dict(width=80, height=70, tile_size=tile)
    cfg_t, cfg_j = gt.RasterizerConfig(**kw), gj.RasterizerConfig(**kw)
    arrays = _tile_lists(tile + capacity, cfg_t)
    for hm in (0.0, 1.0):
        out_j = _jax_render(cfg_j, capacity, offset)(
            *(jnp.asarray(a) for a in arrays), jnp.float32(hm))
        out_t = tr.render_tiles(*(torch.from_numpy(a) for a in arrays),
                                torch.tensor(hm), cfg_t,
                                tile_capacity=capacity, pixel_offset=offset)
        np.testing.assert_allclose(out_t.image.numpy(), np_(out_j.image),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(out_t.tile_t0.numpy(), np_(out_j.tile_t0),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(out_t.tile_counts.numpy(),
                                      np_(out_j.tile_counts))


def test_non_power_of_two_capacity_truncates_at_whole_chunks():
    """C = 1000 composites ceil(1000 / 512) * 512 = 1024 slots a tile: the
    same image as C = 1024, and not that of C = 512."""
    cfg = gt.RasterizerConfig(width=80, height=70)
    arrays = [torch.from_numpy(a) for a in _tile_lists(7, cfg)]
    assert tr.effective_capacity(1000) == 1024
    assert tr.effective_capacity(300) == 300
    hf = torch.tensor(0.0)
    imgs = {c: tr.render_tiles(*arrays, hf, cfg, tile_capacity=c).image
            for c in (512, 1000, 1024)}
    assert torch.equal(imgs[1000], imgs[1024])
    assert float((imgs[1000] - imgs[512]).abs().max()) > 1e-3
    # the tile batch changes no pixel
    other = tr.render_tiles_reference(*arrays, hf, cfg, tile_capacity=1000,
                                      tile_batch=5)
    assert torch.equal(other.image, imgs[1000])


def _frame_both(cloud_j, cfg_kw, cam=None, tile_capacity=512, **uni):
    """(port frame, port oracle (image, info), JAX frame) of one view."""
    cfg_t, cfg_j = gt.RasterizerConfig(**cfg_kw), gj.RasterizerConfig(**cfg_kw)
    cam = cam or gt.Camera.reset_pose()
    ut = gt.make_uniforms(cam, cfg_t, device="cpu", **uni)
    uj = gj.make_uniforms(gj.Camera(position=cam.position, basis=cam.basis),
                          cfg_j, **uni)
    ct = port_cloud(cloud_j)
    out_t = gt.render_frame(ct, ut, cfg_t, tile_capacity=tile_capacity)
    ref = oracle_render(ct, ut.view.numpy(), ut.proj.numpy(),
                        ut.camera_pos.numpy(), cfg_t,
                        model_scale=uni.get("model_scale", 1.0),
                        time=uni.get("time", 1e9),
                        heatmap_factor=uni.get("heatmap", 0.0))
    out_j = gj.render_frame_jit(cloud_j, uj, cfg_j,
                                tile_capacity=tile_capacity)
    return out_t, ref, out_j


def _hold(out_t, ref, out_j):
    img_ref, info = ref
    img = out_t.image.numpy()
    assert int(out_t.stats.num_overflow) == 0
    assert int(out_t.stats.num_pairs) == info["num_pairs"]
    assert int(out_t.stats.num_pairs) == int(out_j.stats.num_pairs)
    np.testing.assert_allclose(img, img_ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(img, np_(out_j.image), atol=1e-3, rtol=0)


@pytest.mark.parametrize("seed,n,heatmap", [(0, 500, 0.0), (1, 2000, 0.0),
                                            (2, 800, 1.0)])
def test_frame_matches_oracle_and_jax(seed, n, heatmap):
    cloud = gj.synthetic_scene(n, seed=seed, extent=2.0,
                               scale_range=(0.01, 0.12))
    out_t, ref, out_j = _frame_both(cloud, dict(width=128, height=96),
                                    heatmap=heatmap)
    assert int(out_t.stats.max_tile_count) <= 512
    _hold(out_t, ref, out_j)


def test_empty_view_is_black():
    cloud = gj.synthetic_scene(10, seed=0)
    out_t, ref, out_j = _frame_both(
        cloud, dict(width=64, height=64),
        cam=gt.Camera.reset_pose().with_yaw_pitch(0.0, 0.0),
        tile_capacity=64)
    assert int(out_t.stats.num_pairs) == 0
    img = out_t.image.numpy()
    np.testing.assert_array_equal(img[:, :, :3], 0.0)
    np.testing.assert_array_equal(img[:, :, 3], 1.0)
    _hold(out_t, ref, out_j)


@pytest.mark.parametrize("model_scale,time", [(0.5, 1e9), (2.0, 1e9),
                                              (1.0, 0.5)])
def test_model_scale_and_fade_in(model_scale, time):
    cloud = gj.synthetic_scene(300, seed=3, extent=1.5,
                               scale_range=(0.02, 0.1))
    _hold(*_frame_both(cloud, dict(width=96, height=64),
                       model_scale=model_scale, time=time))


# tests/test_pipeline_vs_oracle.py::test_giant_splat_dense_emission's four
# configurations: (config, whether pairs are dropped)
GIANT_CONFIGS = {
    "giants": (dict(giant_splat_capacity=64), False),
    "tiers_only": (dict(giant_splat_capacity=0,
                        exact_tiers=((16, 16), (256, 64))), False),
    "truncating_cap": (dict(giant_splat_capacity=0, exact_tiers=()), True),
    "giant_cap_below_count": (dict(giant_splat_capacity=2, exact_tiers=()),
                              True),
}


@pytest.mark.parametrize("name", sorted(GIANT_CONFIGS))
def test_giant_and_tier_emission(name):
    kw, truncates = GIANT_CONFIGS[name]
    cloud = gj.synthetic_scene(60, seed=5, extent=1.5,
                               scale_range=(0.2, 0.9))
    out_t, ref, out_j = _frame_both(
        cloud, dict(width=128, height=96, max_tiles_per_splat=4, **kw))
    dropped = int(out_t.stats.num_overflow)
    assert dropped == int(out_j.stats.num_overflow)
    assert (dropped > 0) == truncates
    if truncates:   # the oracle never drops a pair: hold to JAX only
        assert int(out_t.stats.num_pairs) + dropped == ref[1]["num_pairs"]
        np.testing.assert_allclose(out_t.image.numpy(), np_(out_j.image),
                                   atol=1e-3, rtol=0)
    else:
        _hold(out_t, ref, out_j)


@pytest.mark.parametrize("view", ["scene", "empty"])
def test_pick_matches_jax_on_every_tile(view):
    if view == "scene":
        cloud = gj.synthetic_scene(2000, seed=1, extent=2.0,
                                   scale_range=(0.01, 0.12))
        cam = None
    else:
        cloud = gj.synthetic_scene(10, seed=0)
        cam = gt.Camera.reset_pose().with_yaw_pitch(0.0, 0.0)
    out_t, _, out_j = _frame_both(cloud, dict(width=128, height=96), cam=cam)
    T = out_t.tile_start.shape[0]
    np.testing.assert_array_equal(out_t.tile_start.numpy(),
                                  np_(out_j.tile_start))
    np.testing.assert_array_equal(out_t.tile_end.numpy(), np_(out_j.tile_end))
    picks_t = np.stack([gt.pick_splat_position(out_t, t).numpy()
                        for t in range(T)])
    picks_j = np.stack([np_(gj.pick_splat_position(out_j, t))
                        for t in range(T)])
    if view == "scene":
        assert np.isfinite(picks_t).all()
    else:
        assert np.isinf(picks_t).all()
    np.testing.assert_array_equal(picks_t, picks_j)


def test_multiview_matches_single_frames():
    cfg = gt.RasterizerConfig(width=64, height=64)
    cloud = gt.synthetic_scene(1000, seed=4, extent=2.0,
                               scale_range=(0.02, 0.1), device="cpu")
    cams = [gt.Camera.reset_pose().with_yaw_pitch(180 + 20 * i, -4 * i)
            for i in range(3)]
    unis = [gt.make_uniforms(c, cfg, device="cpu") for c in cams]
    batched = gt.FrameUniforms(*(torch.stack(f) for f in zip(*unis)))
    imgs = gt.render_multiview(cloud, batched, cfg, tile_capacity=256)
    assert imgs.shape == (3, 64, 64, 4)
    for i, u in enumerate(unis):
        single = gt.render_frame(cloud, u, cfg, tile_capacity=256).image
        assert torch.equal(imgs[i], single)
