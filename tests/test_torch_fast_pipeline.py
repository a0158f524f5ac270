"""Port vs JAX package: the whole fast frame (ops/fast_pipeline.py).

``render_frame_fast`` at 128x128 on a mortonized 4000-splat scene, the port
(CPU tensors: every stage's plain version) against the JAX package with
``lowp=False``, in three configurations:

  * ``fast_defaults()``: the fused projection, the words and v3;
  * ``RasterizerConfig(kernel="v4").fast_defaults()``: the fused
    projection, the cooked payload and the v4 lockstep render (GT 4);
  * ``RasterizerConfig(quality="fast")``: the readable projection, screen
    clustering, tile 16 and the cooked payload into v3.

Each holds RGB PSNR >= 40 dB (the render test's bf16 allowance plus an ulp
of projection difference feeding the blocks), equal pair and overflow
counts, the same tile lists, and bit-equal picking on every occupied tile.
The ported cases of tests/test_fast_pipeline.py follow.
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


CONFIGS = {
    "fast_defaults": (dict(), True),
    "v4": (dict(kernel="v4"), True),
    "quality_fast": (dict(quality="fast"), False),
}


def _frames(name):
    kw, fast = CONFIGS[name]
    # the fused projection reads planar SH; the readable one (P, 16, 3)
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        4000, seed=5, extent=2.5, scale_range=(0.01, 0.08))),
        planar_sh=fast)
    cfg_j = gj.RasterizerConfig(width=128, height=128, **kw)
    cfg_t = gt.RasterizerConfig(width=128, height=128, **kw)
    if fast:
        cfg_j, cfg_t = cfg_j.fast_defaults(), cfg_t.fast_defaults()
    oj = fpj.render_frame_fast(cj, make_uniforms(gj.Camera.reset_pose(),
                                                 cfg_j), cfg_j, lowp=False)
    ct = port_cloud(cj)
    ot = gt.render_frame_fast(ct, gt.make_uniforms(
        gt.Camera.reset_pose(), cfg_t, device="cpu"), cfg_t)
    return cj, ct, cfg_j, cfg_t, oj, ot


@pytest.fixture(scope="module", params=list(CONFIGS))
def frames(request):
    return _frames(request.param)


def test_frame_matches_jax(frames):
    _, _, _, cfg_t, oj, ot = frames
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
    np.testing.assert_array_equal(np_(oj.tile_nblocks),
                                  np_(ot.tile_nblocks))
    assert ot.payload.dtype == (torch.int32 if cfg_t.words_payload
                                else torch.float32)


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
    st = gt.render_frame_fast(ct, gt.make_uniforms(gt.Camera(), cfg_t,
                                                   device="cpu"), cfg_t)
    assert int(st.stats.num_pairs) == 0
    et = np_(gt.pick_splat_position_fast(st, 5, ct, 1.0, cfg_t))
    assert np.all(np.isinf(et))


def _scene(seed, extent):
    return gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        2000, seed=seed, extent=extent, scale_range=(0.02, 0.1),
        device="cpu")))


def test_early_exit_changes_nothing():
    cfg = gt.RasterizerConfig(width=64, height=64,
                              reference_boundary_quirk=False).fast_defaults()
    cloud = _scene(7, 2.0)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    a = gt.render_frame_fast(cloud, uni, cfg, early_exit=True)
    b = gt.render_frame_fast(cloud, uni, cfg, early_exit=False)
    np.testing.assert_allclose(a.image.numpy(), b.image.numpy(), atol=1e-6)


def test_heatmap_and_picking_fast():
    cfg = gt.RasterizerConfig(width=64, height=64,
                              reference_boundary_quirk=False).fast_defaults()
    cloud = _scene(3, 1.5)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
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


def test_v4_with_words_payload_raises():
    """The lockstep v4 kernel reads the cooked payload only; the word
    payload with kernel="v4" raises ValueError, as in the JAX package."""
    cfg = gt.RasterizerConfig(width=64, height=64, kernel="v4",
                              words_payload=True, tile_size=32, batch_u=2,
                              projection_kernel=True, quality="fast")
    cloud = _scene(3, 1.5)
    with pytest.raises(ValueError, match="words_payload"):
        gt.render_frame_fast(cloud, gt.make_uniforms(
            gt.Camera.reset_pose(), cfg, device="cpu"), cfg)


def test_words_payload_matches_cooked():
    """tests/test_fast_pipeline.py's case on the port: the word payload
    (features cooked in the render) against the cooked 16-row payload, both
    on the v3 render: >= 60 dB, equal stats, equal picks."""
    cloud = gt.mortonize(gt.synthetic_scene(
        30_000, seed=11, extent=3.0, scale_range=(0.01, 0.25),
        device="cpu"))
    cfg = gt.RasterizerConfig(width=256, height=256)
    cfgw = cfg.replace(words_payload=True)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    fc = gt.render_frame_fast(cloud, uni, cfg)
    fw = gt.render_frame_fast(cloud, uni, cfgw)
    assert fc.payload.dtype == torch.float32
    assert fw.payload.dtype == torch.int32
    assert int(fc.stats.num_pairs) == int(fw.stats.num_pairs)
    assert int(fc.stats.num_overflow) == int(fw.stats.num_overflow)
    a, b = fc.image.numpy(), fw.image.numpy()
    mse = float(((a - b) ** 2).mean())
    p = 10 * np.log10(max(float(np.abs(a).max()), 1.0) ** 2
                      / max(mse, 1e-12))
    assert p > 60.0, f"words vs cooked PSNR {p:.1f} dB"
    for tile in (120, 0, 255):
        np.testing.assert_array_equal(
            gt.pick_splat_position_fast(fc, tile, cloud, 1.0, cfg).numpy(),
            gt.pick_splat_position_fast(fw, tile, cloud, 1.0, cfgw).numpy())
