"""Port vs JAX package: config, camera, load-time order and scene state.

Everything here is host-side numpy in both packages, so equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import blocks as blocks_t
from godotgaussiansplatting_tpu.ops import blocks as blocks_j
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms as uni_j

from _torch_parity import np_, port_cloud


@pytest.mark.parametrize("kw", [
    {}, {"width": 640, "height": 480}, {"tile_size": 32},
    {"batch_u": 4, "cluster": "screen"}, {"kernel": "v4"},
    {"words_payload": False}, {"render_scale": 0.5},
])
def test_config_fields_and_fast_defaults(kw):
    a = gj.RasterizerConfig(**kw)
    b = gt.RasterizerConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.fast_defaults()) == dataclasses.asdict(
        b.fast_defaults())
    for c, d in ((a, b), (a.fast_defaults(), b.fast_defaults())):
        assert c.target_size == d.target_size
        assert c.tile_dims == d.tile_dims
        assert c.num_tiles == d.num_tiles


def _cameras(mod):
    cams = [mod.Camera.reset_pose(),
            mod.Camera.reset_pose().with_yaw_pitch(30.0, -10.0),
            mod.Camera(position=np.array([0.5, -1.0, 2.0], np.float32),
                       basis_override=np.diag([1.0, -1.0, -1.0]).astype(
                           np.float32)).look_at(np.zeros(3, np.float32))]
    cams += mod.orbit_trajectory(4, radius=5.0, target=(0, 0, 6.0))
    return cams


def test_camera_matrices_and_uniforms_equal():
    cfg = gt.RasterizerConfig(width=320, height=200)
    for cj, ct in zip(_cameras(gj), _cameras(gt)):
        np.testing.assert_array_equal(cj.view_matrix(), ct.view_matrix())
        np.testing.assert_array_equal(cj.projection_matrix(320, 200),
                                      ct.projection_matrix(320, 200))
        np.testing.assert_array_equal(cj.camera_pos_ply(),
                                      ct.camera_pos_ply())
        uj = uni_j(cj, cfg, model_scale=0.7, time=3.0, heatmap=1.0)
        ut = gt.make_uniforms(ct, cfg, model_scale=0.7, time=3.0,
                              heatmap=1.0, device="cpu")
        for a, b in zip(uj, ut):
            np.testing.assert_array_equal(np_(a), np_(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_curve_orders_equal(seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(blocks_j.hilbert_order(means),
                                  blocks_t.hilbert_order(means))
    np.testing.assert_array_equal(blocks_j.morton_order(means),
                                  blocks_t.morton_order(means))
    np.testing.assert_array_equal(blocks_t.order_splats(means),
                                  blocks_t.hilbert_order(means))


@pytest.mark.parametrize("surfaces", [False, True])
def test_scene_mortonize_fast_view_bit_equal(surfaces):
    kw = dict(seed=11, extent=2.5, scale_range=(0.01, 0.2),
              surfaces=surfaces)
    cj = gj.synthetic_scene(5000, **kw)
    ct = gt.synthetic_scene(5000, **kw, device="cpu")
    for stage_j, stage_t in (
            (cj, ct),
            (gj.mortonize(cj), gt.mortonize(ct)),
            (gj.models.splats.fast_cloud_view(gj.mortonize(cj)),
             gt.fast_cloud_view(gt.mortonize(ct)))):
        assert stage_j.num_splats == stage_t.num_splats
        for f in ("means", "cov3d", "opacity", "sh", "upload_time"):
            a, b = np_(getattr(stage_j, f)), np_(getattr(stage_t, f))
            assert a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_cloud_from_numpy_round_trips():
    ct = gt.mortonize(gt.synthetic_scene(3000, seed=2, device="cpu"))
    fv = gt.fast_cloud_view(ct)
    for c in (ct, fv):
        back = gt.cloud_from_numpy(np_(c.means), np_(c.cov3d),
                                   np_(c.opacity), np_(c.sh),
                                   np_(c.upload_time), c.num_splats,
                                   device="cpu")
        for f in ("means", "cov3d", "opacity", "sh", "upload_time"):
            a, b = getattr(c, f), getattr(back, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
    # the JAX cloud maps onto the same state
    cj = gj.mortonize(gj.synthetic_scene(3000, seed=2))
    pc = port_cloud(cj)
    for f in ("means", "cov3d", "opacity", "sh", "upload_time"):
        assert torch.equal(getattr(pc, f), getattr(ct, f)), f
