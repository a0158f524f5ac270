"""The port's frames against the golden-image corpus (tests/golden).

The corpus holds exact-mode renders of tests/golden/scene.ply. The port's
exact frame meets the JAX package's own bar on all three views
(tests/test_golden_images.py:54-67): at most 2 u8 steps off, and fewer than
0.5% of pixels 2 off. Under fast_defaults() the port's PSNR against view 0
and view 2 may be at most 1 dB below the JAX package's PSNR on the same
config (its fast path, as shipped, in interpret mode): the port must lose
nothing the reference fast path keeps.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.models.ply import load_splats as t_load
from godotgaussiansplatting_torch.utils.image import read_png, to_uint8
from godotgaussiansplatting_tpu.models.ply import load_splats
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops.fast_pipeline import render_frame_fast

from _torch_parity import np_, port_cloud

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _cameras(mod):
    """The corpus cameras (tests/golden/generate.py), rebuilt as ``mod``'s
    Camera (the two packages' cameras are the same numpy class layout)."""
    spec = importlib.util.spec_from_file_location(
        "golden_generate", os.path.join(HERE, "generate.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return [mod.Camera(position=c.position, basis=c.basis, fov_y=c.fov_y,
                       znear=c.znear, zfar=c.zfar,
                       basis_override=c.basis_override)
            for c in gen.cameras()]


def _meta():
    with open(os.path.join(HERE, "meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("view", [0, 1, 2])
def test_exact_golden_within_2_lsb(view):
    meta = _meta()
    size = meta["size"]
    cloud = t_load(os.path.join(HERE, "scene.ply"), upload_time=-1e9,
                   device="cpu")
    cfg = gt.RasterizerConfig(width=size, height=size,
                              max_tiles_per_splat=256)
    uni = gt.make_uniforms(_cameras(gt)[view], cfg, device="cpu")
    out = gt.render_frame(cloud, uni, cfg,
                          tile_capacity=meta["tile_capacity"])
    assert int(out.stats.num_overflow) == 0
    ref = read_png(os.path.join(HERE, f"view{view}.png"))
    diff = np.abs(to_uint8(out.image).astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2, f"view{view}: max u8 diff {diff.max()}"
    assert float((diff > 1).mean()) < 0.005


@pytest.fixture(scope="module")
def golden():
    size = _meta()["size"]
    cj = fast_cloud_view(gj.mortonize(load_splats(
        os.path.join(HERE, "scene.ply"), upload_time=-1e9)))
    return cj, port_cloud(cj), size


def _psnr_u8(img, ref):
    got = to_uint8(np_(img)).astype(np.float32)
    mse = float(np.mean((got - ref.astype(np.float32)) ** 2))
    return 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("view", [0, 2])
def test_fast_golden_within_1db_of_jax(golden, view):
    cj, ct, size = golden
    ref = read_png(os.path.join(HERE, f"view{view}.png"))
    cfg_j = gj.RasterizerConfig(width=size, height=size,
                                max_tiles_per_splat=256).fast_defaults()
    cfg_t = gt.RasterizerConfig(width=size, height=size,
                                max_tiles_per_splat=256).fast_defaults()
    cam_j, cam_t = _cameras(gj)[view], _cameras(gt)[view]
    img_j = render_frame_fast(cj, gj.make_uniforms(cam_j, cfg_j), cfg_j,
                              interpret=True).image
    img_t = gt.render_frame_fast(
        ct, gt.make_uniforms(cam_t, cfg_t, device="cpu"), cfg_t).image
    p_j, p_t = _psnr_u8(img_j, ref), _psnr_u8(img_t, ref)
    assert p_t >= p_j - 1.0, (p_t, p_j)
    assert p_t >= 35.0, p_t
