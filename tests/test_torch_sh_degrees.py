"""Port vs JAX package at SH degrees 0, 1 and 2: both projections.

``benchmarks/configs.py`` runs its first workload at SH degree 0, which
the other parity tests (all at the default degree 3) never set. Here the
readable projection (``ops/projection.project_splats``) and the fused
projection's plain version (``ops/projection_kernel.project_words``) are
held to the JAX package's at each lower degree, on seeded scenes of 8192
splats, at tests/test_torch_projection.py's tolerances: XLA on the CPU
and torch round exp, log, pow and rsqrt differently by an ulp, so integer
words may differ on at most 0.01% of the splats (and there by one depth16
step), f16 halves and rgb9e5 fields by one unit in the last place,
positions by 1e-2 px, conic and colour by 1e-4 relative.
"""

import numpy as np
import pytest

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops.projection import project_splats
from godotgaussiansplatting_torch.ops.projection_kernel import project_words
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection import (
    project_splats as project_splats_j)
from godotgaussiansplatting_tpu.ops.projection_pallas import (
    project_words as project_words_j)

from _torch_parity import np_, port_cloud

ALLOW = 1e-4
N = 8192
DEGREES = [0, 1, 2]


def _scene(degree):
    return gj.mortonize(gj.synthetic_scene(
        N, seed=20 + degree, extent=3.0, scale_range=(0.005, 0.2)))


def _cfgs(degree, **kw):
    kw = dict(width=384, height=256, sh_degree=degree, **kw)
    return gj.RasterizerConfig(**kw), gt.RasterizerConfig(**kw)


@pytest.mark.parametrize("degree", DEGREES)
def test_readable_projection_matches_jax(degree):
    cj = fast_cloud_view(_scene(degree), planar_sh=False)
    cfg_j, cfg_t = _cfgs(degree, quality="fast")
    uj = make_uniforms(gj.Camera.reset_pose(), cfg_j)
    pj = project_splats_j(cj.means, cj.cov3d, cj.opacity, cj.sh,
                          cj.upload_time, uj.view, uj.proj, uj.camera_pos,
                          uj.model_scale, uj.time, cfg_j)
    ct = port_cloud(cj)
    ut = gt.make_uniforms(gt.Camera.reset_pose(), cfg_t, device="cpu")
    pt = project_splats(ct.means, ct.cov3d, ct.opacity, ct.sh,
                        ct.upload_time, ut.view, ut.proj, ut.camera_pos,
                        ut.model_scale, ut.time, cfg_t)
    vj, vt = np_(pj.valid), np_(pt.valid)
    np.testing.assert_array_equal(vj, vt)
    assert vt.sum() > vt.size // 4, "scene must be mostly visible"
    dj = np_(pj.depth16).astype(np.int64)[vj]
    dt = np_(pt.depth16).astype(np.int64)[vt]
    assert (dj != dt).sum() <= ALLOW * vj.size
    assert np.abs(dj - dt).max() <= 1
    assert np.abs(np_(pj.image_pos)[vj] - np_(pt.image_pos)[vt]).max() < 1e-2
    np.testing.assert_allclose(np_(pt.conic)[vt], np_(pj.conic)[vj],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np_(pt.color)[vt], np_(pj.color)[vj],
                               rtol=1e-4, atol=1e-5)


def _f16_halves(w):
    w = w.view(np.uint32).astype(np.int64)
    return [((w >> sh) & 0xFFFF).astype(np.uint16).view(np.int16)
            .astype(np.int64) for sh in (0, 16)]


@pytest.mark.parametrize("degree", DEGREES)
def test_fused_projection_words_match_jax(degree):
    cj = fast_cloud_view(_scene(degree))
    cfg_j, cfg_t = (c.fast_defaults() for c in _cfgs(degree))
    uj = make_uniforms(gj.Camera.reset_pose(), cfg_j)
    wj = project_words_j(cj.means, cj.cov3d, cj.opacity, cj.sh,
                         cj.upload_time, uj.view, uj.proj, uj.camera_pos,
                         uj.model_scale, uj.time, cfg_j,
                         num_splats=cj.num_splats)
    ct = port_cloud(cj)
    ut = gt.make_uniforms(gt.Camera.reset_pose(), cfg_t, device="cpu")
    wt = project_words(ct.means, ct.cov3d, ct.opacity, ct.sh,
                       ct.upload_time, ut.view, ut.proj, ut.camera_pos,
                       ut.model_scale, ut.time, cfg_t,
                       num_splats=ct.num_splats)
    wj = {f: np_(getattr(wj, f)).reshape(-1) for f in wj._fields}
    wt = {f: np_(getattr(wt, f)).reshape(-1) for f in wt._fields}
    kj = wj["key"].view(np.uint32).astype(np.int64)
    kt = wt["key"].view(np.uint32).astype(np.int64)
    bad = kj != kt
    assert bad.sum() <= ALLOW * kj.size
    assert np.all(kj[bad] >> 16 == kt[bad] >> 16)
    assert np.all(np.abs((kj[bad] & 0xFFFF) - (kt[bad] & 0xFFFF)) <= 1)
    m = (kj != 0xFFFFFFFF) & (kt != 0xFFFFFFFF)
    assert m.sum() > kj.size // 4, "scene must be mostly visible"
    for f in ("ix", "iy"):
        assert np.abs(wj[f].view(np.float32)[m]
                      - wt[f].view(np.float32)[m]).max() < 1e-2, f
    for f in ("pc1", "pc2"):
        for a, b in zip(_f16_halves(wj[f][m]), _f16_halves(wt[f][m])):
            assert np.all(np.abs(a - b) <= 1), f
    a = wj["rgb9"][m].view(np.uint32).astype(np.int64)
    b = wt["rgb9"][m].view(np.uint32).astype(np.int64)
    ea, eb = a >> 27, b >> 27
    assert np.all(np.abs(ea - eb) <= 1)
    for sh in (0, 9, 18):
        va = ((a >> sh) & 0x1FF) * np.exp2(ea.astype(np.float64) - 24)
        vb = ((b >> sh) & 0x1FF) * np.exp2(eb.astype(np.float64) - 24)
        step = np.exp2(np.maximum(ea, eb).astype(np.float64) - 24)
        assert np.all(np.abs(va - vb) <= step * 1.0001), sh
    assert (wj["bkey"] != wt["bkey"]).sum() <= ALLOW * kj.size


def test_lower_degrees_change_the_colour():
    """Degree 0 ignores the higher coefficients and degree 2 reads them:
    the port's readable projection gives different colours at the two
    degrees on one scene (the degree reaches the plain version)."""
    ct = port_cloud(fast_cloud_view(_scene(0), planar_sh=False))
    colours = []
    for degree in (0, 2):
        cfg = gt.RasterizerConfig(width=384, height=256, sh_degree=degree,
                                  quality="fast")
        u = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
        p = project_splats(ct.means, ct.cov3d, ct.opacity, ct.sh,
                           ct.upload_time, u.view, u.proj, u.camera_pos,
                           u.model_scale, u.time, cfg)
        colours.append(np_(p.color)[np_(p.valid)])
    assert np.abs(colours[0] - colours[1]).max() > 1e-3
