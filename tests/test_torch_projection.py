"""Port vs JAX package: the fused projection (ops/projection_kernel.py)
and the readable projection (ops/projection.py).

``project_words_reference`` (what the CUDA kernel computes, and what CPU
tensors run) is held to the JAX ``project_words`` (Pallas, interpret mode)
on the shape of tests/test_projection_pallas.py's word test: 32768 splats
at 512x384 under fast_defaults(). ``project_splats`` is held to the JAX
``project_splats`` on the same scene, as that test holds the kernel to it:
the same ``valid``, depth16 within the allowance below, image positions
within 1e-2 px.

Tolerances: XLA on the CPU and torch round exp, log, pow and rsqrt
differently by an ulp, which can move a splat's radius, tile count, colour
or bigness across a rounding edge. So the integer words may differ on at
most 0.01% of the splats, and there only by one depth16 step; the f16
halves and rgb9e5 fields by one unit in the last place; positions by 1e-2 px.
"""

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import blocks2 as b2t
from godotgaussiansplatting_torch.ops.projection import project_splats
from godotgaussiansplatting_torch.ops.projection_kernel import project_words
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection import (
    project_splats as project_splats_j)
from godotgaussiansplatting_tpu.ops.projection_pallas import (
    project_words as project_words_j)

from _torch_parity import np_, port_cloud

ALLOW = 1e-4      # share of splats whose words may differ (see docstring)


def test_f16_pack_matches_ieee():
    """The port's f16 pack equals numpy's IEEE round-to-nearest-even,
    case for case as tests/test_projection_pallas.py checks the kernel's
    integer-only conversion (normals, subnormals, overflow)."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.normal(0, 1, 4096),
        rng.normal(0, 1e-6, 4096),
        rng.normal(0, 1e5, 4096),
        rng.uniform(65400, 65700, 1024),
        np.array([0.0, -0.0, 65504.0, 65519.996, 65520.0, 6.1e-5,
                  5.96e-8, 2.98e-8, 2.99e-8, -3.3, 1.0, 0.1]),
    ]).astype(np.float32)
    t = torch.from_numpy(vals)
    with np.errstate(over="ignore"):
        h_lo = vals.astype(np.float16)
        h_hi = (-vals).astype(np.float16)
    got = b2t.u32(b2t._pack_f16(t, -t)).numpy()
    want = h_lo.view(np.uint16).astype(np.int64)
    want_hi = h_hi.view(np.uint16).astype(np.int64)
    np.testing.assert_array_equal(got & 0xFFFF, want)
    np.testing.assert_array_equal(got >> 16, want_hi)
    a, b = b2t._unpack_f16(b2t._pack_f16(t, -t))
    np.testing.assert_array_equal(a.numpy(), h_lo.astype(np.float32))
    np.testing.assert_array_equal(b.numpy(), h_hi.astype(np.float32))


def test_rgb9e5_round_trip_matches_jax():
    from godotgaussiansplatting_tpu.ops import blocks2 as b2j
    rng = np.random.default_rng(1)
    rgb = np.abs(rng.normal(0, 2, (3, 20000))).astype(np.float32)
    rgb[:, :50] = 0.0
    rgb[:, 50:100] *= 1e-7
    wj = np_(b2j._pack_rgb9e5(*rgb))
    wt = b2t._pack_rgb9e5(*torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(wj, wt)
    # the port builds the power-of-two scale from bits (exact); XLA's exp2
    # on the CPU is an ulp off for the smallest exponents
    for a, b in zip(b2j._unpack_rgb9e5(np.asarray(wj).view(np.uint32)),
                    b2t._unpack_rgb9e5(torch.from_numpy(wt))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-7)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_eval_sh_color_matches_jax(degree, bf16):
    import jax.numpy as jnp
    from godotgaussiansplatting_torch.ops.sh import eval_sh_color as sh_t
    from godotgaussiansplatting_tpu.ops.sh import eval_sh_color as sh_j
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sh = rng.normal(0, 0.5, (4096, 16, 3)).astype(np.float32)
    shj = jnp.asarray(sh, jnp.bfloat16) if bf16 else jnp.asarray(sh)
    sht = torch.from_numpy(sh).to(torch.bfloat16 if bf16 else torch.float32)
    a = np_(sh_j(jnp.asarray(d), shj, degree))
    b = sh_t(torch.from_numpy(d), sht, degree).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def words_pair():
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        32768, seed=3, extent=3.0, scale_range=(0.005, 0.2))))
    cfg = gt.RasterizerConfig(width=512, height=384,
                              quality="fast").fast_defaults()
    cfg_j = gj.RasterizerConfig(width=512, height=384,
                                quality="fast").fast_defaults()
    uj = make_uniforms(gj.Camera.reset_pose(), cfg_j)
    wj = project_words_j(cj.means, cj.cov3d, cj.opacity, cj.sh,
                         cj.upload_time, uj.view, uj.proj, uj.camera_pos,
                         uj.model_scale, uj.time, cfg_j,
                         num_splats=cj.num_splats)
    ct = port_cloud(cj)
    ut = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    wt = project_words(ct.means, ct.cov3d, ct.opacity, ct.sh,
                       ct.upload_time, ut.view, ut.proj, ut.camera_pos,
                       ut.model_scale, ut.time, cfg,
                       num_splats=ct.num_splats)
    return ({f: np_(getattr(wj, f)) for f in wj._fields},
            {f: np_(getattr(wt, f)) for f in wt._fields})


def test_shapes_and_dtypes(words_pair):
    wj, wt = words_pair
    for f in wj:
        assert wj[f].shape == wt[f].shape, f
        assert wt[f].dtype == np.int32, f


def test_integer_words_bit_equal(words_pair):
    wj, wt = words_pair
    kj = wj["key"].reshape(-1).view(np.uint32).astype(np.int64)
    kt = wt["key"].reshape(-1).view(np.uint32).astype(np.int64)
    P = kj.size
    bad = kj != kt
    assert bad.sum() <= ALLOW * P, bad.sum()
    both = bad & (kj != 0xFFFFFFFF) & (kt != 0xFFFFFFFF)
    assert np.all(bad == both), "valid set differs"
    assert np.all(kj[bad] >> 16 == kt[bad] >> 16)
    assert np.all(np.abs((kj[bad] & 0xFFFF) - (kt[bad] & 0xFFFF)) <= 1)
    bj = wj["bkey"].reshape(-1)
    bt = wt["bkey"].reshape(-1)
    assert (bj != bt).sum() <= ALLOW * P
    cj = wj["cnt"].reshape(-1, 128)
    ct = wt["cnt"].reshape(-1, 128)
    assert np.all(cj[:, 2:] == 0) and np.all(ct[:, 2:] == 0)
    assert np.abs(cj[:, 0] - ct[:, 0]).sum() <= ALLOW * P
    assert np.abs(cj[:, 1] - ct[:, 1]).sum() <= ALLOW * P * 4
    assert kj[kj != 0xFFFFFFFF].size > P // 4, "scene must be mostly visible"


def test_positions_within_tolerance(words_pair):
    wj, wt = words_pair
    m = wj["key"].reshape(-1) != -1
    for f in ("ix", "iy"):
        a = wj[f].reshape(-1).view(np.float32)[m]
        b = wt[f].reshape(-1).view(np.float32)[m]
        assert np.abs(a - b).max() < 1e-2, f


def test_f16_and_rgb9e5_fields_within_one_ulp(words_pair):
    wj, wt = words_pair
    m = wj["key"].reshape(-1) != -1
    for f in ("pc1", "pc2"):
        a = wj[f].reshape(-1)[m].view(np.uint32).astype(np.int64)
        b = wt[f].reshape(-1)[m].view(np.uint32).astype(np.int64)
        for sh in (0, 16):
            ha = ((a >> sh) & 0xFFFF).astype(np.uint16).view(np.int16)
            hb = ((b >> sh) & 0xFFFF).astype(np.uint16).view(np.int16)
            # same sign and magnitude bits one apart (monotone encoding)
            assert np.all(np.abs(ha.astype(np.int64) - hb) <= 1), (f, sh)
    a = wj["rgb9"].reshape(-1)[m].view(np.uint32).astype(np.int64)
    b = wt["rgb9"].reshape(-1)[m].view(np.uint32).astype(np.int64)
    ea, eb = a >> 27, b >> 27
    assert np.all(np.abs(ea - eb) <= 1)
    for sh in (0, 9, 18):
        va = ((a >> sh) & 0x1FF) * np.exp2(ea.astype(np.float64) - 24)
        vb = ((b >> sh) & 0x1FF) * np.exp2(eb.astype(np.float64) - 24)
        step = np.exp2(np.maximum(ea, eb).astype(np.float64) - 24)
        assert np.all(np.abs(va - vb) <= step * 1.0001), sh


@pytest.mark.parametrize("planar", [False, True])
def test_project_splats_matches_jax(planar):
    """The readable projection; ``planar`` feeds the port the (48, P) SH
    view of fast_cloud_view, which it reads as (P, 16, 3)."""
    cj = fast_cloud_view(gj.mortonize(gj.synthetic_scene(
        32768, seed=3, extent=3.0, scale_range=(0.005, 0.2))),
        planar_sh=False)
    kw = dict(width=512, height=384, quality="fast")
    cfg_j, cfg_t = gj.RasterizerConfig(**kw), gt.RasterizerConfig(**kw)
    uj = make_uniforms(gj.Camera.reset_pose(),
                       cfg_j, time=5.3)
    pj = project_splats_j(cj.means, cj.cov3d, cj.opacity, cj.sh,
                          np.asarray(cj.upload_time) + 5.0, uj.view,
                          uj.proj, uj.camera_pos, uj.model_scale, uj.time,
                          cfg_j)
    ct = port_cloud(cj)
    sh = gt.fast_cloud_view(ct).sh if planar else ct.sh
    ut = gt.make_uniforms(gt.Camera.reset_pose(),
                          cfg_t, time=5.3, device="cpu")
    pt = project_splats(ct.means, ct.cov3d, ct.opacity, sh,
                        ct.upload_time + 5.0, ut.view, ut.proj,
                        ut.camera_pos, ut.model_scale, ut.time, cfg_t)
    vj, vt = np_(pj.valid), np_(pt.valid)
    np.testing.assert_array_equal(vj, vt)
    assert vt.sum() > vt.size // 4, "scene must be mostly visible"
    dj = np_(pj.depth16).astype(np.int64)[vj]
    dt = np_(pt.depth16).astype(np.int64)[vt]
    assert (dj != dt).sum() <= ALLOW * vj.size
    assert np.abs(dj - dt).max() <= 1
    assert np.abs(np_(pj.image_pos)[vj] - np_(pt.image_pos)[vt]).max() < 1e-2
    nj, nt = np_(pj.num_tiles), np_(pt.num_tiles)
    assert (nj != nt).sum() <= ALLOW * vj.size
    np.testing.assert_allclose(np_(pt.conic)[vt], np_(pj.conic)[vj],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np_(pt.color)[vt], np_(pj.color)[vj],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np_(pt.pos), np_(pj.pos), rtol=1e-6)
