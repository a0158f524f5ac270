"""The port's .ply I/O and photogrammetry scene: tests/test_ply.py's and
tests/test_photogrammetry_scene.py's cases on the port, and against the JAX
package: the numpy swizzle bit-equal to its numpy path, the native swizzle
bit-equal to its native loader, the scene's arrays bit-equal for the same
seed."""

import io

import numpy as np
import pytest

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.models.ply import (PlyError, PlyFile,
                                                     load_splats,
                                                     splat_arrays_from_ply,
                                                     splat_soa_from_ply,
                                                     write_ply)
from godotgaussiansplatting_torch.models.splats import build_covariance
from godotgaussiansplatting_torch.utils.image import hwc
from godotgaussiansplatting_tpu.models import ply as jply
from godotgaussiansplatting_tpu.models.splats import (
    build_covariance as j_build_covariance)

from _torch_parity import jax_native_library, np_, psnr


def _random_model(n=64, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.05, 0.95, (n,)).astype(np.float32)
    sh = rng.normal(size=(n, 16, 3)).astype(np.float32)
    return means, scales, q, opac, sh


@pytest.mark.parametrize("big_endian", [False, True])
def test_roundtrip(big_endian):
    means, scales, q, opac, sh = _random_model()
    blob = write_ply(io.BytesIO(), means, scales, q, opac, sh,
                     big_endian=big_endian)
    assert blob == jply.write_ply(io.BytesIO(), means, scales, q, opac, sh,
                                  big_endian=big_endian)
    ply = PlyFile.parse(blob)
    assert ply.size == len(means)
    assert len(ply.properties) == 62
    m2, s2, q2, o2, sh2 = splat_arrays_from_ply(ply)
    np.testing.assert_allclose(m2, means, atol=1e-6)
    np.testing.assert_allclose(s2, scales, rtol=1e-5)
    np.testing.assert_allclose(q2, q, atol=1e-6)
    np.testing.assert_allclose(o2, opac, atol=1e-5)
    np.testing.assert_allclose(sh2, sh, atol=1e-6)


def test_arrays_bit_equal_to_jax(monkeypatch):
    """The numpy paths bit-equal: the swizzled arrays, the SoA with the
    covariance built in numpy, and load_splats' clouds (the port's on its
    numpy path, as on a machine without g++)."""
    from godotgaussiansplatting_torch import native
    blob = write_ply(io.BytesIO(), *_random_model(n=200, seed=5))
    ours = splat_arrays_from_ply(PlyFile.parse(blob))
    theirs = jply.splat_arrays_from_ply(jply.PlyFile.parse(blob))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    numpy_soa = (ours[0], build_covariance(*ours[1:3]), ours[3], ours[4])
    jax_numpy_soa = (theirs[0], j_build_covariance(*theirs[1:3]),
                     theirs[3], theirs[4])
    for a, b in zip(numpy_soa, jax_numpy_soa):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(native, "available", lambda: False)
    cloud_t = load_splats(blob, upload_time=-3.0, device="cpu")
    cloud_j = jply.load_splats(blob, upload_time=-3.0)
    for f in ("means", "cov3d", "opacity", "sh", "upload_time"):
        np.testing.assert_array_equal(np_(getattr(cloud_t, f)),
                                      np_(getattr(cloud_j, f)))


@pytest.mark.parametrize("big_endian", [False, True])
def test_native_soa_bit_equal_to_jax_native(big_endian):
    """splat_soa_from_ply through each package's native swizzle (the same
    source and flags): bit-equal, where it was held within 2e-6 of a row's
    largest covariance entry while the port had only the numpy path; and
    the port's load_splats, which swizzles through it, gives that SoA."""
    from godotgaussiansplatting_torch import native
    assert native.available()
    jax_native_library()
    blob = write_ply(io.BytesIO(), *_random_model(n=200, seed=5),
                     big_endian=big_endian)
    native.reset_call_counts()
    soa = splat_soa_from_ply(PlyFile.parse(blob))
    assert native.call_counts()["swizzle"] == 1
    theirs = jply.splat_soa_from_ply(jply.PlyFile.parse(blob))
    for a, b in zip(soa, theirs):
        np.testing.assert_array_equal(a, b)
    cloud = load_splats(blob, device="cpu")
    assert native.call_counts()["swizzle"] == 2
    for f, b in zip(("means", "cov3d", "opacity", "sh"), theirs):
        np.testing.assert_array_equal(np_(getattr(cloud, f))[:200], b)


def test_property_order_independent():
    means, scales, q, opac, sh = _random_model(n=8, seed=1)
    ply = PlyFile.parse(write_ply(io.BytesIO(), means, scales, q, opac, sh))
    perm = np.random.default_rng(2).permutation(len(ply.properties))
    ply2 = PlyFile(size=ply.size,
                   properties=[ply.properties[i] for i in perm],
                   vertices=ply.vertices[:, perm])
    m2, _, _, _, sh2 = splat_arrays_from_ply(ply2)
    np.testing.assert_allclose(m2, means, atol=1e-6)
    np.testing.assert_allclose(sh2, sh, atol=1e-6)


def test_get_vertex_dict():
    means, scales, q, opac, sh = _random_model(n=4, seed=3)
    ply = PlyFile.parse(write_ply(io.BytesIO(), means, scales, q, opac, sh))
    v = ply.get_vertex(2)
    assert abs(v["x"] - means[2, 0]) < 1e-6
    assert set(v) == set(ply.properties)


def test_error_paths():
    with pytest.raises(PlyError, match="end_header"):
        PlyFile.parse(b"not a ply")
    blob = write_ply(io.BytesIO(), *_random_model(n=4))
    with pytest.raises(PlyError, match="truncated"):
        PlyFile.parse(blob[:-8])
    with pytest.raises(PlyError, match="format"):
        PlyFile.parse(b"ply\nformat ascii 1.0\nelement vertex 1\n"
                      b"property float x\nend_header\n0")


def test_covariance_matches_quaternion_rotation():
    s = np.array([[2.0, 1.0, 0.5]], np.float32)
    ang = np.pi / 2
    q = np.array([[0.0, 0.0, np.sin(ang / 2), np.cos(ang / 2)]], np.float32)
    np.testing.assert_allclose(build_covariance(s, q)[0],
                               [1.0, 0.0, 0.0, 4.0, 0.0, 0.25], atol=1e-5)


def test_load_splats_device():
    means, scales, q, opac, sh = _random_model(n=32, seed=4)
    cloud = load_splats(write_ply(io.BytesIO(), means, scales, q, opac, sh),
                        device="cpu")
    assert cloud.num_splats == 32 and cloud.device.type == "cpu"
    np.testing.assert_allclose(cloud.means[:32].numpy(), means, atol=1e-6)
    np.testing.assert_allclose(cloud.opacity[:32].numpy(), opac, atol=1e-5)
    assert float(cloud.opacity[32:].max()) == 0.0


def test_photogrammetry_scene_bit_equal_and_marginals():
    c = gt.photogrammetry_scene(100_000, seed=1, device="cpu")
    cj = gj.photogrammetry_scene(100_000, seed=1)
    for f in ("means", "cov3d", "opacity", "sh", "upload_time"):
        np.testing.assert_array_equal(np_(getattr(c, f)),
                                      np_(getattr(cj, f)))
    n = c.num_splats
    op = c.opacity[:n].numpy()
    cov = c.cov3d[:n].numpy()
    rms = np.sqrt(np.maximum(cov[:, 0] + cov[:, 3] + cov[:, 5], 0) / 3)
    assert (op > 0.9).mean() > 0.35
    assert (op < 0.1).mean() > 0.05
    assert op.min() >= 0.005
    assert np.percentile(rms, 99.9) / np.percentile(rms, 50) > 100
    rad = np.linalg.norm(c.means[:n].numpy(), axis=1)
    assert (rad > 10.0).mean() > 0.02
    sh = c.sh[:n].numpy()
    assert (np.abs(sh[:, 0]).mean() > np.abs(sh[:, 1:4]).mean()
            > np.abs(sh[:, 9:16]).mean())


def test_photogrammetry_scene_renders_both_pipelines():
    """The camera inside the scene (360-capture geometry): both qualities
    render finite images, the sky shell fills the frame and the fast frame
    is within 40 dB of the exact one."""
    cfg = gt.RasterizerConfig(width=128, height=96,
                              reference_boundary_quirk=False)
    cloud = gt.mortonize(gt.photogrammetry_scene(20_000, seed=3, extent=2.0,
                                                 device="cpu"))
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    exact = gt.render_frame(cloud, uni, cfg, tile_capacity=4096).image.numpy()
    fast = hwc(gt.render_frame_fast(cloud, uni, cfg).image)
    assert np.isfinite(exact).all() and np.isfinite(fast).all()
    assert exact[:, :, :3].max() > 0.05
    assert psnr(exact[:, :, :3], fast[:, :, :3]) >= 40.0
