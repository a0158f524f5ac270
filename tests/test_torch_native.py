"""The port's native .ply preprocessor (godotgaussiansplatting_torch/native)
against the JAX package's (godotgaussiansplatting_tpu/native): the same
C++ source built with the same flags, so the swizzle and the Morton codes
are bit-equal, from little- and big-endian blobs; each package's numpy
Morton branch held to the other's; the build (under build/native/, a
failed build raises, no g++ means the numpy paths) and the call counters
that show a streamed load went through the library."""

import io
from pathlib import Path

import numpy as np
import pytest

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import native
from godotgaussiansplatting_torch.models.ply import (PlyError, PlyFile,
                                                     splat_arrays_from_ply,
                                                     splat_soa_from_ply,
                                                     write_ply)
from godotgaussiansplatting_torch.models.splats import build_covariance
from godotgaussiansplatting_torch.ops import blocks as blocks_t
from godotgaussiansplatting_tpu import native as jnative
from godotgaussiansplatting_tpu.models import ply as jply
from godotgaussiansplatting_tpu.ops import blocks as blocks_j

from _torch_parity import jax_native_library

REPO = Path(__file__).resolve().parent.parent


def _blob(n=5000, seed=0, big_endian=False):
    """A random model; 5000 splats, so the library's threaded paths run
    (it threads from 4096)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    scales = rng.uniform(0.001, 0.8, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.01, 0.99, (n,)).astype(np.float32)
    sh = rng.normal(size=(n, 16, 3)).astype(np.float32)
    return write_ply(io.BytesIO(), means, scales, q, opac, sh,
                     big_endian=big_endian)


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert native.available(), "g++ is on this machine: the port must build"
    jax_native_library()


@pytest.mark.parametrize("big_endian", [False, True])
def test_swizzle_bit_equal_to_jax_native(big_endian):
    blob = _blob(big_endian=big_endian, seed=int(big_endian))
    native.reset_call_counts()
    ours = splat_soa_from_ply(PlyFile.parse(blob))
    assert native.call_counts()["swizzle"] == 1
    theirs = jply.splat_soa_from_ply(jply.PlyFile.parse(blob))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the raw payload, its bytes still in the file's order: the library
    # swaps them itself
    ply = PlyFile.parse(blob)
    raw = np.frombuffer(blob[len(blob) - ply.vertices.nbytes:],
                        np.float32).reshape(ply.vertices.shape)
    ours = native.swizzle(raw, ply.properties, big_endian)
    theirs = jnative.swizzle(raw, ply.properties, big_endian)
    for a, b, c in zip(ours, theirs, splat_soa_from_ply(ply)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("seed", [0, 1])
def test_morton3_bit_equal_to_jax_native(seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(20_000, 3)).astype(np.float32)
    means[:7] = means[7]          # ties keep their order (stable argsort)
    native.reset_call_counts()
    codes = native.morton3(means)
    assert codes.dtype == np.uint64
    np.testing.assert_array_equal(codes, jnative.morton3(means))
    np.testing.assert_array_equal(blocks_t.morton_order(means),
                                  blocks_j.morton_order(means))
    assert native.call_counts()["morton3"] == 2
    assert codes.max() < 1 << 30


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_morton_branch_equal_to_jax_numpy_branch(seed, monkeypatch):
    """Each package without its library: the numpy branches (which
    quantise in f64) agree."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(5000, 3)).astype(np.float32)
    native.reset_call_counts()
    order = blocks_t.morton_order(means)
    np.testing.assert_array_equal(order, blocks_j.morton_order(means))
    assert native.call_counts()["morton3"] == 0


def test_non_contiguous_rest_takes_numpy_path():
    ply = PlyFile.parse(_blob(n=300, seed=2))
    perm = np.random.default_rng(3).permutation(len(ply.properties))
    shuffled = PlyFile(size=ply.size,
                       properties=[ply.properties[i] for i in perm],
                       vertices=np.ascontiguousarray(ply.vertices[:, perm]))
    with pytest.raises(native.NonContiguousRest):
        native.swizzle(shuffled.vertices, shuffled.properties, False)
    native.reset_call_counts()
    soa = splat_soa_from_ply(shuffled)
    assert native.call_counts()["swizzle"] == 0
    m, s, q, o, sh = splat_arrays_from_ply(ply)
    for a, b in zip(soa, (m, build_covariance(s, q), o, sh)):
        np.testing.assert_array_equal(a, b)


def test_missing_property_raises_ply_error():
    ply = PlyFile.parse(_blob(n=16))
    drop = ply.properties.index("rot_2")
    cut = PlyFile(size=ply.size,
                  properties=ply.properties[:drop] + ply.properties[drop + 1:],
                  vertices=np.delete(ply.vertices, drop, axis=1))
    with pytest.raises(PlyError, match="rot_2"):
        splat_soa_from_ply(cut)


def test_library_is_built_under_build_native():
    so = native.library_path()
    assert so.parent == REPO / "build" / "native"
    assert so.name.startswith("libplyio-") and so.exists()
    assert not list((REPO / "godotgaussiansplatting_torch").rglob("*.so"))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(bad)
    assert not list((tmp_path / "out").glob("*"))


def test_without_compiler_the_numpy_paths_run(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert not native.available()
    ply = PlyFile.parse(_blob(n=200, seed=4))
    native.reset_call_counts()
    soa = splat_soa_from_ply(ply)
    m, s, q, o, sh = splat_arrays_from_ply(ply)
    for a, b in zip(soa, (m, build_covariance(s, q), o, sh)):
        np.testing.assert_array_equal(a, b)
    blocks_t.morton_order(m)
    assert native.call_counts() == {"swizzle": 0, "morton3": 0}


def test_streamed_load_goes_through_the_library():
    """A fast-quality streamed load (the viewer's /load): one native
    swizzle, one native Morton order, and the swizzle, order and upload
    times recorded."""
    native.reset_call_counts()
    r = gt.Rasterizer(_blob(n=3000, seed=5), texture_size=(32, 32),
                      stream=True, chunks=4, quality="fast", device="cpu")
    r.loader.join(timeout=60)
    assert not r.loader.is_loading and r.loader.error is None
    assert r.num_splats_loaded == 3000
    assert native.call_counts() == {"swizzle": 1, "morton3": 1}
    assert set(r.loader.seconds) == {"swizzle", "order", "upload"}
