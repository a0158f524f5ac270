"""Shared plumbing of the port's parity tests (not collected by pytest).

Inputs are made with numpy (or by the JAX package from a seed) and handed to
both packages as numpy arrays; u32 words cross as int32 bit patterns.
"""

from __future__ import annotations

import io

import numpy as np
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch.models.ply import write_ply


def np_(a) -> np.ndarray:
    """JAX/torch array -> numpy, with u32 shown as int32 bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def t_(a) -> torch.Tensor:
    """JAX/numpy array -> CPU torch tensor (u32 as int32 bits)."""
    a = np_(a)
    return torch.from_numpy(np.array(a))


def port_cloud(jcloud) -> "gt.SplatCloud":
    """The JAX package's SplatCloud as the port's cloud (same state)."""
    sh = np_(jcloud.sh)
    cloud = gt.cloud_from_numpy(np_(jcloud.means), np_(jcloud.cov3d),
                                np_(jcloud.opacity), sh,
                                np_(jcloud.upload_time), jcloud.num_splats,
                                device="cpu")
    if np.asarray(jcloud.sh).dtype.name == "bfloat16":
        cloud = gt.fast_cloud_view(cloud)
    return cloud


def port_tuple(cls, jtuple):
    """A JAX NamedTuple (BlockFrame2, BigSet, TileBins2, ...) -> the port's
    NamedTuple of CPU tensors."""
    return cls(*(t_(v) for v in jtuple))


def psnr(a, b, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(peak ** 2 / max(mse, 1e-20))


def model_blob(n: int = 256, seed: int = 0) -> bytes:
    """The .ply bytes of tests/test_engine.py's random model."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n,)).astype(np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = rng.uniform(0.0, 2.0, (n, 3))
    return write_ply(io.BytesIO(), means, scales, q, opac, sh)


def exact_tile_lists(seed: int, cfg, opacity: tuple, P: int = 600,
                     max_count: int = 1400, sigma: tuple = (3, 40),
                     device="cpu") -> tuple:
    """Random per-tile sorted lists over P random splats, as torch tensors
    on ``device`` in render_tiles' argument order (values, start, end,
    image_pos, conic, color): positions over the frame, positive definite
    conics of ``sigma`` px, opacities uniform in ``opacity`` (an opaque range
    saturates every pixel within a few slots, a faint one never does), one
    tile in five empty."""
    rng = np.random.default_rng(seed)
    gx, gy = cfg.tile_dims
    T = gx * gy
    w, h = cfg.target_size
    pos = np.stack([rng.uniform(-8, w + 8, P), rng.uniform(-8, h + 8, P)], 1)
    sig = rng.uniform(*sigma, (P, 2))
    rho = rng.uniform(-0.6, 0.6, P)
    a, c = sig[:, 0] ** 2, sig[:, 1] ** 2
    b = rho * sig[:, 0] * sig[:, 1]
    det = a * c - b * b
    conic = np.stack([c / det, -b / det, a / det], 1)
    color = np.concatenate([rng.uniform(0, 1.5, (P, 3)),
                            rng.uniform(*opacity, (P, 1))], 1)
    counts = rng.integers(1, max_count, T)
    counts[rng.random(T) < 0.2] = 0
    end = np.cumsum(counts)
    start = end - counts
    values = rng.integers(0, P, int(end[-1]) + 7)
    ints = (torch.from_numpy(x.astype(np.int32)).to(device)
            for x in (values, start, end))
    floats = (torch.from_numpy(x.astype(np.float32)).to(device)
              for x in (pos, conic, color))
    return (*ints, *floats)


def jax_native_library():
    """Load the JAX package's native library, built by its Makefile in its
    package directory at first use. Another test process may be writing
    that file at the same moment (it is not written atomically): retry a
    load that fails on a partial file until the build has finished."""
    import time
    from godotgaussiansplatting_tpu import native as jnative
    deadline = time.monotonic() + 120
    while True:
        try:
            if jnative.available():
                return jnative
        except OSError:
            pass
        assert time.monotonic() < deadline, "the JAX native library failed"
        time.sleep(0.2)
