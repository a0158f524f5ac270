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
