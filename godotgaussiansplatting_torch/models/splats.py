"""Splat cloud: the device-resident structure-of-arrays splat model.

Counterpart of ``godotgaussiansplatting_tpu/models/splats.py``. Scenes are
generated with ``numpy.random.default_rng(seed)`` and the covariance is built
in numpy, so the same seed gives bit-identical arrays in both packages; the
tensors are then placed on the requested device: the card unless the caller
asks for another (``device="cpu"`` runs the plain versions). Without a card
the default raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.blocks import order_splats

PAD_MULTIPLE = 16384  # splat-axis padding granularity


@dataclasses.dataclass(frozen=True)
class SplatCloud:
    """SoA splat model. All tensors are padded to the same length
    ``capacity``; slots >= ``num_splats`` are inert (opacity 0).

      means       (P, 3) f32 — world position (PLY frame)
      cov3d       (P, 6) f32 — upper triangle [xx, xy, xz, yy, yz, zz]
      opacity     (P,)   f32 — post-sigmoid opacity
      sh          (P, 16, 3) f32, or (48, P) bf16 planar (fast_cloud_view)
      upload_time (P,)   f32 — upload timestamp driving the fade-in
    """

    means: torch.Tensor
    cov3d: torch.Tensor
    opacity: torch.Tensor
    sh: torch.Tensor
    upload_time: torch.Tensor
    num_splats: int

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def __len__(self) -> int:
        return self.num_splats


def _pad(a: np.ndarray, capacity: int) -> np.ndarray:
    pad = [(0, capacity - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def build_covariance(scales: np.ndarray, quats_xyzw: np.ndarray) -> np.ndarray:
    """3D covariance upper triangle R S^2 R^T from linear scales and
    (x, y, z, w) quaternions (ply_file.gd:49-59). Returns (N, 6)."""
    scales = np.asarray(scales, np.float32)
    q = np.asarray(quats_xyzw, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(*q.shape[:-1], 3, 3)
    S2 = scales[..., None] ** 2
    cov = np.einsum("...ik,...k,...jk->...ij", R, S2[..., 0], R)
    return np.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        axis=-1,
    ).astype(np.float32)


def cloud_from_numpy(means, cov3d, opacity, sh, upload_time,
                     num_splats: int, device="cuda") -> SplatCloud:
    """SplatCloud from already padded host arrays — e.g. the JAX package's
    SplatCloud fields as numpy — so both packages compute on the same
    state. ``sh`` may be (P, 16, 3) f32 or planar (48, P) bf16-valued."""
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype).contiguous()

    sh = np.asarray(sh)
    sh_t = t(sh, torch.bfloat16 if sh.ndim == 2 else torch.float32)
    return SplatCloud(means=t(means), cov3d=t(cov3d), opacity=t(opacity),
                      sh=sh_t, upload_time=t(upload_time),
                      num_splats=int(num_splats))


def from_arrays(means, scales, quats_xyzw, opacities, sh,
                upload_time: float | np.ndarray = 0.0,
                capacity: Optional[int] = None,
                device="cuda") -> SplatCloud:
    """Build a SplatCloud from host arrays: post-sigmoid ``opacities``,
    linear ``scales``, (N, 16, 3) coeff-major ``sh`` (lower degrees are
    zero-padded)."""
    n = means.shape[0]
    cap = capacity or n
    cap = max(PAD_MULTIPLE, -(-cap // PAD_MULTIPLE) * PAD_MULTIPLE)
    cov6 = build_covariance(scales, quats_xyzw)
    if np.ndim(upload_time) == 0:
        upload_time = np.full((n,), float(upload_time), np.float32)
    sh = np.asarray(sh, np.float32)
    if sh.shape[1] < 16:
        sh = np.pad(sh, ((0, 0), (0, 16 - sh.shape[1]), (0, 0)))
    return cloud_from_numpy(
        _pad(np.asarray(means, np.float32), cap), _pad(cov6, cap),
        _pad(np.asarray(opacities, np.float32), cap), _pad(sh, cap),
        _pad(np.asarray(upload_time, np.float32), cap), n, device=device)


def mortonize(cloud: SplatCloud) -> SplatCloud:
    """Reorder a cloud along the load-time space-filling curve (host-side,
    once; ops/blocks.order_splats). The fast path cuts its bricks from this
    order. Padding slots stay at the tail."""
    n = cloud.num_splats
    order = order_splats(cloud.means[:n].cpu().numpy())
    perm = np.arange(cloud.capacity)
    perm[:n] = order
    p = torch.as_tensor(perm, device=cloud.device)
    return dataclasses.replace(
        cloud, means=cloud.means[p], cov3d=cloud.cov3d[p],
        opacity=cloud.opacity[p], sh=cloud.sh[p],
        upload_time=cloud.upload_time[p])


def fast_cloud_view(cloud: SplatCloud, planar_sh: bool = True) -> SplatCloud:
    """Render view for the fast path: SH cast once to bf16 and, for the
    projection kernel, stored splat-minor as (48, P) so the kernel's reads
    are coalesced over splats. The original cloud keeps full precision."""
    sh = cloud.sh.to(torch.bfloat16)
    if planar_sh and sh.ndim == 3:
        sh = sh.permute(1, 2, 0).reshape(48, sh.shape[0]).contiguous()
    return dataclasses.replace(cloud, sh=sh)


def synthetic_scene(num_splats: int, seed: int = 0, extent: float = 4.0,
                    scale_range: tuple = (0.005, 0.05), sh_degree: int = 3,
                    surfaces: bool = False, device="cuda") -> SplatCloud:
    """Deterministic random scene for tests and benchmarks; the same seed
    gives the same arrays as the JAX package's synthetic_scene."""
    rng = np.random.default_rng(seed)
    n = num_splats
    if surfaces:
        # splats concentrated on ~2D surface patches, like trained models
        k = max(64, n // 4096)
        centers = rng.uniform(-extent, extent, (k, 3)).astype(np.float32)
        normals = rng.normal(size=(k, 3)).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        sizes = rng.uniform(0.15, 0.8, (k, 1)).astype(np.float32) * extent * 0.4
        u = rng.normal(size=(k, 3)).astype(np.float32)
        u -= (u * normals).sum(-1, keepdims=True) * normals
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        v = np.cross(normals, u)
        pid = rng.integers(0, k, n)
        a = rng.normal(size=(n, 1)).astype(np.float32)
        b = rng.normal(size=(n, 1)).astype(np.float32)
        c = rng.normal(0, 0.02, (n, 1)).astype(np.float32)
        means = (centers[pid] + sizes[pid] * (a * u[pid] + b * v[pid])
                 + c * extent * normals[pid]).astype(np.float32)
        means = np.clip(means, -1.6 * extent, 1.6 * extent)
    else:
        means = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    means[:, 2] += extent * 1.5   # in front of the default camera
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    if surfaces:
        opac = np.where(rng.random(n) < 0.7,
                        rng.uniform(0.85, 1.0, n),
                        rng.uniform(0.05, 0.6, n)).astype(np.float32)
    else:
        opac = rng.uniform(0.2, 1.0, (n,)).astype(np.float32)
    ncoef = (sh_degree + 1) ** 2
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = rng.uniform(-1.0, 2.0, (n, 3))
    if ncoef > 1:
        sh[:, 1:ncoef] = rng.normal(0, 0.12, (n, ncoef - 1, 3))
    return from_arrays(means, scales, quats, opac, sh, device=device)
