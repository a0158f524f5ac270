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
    return from_soa(means, build_covariance(scales, quats_xyzw), opacities,
                    sh, upload_time, capacity, device)


def from_soa(means, cov6, opacities, sh,
             upload_time: float | np.ndarray = 0.0,
             capacity: Optional[int] = None,
             device="cuda") -> SplatCloud:
    """``from_arrays`` from the covariance itself (the (N, 6) upper
    triangle, as ``models/ply.splat_soa_from_ply`` gives it)."""
    n = means.shape[0]
    cap = capacity or n
    cap = max(PAD_MULTIPLE, -(-cap // PAD_MULTIPLE) * PAD_MULTIPLE)
    if np.ndim(upload_time) == 0:
        upload_time = np.full((n,), float(upload_time), np.float32)
    sh = np.asarray(sh, np.float32)
    if sh.shape[1] < 16:
        sh = np.pad(sh, ((0, 0), (0, 16 - sh.shape[1]), (0, 0)))
    return cloud_from_numpy(
        _pad(np.asarray(means, np.float32), cap),
        _pad(np.asarray(cov6, np.float32), cap),
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
    are coalesced over splats; with ``planar_sh`` False, (P, 16, 3), the
    layout of the readable projection's kernel (a planar view given is
    laid out so again). The original cloud keeps full precision."""
    sh = cloud.sh.to(torch.bfloat16)
    if planar_sh and sh.ndim == 3:
        sh = sh.permute(1, 2, 0).reshape(48, sh.shape[0]).contiguous()
    elif not planar_sh and sh.ndim == 2:
        sh = sh.reshape(16, 3, -1).permute(2, 0, 1).contiguous()
    return dataclasses.replace(cloud, sh=sh)


def refresh_fast_view(view: SplatCloud, cloud: SplatCloud) -> None:
    """Write ``cloud``'s SH into ``view``, the fast view made from it, in
    place, in the view's layout: its SH buffer keeps its address (which a
    captured frame reads), and chunks streamed into the cloud reach the
    bf16 copy. The view's other fields are the cloud's own tensors."""
    if view.sh.ndim == 2:
        view.sh.view(16, 3, -1).copy_(cloud.sh.permute(1, 2, 0))
    else:
        view.sh.copy_(cloud.sh)


def synthetic_scene(num_splats: int, seed: int = 0, extent: float = 4.0,
                    scale_range: tuple = (0.005, 0.05), sh_degree: int = 3,
                    surfaces: bool = False, device="cuda") -> SplatCloud:
    """Deterministic random scene for tests and benchmarks; the same seed
    gives the same arrays as the JAX package's synthetic_scene."""
    return from_arrays(*synthetic_arrays(num_splats, seed, extent,
                                         scale_range, sh_degree, surfaces),
                       device=device)


def synthetic_arrays(num_splats: int, seed: int = 0, extent: float = 4.0,
                     scale_range: tuple = (0.005, 0.05), sh_degree: int = 3,
                     surfaces: bool = False) -> tuple:
    """synthetic_scene's host arrays (means, linear scales, quaternions
    xyzw, opacities, sh), as ``from_arrays`` and ``write_ply`` take them."""
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
    return means, scales, quats, opac, sh


def photogrammetry_scene(num_splats: int, seed: int = 0, extent: float = 4.0,
                         device="cuda") -> SplatCloud:
    """Scene with the marginal statistics of a TRAINED Inria 3DGS model.

    A copy of the JAX package's ``photogrammetry_scene``: the same seed
    gives the same arrays. The reference's headline numbers come from real
    MipNeRF-360 checkpoints (bicycle/garden, the reference's README.md:26,58),
    which are not distributed with it, so this reproduces the distributions
    a trained model exposes to the pipeline — the properties that actually
    stress each stage:

      * scales: LOG-NORMAL with a heavy upper tail (the Inria trainer stores
        log-scale and densifies/splits by gradient; survivors span ~4 orders
        of magnitude), strongly ANISOTROPIC per splat (thin plates along
        surfaces, needles along edges) — drives the big-splat (radius>=32px)
        extraction and the tile-rect distribution.
      * opacity: BIMODAL in logit space (training prunes alpha<0.005 and
        periodically resets opacity; converged splats saturate toward 1) —
        drives the saturation early-exit (gsplat_render.glsl:45-48).
      * layout: a well-observed central region with small dense surface
        splats + a sparse BACKGROUND SHELL of giant low-detail splats (sky /
        far field, the 360-capture signature) — the camera orbits INSIDE the
        scene, so far-plane depth16 quantization (depth^3 keys,
        gsplat_projection.glsl:218-226) is exercised.
      * SH: band energy decays geometrically from DC (higher bands encode
        view-dependent residuals only); channels are correlated (real
        radiance is mostly grey-ish at high bands).
    """
    rng = np.random.default_rng(seed)
    n = num_splats
    n_bg = max(1, int(n * 0.06))          # background shell (sky/far field)
    n_fol = max(1, int(n * 0.22))         # volumetric foliage / clutter
    n_surf = n - n_bg - n_fol             # surface patches

    # --- positions ---------------------------------------------------------
    k = max(64, n_surf // 4096)
    centers = rng.uniform(-extent, extent, (k, 3)).astype(np.float32)
    centers[:, 1] *= 0.35                 # flatten vertically (ground scene)
    normals = rng.normal(size=(k, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    sizes = (rng.uniform(0.15, 0.8, (k, 1)).astype(np.float32)
             * extent * 0.4)
    u = rng.normal(size=(k, 3)).astype(np.float32)
    u -= (u * normals).sum(-1, keepdims=True) * normals
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(normals, u)
    pid = rng.integers(0, k, n_surf)
    a = rng.normal(size=(n_surf, 1)).astype(np.float32)
    b = rng.normal(size=(n_surf, 1)).astype(np.float32)
    c = rng.normal(0, 0.015, (n_surf, 1)).astype(np.float32)
    p_surf = (centers[pid] + sizes[pid] * (a * u[pid] + b * v[pid])
              + c * extent * normals[pid]).astype(np.float32)
    p_surf = np.clip(p_surf, -1.6 * extent, 1.6 * extent)

    p_fol = rng.normal(0, 0.55 * extent, (n_fol, 3)).astype(np.float32)
    p_fol[:, 1] = np.abs(p_fol[:, 1]) * 0.6  # above ground

    # background shell at 3-8x extent, roughly isotropic directions
    d_bg = rng.normal(size=(n_bg, 3)).astype(np.float32)
    d_bg /= np.linalg.norm(d_bg, axis=-1, keepdims=True)
    r_bg = rng.uniform(3.0, 8.0, (n_bg, 1)).astype(np.float32) * extent
    p_bg = (d_bg * r_bg).astype(np.float32)

    means = np.concatenate([p_surf, p_fol, p_bg], axis=0)

    # --- scales: log-normal, anisotropic -------------------------------------
    # base sigma per population: surfaces ~ 0.004*extent median, foliage a bit
    # larger, background giant (0.1-1 extent)
    ln = np.empty((n, 3), np.float32)
    base_s = rng.normal(np.log(0.004 * extent), 0.9, n_surf).astype(np.float32)
    base_f = rng.normal(np.log(0.009 * extent), 0.7, n_fol).astype(np.float32)
    base_b = rng.normal(np.log(0.25 * extent), 0.6, n_bg).astype(np.float32)
    base = np.concatenate([base_s, base_f, base_b])
    aniso = rng.normal(0, 0.55, (n, 3)).astype(np.float32)
    ln[:] = base[:, None] + aniso
    # plates: squash one random axis hard on ~45% (surfaces are locally 2D)
    plate = rng.random(n) < 0.45
    axis = rng.integers(0, 3, n)
    ln[plate, axis[plate]] -= rng.uniform(1.0, 2.5, plate.sum()).astype(
        np.float32)
    scales = np.exp(ln).astype(np.float32)
    # trainer clips: nothing smaller than ~1e-5 extent survives pruning
    scales = np.maximum(scales, 1e-5 * extent)

    # --- opacity: bimodal logit -----------------------------------------------
    m = rng.random(n)
    opac = np.where(
        m < 0.55, 1.0 - rng.exponential(0.04, n),      # converged, near 1
        np.where(m < 0.85, rng.uniform(0.10, 0.90, n), # mid
                 0.005 + rng.exponential(0.05, n)))    # wispy, above prune
    opac = np.clip(opac, 0.005, 0.9999).astype(np.float32)
    opac[n_surf + n_fol:] = np.clip(                   # sky is mostly opaque
        1.0 - rng.exponential(0.08, n_bg), 0.3, 0.9999).astype(np.float32)

    # --- orientation: plates align to their patch normal ----------------------
    quats = rng.normal(size=(n, 4)).astype(np.float32)

    # --- SH: geometric band decay, channel-correlated --------------------------
    sh = np.zeros((n, 16, 3), np.float32)
    # DC: natural palette (greens/browns/sky-blue mixture via per-population hue)
    dc_surf = rng.uniform(-0.8, 1.8, (n_surf, 3)).astype(np.float32)
    dc_fol = (rng.uniform(-0.5, 1.2, (n_fol, 1))
              * np.array([[0.6, 1.0, 0.5]], np.float32)
              + rng.normal(0, 0.15, (n_fol, 3))).astype(np.float32)
    dc_bg = (np.array([[0.4, 0.8, 1.6]], np.float32)
             + rng.normal(0, 0.25, (n_bg, 3))).astype(np.float32)
    sh[:, 0] = np.concatenate([dc_surf, dc_fol, dc_bg])
    grey = rng.normal(0, 1.0, (n, 15, 1)).astype(np.float32)
    chroma = rng.normal(0, 0.35, (n, 15, 3)).astype(np.float32)
    band_sigma = np.concatenate([
        np.full(3, 0.16), np.full(5, 0.07), np.full(7, 0.03)]).astype(
        np.float32)                                     # l=1,2,3 decay
    sh[:, 1:16] = (grey + chroma) * band_sigma[None, :, None]
    sh[n_surf + n_fol:, 1:16] *= 0.3                    # sky is low-detail

    return from_arrays(means, scales, quats, opac, sh, device=device)
