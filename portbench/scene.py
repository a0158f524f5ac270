"""The benchmark's scene, made on the device from a seed.

The statistics are those of the renderer's synthetic "surfaces" scene (a
trained 3D Gaussian Splatting model's splats lie on roughly 2D surface
patches): patches with random centres, normals and sizes in a cube of
half-width ``extent``; each splat on a patch with a small normal offset;
uniform linear scales in ``scale_range`` on each axis, random rotations,
70% of the opacities in [0.85, 1) and the rest in [0.05, 0.6), a DC colour
in [-1, 2) and higher SH bands N(0, 0.12). The scene is shifted by
``1.5 * extent`` along +z.

Two seeds make it: the configuration's ``layout_seed`` draws the patches
(the scene's shape, the same in every run, as a user's model is), and the
run's seed draws every splat on them. So each run's splats differ while the
work a camera sees stays that of one model. Everything is drawn with a
``torch.Generator`` on the device in a few large calls; the arrays are
padded with zeros to a multiple of ``pad`` splats, as the renderer's
loader pads a model.
"""

from __future__ import annotations

import torch


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def covariance(scales, quats):
    """(N, 6) upper triangle [xx, xy, xz, yy, yz, zz] of R S^2 R^T from
    linear scales and (x, y, z, w) quaternions."""
    q = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=-1,
                                                     keepdim=True), min=1e-12)
    x, y, z, w = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)
    S2 = scales * scales

    def c(i, j):
        return (R[:, i, 0] * R[:, j, 0] * S2[:, 0]
                + R[:, i, 1] * R[:, j, 1] * S2[:, 1]
                + R[:, i, 2] * R[:, j, 2] * S2[:, 2])

    return torch.stack([c(0, 0), c(0, 1), c(0, 2), c(1, 1), c(1, 2),
                        c(2, 2)], dim=-1)


def make_scene(spec: dict, seed: int, device) -> dict:
    """The padded splat arrays of ``spec["scene"]`` for ``seed``:
    means (P, 3), cov3d (P, 6), opacity (P,), sh (P, 16, 3) f32 and
    upload_time (P,) (0: fully faded in), and ``num_splats``."""
    sc = spec["scene"]
    n, e = int(sc["splats"]), float(sc["extent"])
    lo_s, hi_s = sc["scale_range"]
    f32 = torch.float32

    g = _gen(sc["layout_seed"], device)
    k = max(64, n // 4096)
    centers = (torch.rand((k, 3), generator=g, device=device) * 2 - 1) * e
    normals = torch.randn((k, 3), generator=g, device=device)
    normals = normals / torch.linalg.vector_norm(normals, dim=-1,
                                                 keepdim=True)
    sizes = (0.15 + 0.65 * torch.rand((k, 1), generator=g, device=device)) \
        * e * 0.4
    u = torch.randn((k, 3), generator=g, device=device)
    u = u - (u * normals).sum(-1, keepdim=True) * normals
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    v = torch.linalg.cross(normals, u, dim=-1)

    pad = int(sc["pad"])
    cap = max(pad, -(-n // pad) * pad)

    def zeros(*shape):
        return torch.zeros((cap, *shape), dtype=f32, device=device)

    out = {"means": zeros(3), "cov3d": zeros(6), "opacity": zeros(),
           "sh": zeros(16, 3), "upload_time": zeros(), "num_splats": n}
    g = _gen(seed, device)
    pid = torch.randint(0, k, (n,), generator=g, device=device)
    abc = torch.randn((n, 3), generator=g, device=device)
    means = (centers[pid] + sizes[pid] * (abc[:, 0:1] * u[pid]
                                          + abc[:, 1:2] * v[pid])
             + (0.02 * e) * abc[:, 2:3] * normals[pid])
    del pid, abc
    means = torch.clamp(means, -1.6 * e, 1.6 * e)
    means[:, 2] += e * 1.5
    out["means"][:n] = means
    del means
    scales = lo_s + (hi_s - lo_s) * torch.rand((n, 3), generator=g,
                                               device=device)
    quats = torch.randn((n, 4), generator=g, device=device)
    out["cov3d"][:n] = covariance(scales, quats)
    del scales, quats
    r = torch.rand((n, 2), generator=g, device=device)
    out["opacity"][:n] = torch.where(r[:, 0] < 0.7, 0.85 + 0.15 * r[:, 1],
                                     0.05 + 0.55 * r[:, 1])
    del r
    sh = out["sh"]
    sh[:n, 0].uniform_(-1.0, 2.0, generator=g)
    ncoef = (int(spec["rasterizer"]["sh_degree"]) + 1) ** 2
    if ncoef > 1:
        # drawn in place: no transient beside the scene raises the peak
        sh[:n, 1:ncoef].normal_(0.0, 0.12, generator=g)
    return out
