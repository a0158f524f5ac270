"""Spherical-harmonic colour (degrees 0-3, Inria sign convention).

Counterpart of ``godotgaussiansplatting_tpu/ops/sh.py``: ``get_color`` of
gsplat_projection.glsl:94-121 — the standard constants, the alternating
signs and the final max(0, 0.5 + sum) clamp. The projection kernel
(csrc/projection.cu) evaluates the same formulas per splat.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
         1.0925484305920792, 0.5462742152960396)
SH_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
         0.3731763325901154, 0.4570457994644658, 1.445305721320277,
         0.5900435899266435)


def eval_sh_color(view_dir: torch.Tensor, sh: torch.Tensor,
                  degree: int = 3) -> torch.Tensor:
    """(N, 3) normalised view directions and (N, 16, 3) coefficients (f32
    or bf16, upcast per band) -> (N, 3) linear RGB clamped at 0."""
    def co(k):
        return sh[:, k].float()

    x = view_dir[:, 0:1]
    y = view_dir[:, 1:2]
    z = view_dir[:, 2:3]
    c = 0.5 + co(0) * SH_C0
    if degree >= 1:
        c = (c
             - co(1) * (SH_C1 * y)
             + co(2) * (SH_C1 * z)
             - co(3) * (SH_C1 * x))
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        c = (c
             + co(4) * (SH_C2[0] * xy)
             - co(5) * (SH_C2[1] * yz)
             + co(6) * (SH_C2[2] * (2.0 * zz - xx - yy))
             - co(7) * (SH_C2[3] * xz)
             + co(8) * (SH_C2[4] * (xx - yy)))
    if degree >= 3:
        c = (c
             - co(9) * (SH_C3[0] * y * (3.0 * xx - yy))
             + co(10) * (SH_C3[1] * x * yz)
             - co(11) * (SH_C3[2] * y * (4.0 * zz - xx - yy))
             + co(12) * (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy))
             - co(13) * (SH_C3[4] * x * (4.0 * zz - xx - yy))
             + co(14) * (SH_C3[5] * z * (xx - yy))
             - co(15) * (SH_C3[6] * x * (xx - 3.0 * yy)))
    return torch.clamp(c, min=0.0)
