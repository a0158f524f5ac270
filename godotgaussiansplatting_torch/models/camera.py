"""Pinhole camera model matching the reference's matrix conventions.

numpy-only copy of ``godotgaussiansplatting_tpu/models/camera.py``.

The reference builds its push-constant matrices in
`gaussian_splatting_rasterizer.gd:175-195`:

  view  = F · R^T · (A·p − w)   folded into one 4×4, where
          A = diag(-1,-1, 1)  maps Inria-PLY world → Godot world (the same
                              negation applied to camera_pos in the uniforms,
                              gaussian_splatting_rasterizer.gd:125-126),
          R = camera basis (camera-to-world rotation, incl. basis_override),
          w = A · camera position in PLY frame (i.e. Godot-world position),
          F = diag( 1,-1, 1)  flips view-space y so NDC y grows downward and
                              image_pos lands directly in row-major pixels.
  proj  = Godot's GL-style perspective (Projection::create_perspective):
          vertical fov, z_ndc ∈ [-1, 1], column 3 row = (0,0,-1,0).

Splats live in the PLY frame throughout; the A/F sign flips live here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

_A = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)  # PLY world -> Godot world
_F = np.diag([1.0, -1.0, 1.0]).astype(np.float32)   # view-space y flip


@dataclasses.dataclass
class Camera:
    """Camera pose in the Godot world frame (like the reference FreeLookCamera).

    position: (3,) camera origin (Godot world).
    basis:    (3, 3) camera-to-world rotation; columns are the camera X/Y/Z axes.
              The camera looks down its local -Z (Godot convention).
    fov_y:    vertical field of view in degrees (Godot Camera3D default 75).
    znear/zfar: clip planes (Godot defaults 0.05 / 4000).
    basis_override: optional scene re-orientation basis applied on the left of
              the camera transform (gaussian_splatting_rasterizer.gd:57,176).
    """

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    basis: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    fov_y: float = 75.0
    znear: float = 0.05
    zfar: float = 4000.0
    basis_override: Optional[np.ndarray] = None

    # -- pose helpers ------------------------------------------------------

    @staticmethod
    def reset_pose(**kw) -> "Camera":
        """The reference's initial pose: origin, yawed 180° (camera.gd:151-153:
        rotation = UP * -PI), i.e. looking down Godot +Z = PLY +Z."""
        c = math.cos(math.pi)
        basis = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float32)
        del c
        return Camera(basis=basis, **kw)

    def with_yaw_pitch(self, yaw_deg: float, pitch_deg: float) -> "Camera":
        """Yaw about world Y then pitch about local X (Godot euler YXZ)."""
        y, p = math.radians(yaw_deg), math.radians(pitch_deg)
        cy, sy, cp, sp = math.cos(y), math.sin(y), math.cos(p), math.sin(p)
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
        return dataclasses.replace(self, basis=(ry @ rx).astype(np.float32))

    def look_at(self, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> "Camera":
        """Godot look_at: -Z toward target, Y toward up."""
        fwd = np.asarray(target, np.float32) - self.position
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        z = -fwd
        x = np.cross(np.asarray(up, np.float32), z)
        x = x / max(np.linalg.norm(x), 1e-12)
        y = np.cross(z, x)
        return dataclasses.replace(
            self, basis=np.stack([x, y, z], axis=1).astype(np.float32))

    # -- matrices ----------------------------------------------------------

    @property
    def effective_basis(self) -> np.ndarray:
        if self.basis_override is None:
            return self.basis
        return (self.basis_override @ self.basis).astype(np.float32)

    @property
    def effective_position(self) -> np.ndarray:
        if self.basis_override is None:
            return self.position
        return (self.basis_override @ self.position).astype(np.float32)

    def view_matrix(self) -> np.ndarray:
        """4×4 world(PLY frame)→view matrix, exactly the reference push constant
        (gaussian_splatting_rasterizer.gd:183-188)."""
        R = self.effective_basis
        w = self.effective_position
        rot = _F @ R.T @ _A              # 3×3
        trans = _F @ (R.T @ (-w))        # 3,
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = trans
        return m

    def projection_matrix(self, width: int, height: int) -> np.ndarray:
        """Godot GL-style perspective (Projection::create_perspective), vertical
        fov; rows follow gaussian_splatting_rasterizer.gd:190-193."""
        aspect = width / height
        f = 1.0 / math.tan(math.radians(self.fov_y) * 0.5)
        n, fa = self.znear, self.zfar
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = f / aspect
        m[1, 1] = f
        m[2, 2] = -(fa + n) / (fa - n)
        m[2, 3] = -2.0 * fa * n / (fa - n)
        m[3, 2] = -1.0
        return m

    def camera_pos_ply(self) -> np.ndarray:
        """Camera position in the PLY frame: (-x, -y, z) of the (override-
        rotated) Godot position — the uniform at
        gaussian_splatting_rasterizer.gd:125-126."""
        w = self.effective_position
        return (_A @ w).astype(np.float32)


def orbit_trajectory(num_frames: int, radius: float, target=(0.0, 0.0, 6.0),
                     height: float = 0.0, fov_y: float = 75.0) -> list:
    """Cameras orbiting a PLY-frame target — the reference's orbit mode
    (camera.gd:54-61) as an offline trajectory (BASELINE config 2)."""
    tgt_ply = np.asarray(target, np.float32)
    tgt_godot = (_A @ tgt_ply).astype(np.float32)
    cams = []
    for i in range(num_frames):
        ang = 2 * math.pi * i / num_frames
        pos = tgt_godot + np.array(
            [radius * math.sin(ang), height, radius * math.cos(ang)], np.float32)
        cams.append(Camera(position=pos, fov_y=fov_y).look_at(tgt_godot))
    return cams
