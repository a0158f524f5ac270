"""The viewer's camera matrices, from plain numbers.

The same conventions as the renderer's camera (the Godot reference's push
constants): splats live in the PLY frame, ``A = diag(-1, -1, 1)`` maps a
PLY point into the Godot world, the camera looks down its local -Z, the
view flips y (``F = diag(1, -1, 1)``), and the projection is Godot's
GL-style perspective with a vertical field of view.
"""

from __future__ import annotations

import math

import numpy as np

_A = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
_F = np.diag([1.0, -1.0, 1.0]).astype(np.float32)
ZNEAR, ZFAR = 0.05, 4000.0


def look_at_basis(position, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """(3, 3) camera-to-world rotation: -Z toward ``target``, Y toward
    ``up`` (both in the Godot world)."""
    fwd = np.asarray(target, np.float32) - np.asarray(position, np.float32)
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    z = -fwd
    x = np.cross(np.asarray(up, np.float32), z)
    x = x / max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32)


def view_matrix(position, basis) -> np.ndarray:
    """4x4 PLY-frame world -> view matrix."""
    rot = _F @ basis.T @ _A
    trans = _F @ (basis.T @ (-np.asarray(position, np.float32)))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot
    m[:3, 3] = trans
    return m


def projection_matrix(fov_y: float, width: int, height: int) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fov_y) * 0.5)
    n, fa = ZNEAR, ZFAR
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / (width / height)
    m[1, 1] = f
    m[2, 2] = -(fa + n) / (fa - n)
    m[2, 3] = -2.0 * fa * n / (fa - n)
    m[3, 2] = -1.0
    return m


def flip_xy(point) -> np.ndarray:
    """A point of one frame in the other (PLY <-> Godot world)."""
    return (_A @ np.asarray(point, np.float32)).astype(np.float32)


def camera_matrices(position, target, fov_y: float, width: int,
                    height: int):
    """(view, proj, camera position in the PLY frame) of a camera at
    ``position`` looking at ``target``, both in the Godot world."""
    basis = look_at_basis(position, target)
    return (view_matrix(position, basis),
            projection_matrix(fov_y, width, height),
            flip_xy(position))
