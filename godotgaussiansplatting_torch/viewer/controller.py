"""FreeLookCamera controller: the reference's camera physics, host-side.

The port's copy of ``godotgaussiansplatting_tpu/viewer/controller.py``
(numpy, on the port's ``models/camera.py``), bit-equal to it. Reimplements
`util/camera.gd` behavior for any frontend (HTTP viewer, offline
trajectory scripting, tests):

  * free-look fly: WASD+QE with acceleration 30, drag -10, base speed 4,
    shift ×2.5 / alt ×0.4 (camera.gd:15-17, 104-128)
  * mouse look with pitch clamped to [-80°, 70°] (:52-53)
  * orbit mode around a focus point, yaw scaled by cos(pitch), same pitch
    clamp (:54-61); slerp-smoothed transitions with FPS-adaptive easing
    (:130-138)
  * scroll zoom in 0.25 steps, min distance 0.75 (:75-81)
  * set_focused_position / reset (:144-159)

Positions/rotations are in the Godot world frame (models/camera.Camera).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..models.camera import Camera

ACCELERATION = 30.0       # camera.gd:15
DECELERATION = -10.0      # camera.gd:16
VEL_MULTIPLIER = 4.0      # camera.gd:17
RUN_MULTIPLIER = 2.5      # camera.gd:10
PITCH_MIN, PITCH_MAX = -80.0, 70.0
ZOOM_STEP = 0.25          # camera.gd:77-80
MIN_ORBIT_DIST = 0.75     # camera.gd:76
MOUSE_SENSITIVITY = 0.4   # camera.gd:5


@dataclasses.dataclass
class InputState:
    """Key/mouse state for one update tick."""
    forward: bool = False   # W
    back: bool = False      # S
    left: bool = False      # A
    right: bool = False     # D
    down: bool = False      # Q
    up: bool = False        # E
    shift: bool = False
    alt: bool = False
    mouse_dx: float = 0.0   # pixels this tick
    mouse_dy: float = 0.0


class FreeLookController:
    """Stateful controller; `update(dt, inputs, mode)` advances the pose."""

    FREE_LOOK, ORBIT, NONE = "free_look", "orbit", "none"

    def __init__(self, camera: Optional[Camera] = None):
        self.camera = camera or Camera.reset_pose()
        self.velocity = np.zeros(3, np.float32)
        self.yaw = 180.0
        self.pitch = 0.0
        self.orbit_position = np.array([0.0, 0.0, 2.0], np.float32)  # -FORWARD*2
        self.target_position = self.camera.position.copy()
        self.orbit_time = 1.0     # camera.gd:32 — swing interpolation clock
        self._swing_from = None   # (yaw, pitch) at orbit entry
        self._swing_to = None
        self._sync_basis()

    # -- pose helpers --------------------------------------------------------

    def _sync_basis(self):
        self.camera = self.camera.with_yaw_pitch(self.yaw, self.pitch)

    # -- per-tick update -----------------------------------------------------

    def update(self, dt: float, inputs: InputState, mode: str = "none",
               fps: float = 60.0) -> Camera:
        if mode == self.FREE_LOOK and (inputs.mouse_dx or inputs.mouse_dy):
            self.yaw -= inputs.mouse_dx * MOUSE_SENSITIVITY
            self.pitch = float(np.clip(
                self.pitch - inputs.mouse_dy * MOUSE_SENSITIVITY,
                PITCH_MIN, PITCH_MAX))
            self._sync_basis()

        if mode == self.ORBIT:
            self._swing_update(dt, fps)
            self._orbit_update(dt, inputs)
        else:
            self._fly_update(dt, inputs)

        # Smooth distance transition toward target (camera.gd:141-142).
        delta = self.target_position - self.camera.position
        if float(delta @ delta) > 1e-6:
            t = min(dt * 5.0, 1.0)
            self.camera = dataclasses.replace(
                self.camera,
                position=(self.camera.position + delta * t).astype(np.float32))
        return self.camera

    def _fly_update(self, dt: float, inputs: InputState):
        """camera.gd:104-128: acceleration toward the desired direction plus a
        constant drag pulling velocity to zero."""
        direction = np.array([
            float(inputs.right) - float(inputs.left),
            float(inputs.up) - float(inputs.down),
            float(inputs.back) - float(inputs.forward),
        ], np.float32)
        dn = np.linalg.norm(direction)
        vn = np.linalg.norm(self.velocity)
        dir_n = direction / dn if dn > 0 else direction
        vel_n = self.velocity / vn if vn > 0 else self.velocity
        offset = (dir_n * ACCELERATION + vel_n * DECELERATION) * \
            VEL_MULTIPLIER * dt

        speed = 1.0
        if inputs.shift:
            speed *= RUN_MULTIPLIER
        if inputs.alt:
            speed /= RUN_MULTIPLIER

        if dn == 0 and float(offset @ offset) > float(
                self.velocity @ self.velocity):
            self.velocity = np.zeros(3, np.float32)
        else:
            self.velocity = np.clip(self.velocity + offset,
                                    -VEL_MULTIPLIER, VEL_MULTIPLIER)
            # translate() moves along local axes (camera.gd:127)
            world = self.camera.basis @ (self.velocity * dt * speed)
            self.camera = dataclasses.replace(
                self.camera,
                position=(self.camera.position + world).astype(np.float32))
        if vn > 1e-9:
            self.target_position = self.camera.position.copy()

    def _orbit_update(self, dt: float, inputs: InputState):
        """camera.gd:54-61: rotate about the focus; yaw scaled by cos(pitch)."""
        dyaw = -inputs.mouse_dx * MOUSE_SENSITIVITY
        dpitch = -inputs.mouse_dy * MOUSE_SENSITIVITY
        new_pitch = self.pitch + dpitch
        rel = self.camera.position - self.orbit_position
        if PITCH_MIN <= new_pitch <= PITCH_MAX:
            rel = _rotate(rel, self.camera.basis[:, 0],
                          math.radians(dpitch))
            self.pitch = new_pitch
        rel = _rotate(rel, self.camera.basis[:, 1],
                      math.radians(dyaw) * math.cos(math.radians(self.pitch)))
        self.yaw += dyaw
        pos = (self.orbit_position + rel).astype(np.float32)
        self.camera = dataclasses.replace(self.camera, position=pos)
        self.camera = self.camera.look_at(self.orbit_position)
        self.target_position = pos.copy()

    # -- orbit entry swing ----------------------------------------------------

    def start_orbit(self):
        """OrbitSwapTimer timeout (camera.gd:36-42): aim a target pose at the
        orbit point; the camera swings onto it over ~0.4 s with the
        reference's cubic ease (camera.gd:130-138). Skips the interpolation
        when already facing the orbit point."""
        rel = self.orbit_position - self.camera.position
        d = float(np.linalg.norm(rel))
        if d < 1e-9:
            self.orbit_time = 1.0
            return
        fwd = rel / d
        to_yaw = math.degrees(math.atan2(-fwd[0], -fwd[2]))
        to_pitch = float(np.clip(math.degrees(math.asin(fwd[1])),
                                 PITCH_MIN, PITCH_MAX))
        # unwrap yaw to the nearest representation
        while to_yaw - self.yaw > 180.0:
            to_yaw -= 360.0
        while to_yaw - self.yaw < -180.0:
            to_yaw += 360.0
        aligned = (abs(to_yaw - self.yaw) < 0.5
                   and abs(to_pitch - self.pitch) < 0.5)
        self.orbit_time = 1.0 if aligned else 0.0
        self._swing_from = (self.yaw, self.pitch)
        self._swing_to = (to_yaw, to_pitch)

    def _swing_update(self, dt: float, fps: float):
        if self.orbit_time >= 0.4 or self._swing_from is None:
            return
        self.orbit_time += dt
        # camera.gd:136: smoothing is less at lower fps (the clock's rate
        # is lerp(1, 0.1, fps / 180)); a cubic ease-out
        ot = self.orbit_time
        t = 1.0 - (1.0 - ot * (1.0 + (0.1 - 1.0) * min(fps / 180.0, 1.0))) \
            ** 3 if ot < 0.4 else 1.0
        t = float(np.clip(t, 0.0, 1.0))
        y0, p0 = self._swing_from
        y1, p1 = self._swing_to
        self.yaw = y0 + (y1 - y0) * t
        self.pitch = p0 + (p1 - p0) * t
        self._sync_basis()
        if ot >= 0.4 or t >= 1.0:
            self.yaw, self.pitch = y1, p1
            self._swing_from = None
            self._sync_basis()

    # -- discrete events ------------------------------------------------------

    def zoom(self, steps: int):
        """Wheel zoom toward/away from the orbit point (camera.gd:75-81)."""
        to_orbit = self.orbit_position - self.target_position
        d = np.linalg.norm(to_orbit)
        if d < 1e-9:
            return
        step = to_orbit / d * ZOOM_STEP * steps
        if steps > 0 and d - ZOOM_STEP * steps < MIN_ORBIT_DIST:
            return
        self.target_position = (self.target_position + step).astype(np.float32)

    def set_focused_position(self, target: np.ndarray):
        """camera.gd:144-149: focus orbit on target; back the camera off 2
        units along its local +Z."""
        self.orbit_position = np.asarray(target, np.float32)
        self.target_position = (self.orbit_position
                                + self.camera.basis[:, 2] * 2.0
                                ).astype(np.float32)

    def reset(self):
        """camera.gd:151-159."""
        self.camera = Camera.reset_pose()
        self.velocity = np.zeros(3, np.float32)
        self.yaw, self.pitch = 180.0, 0.0
        self.orbit_position = np.array([0.0, 0.0, 2.0], np.float32)
        self.target_position = np.zeros(3, np.float32)


def _rotate(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation (Godot Vector3.rotated)."""
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    c, s = math.cos(angle), math.sin(angle)
    return (v * c + np.cross(axis, v) * s
            + axis * (axis @ v) * (1 - c)).astype(np.float32)
