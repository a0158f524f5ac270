"""Camera paths: the one generator every traffic file feeds.

A traffic file (``traffic/<mix>.json``) holds the path's parameters:

  radius, height   the orbit's radius and the camera's height above the
                   target, in scene units (the Godot world's y is up);
  target           the point looked at, in the PLY frame;
  fov_y            vertical field of view, degrees;
  deg_per_frame    the angle the camera advances a frame; 360 over it is a
                   whole number, the frames of a revolution;
  samples_deg      the absolute angles of the sample cameras, whose frames
                   the correctness check and the per-layer work counts use;
  warmup_revolutions  revolutions rendered before the window.

The seed sets the window's start frame, one of the revolution's frames, so
every seed visits the same cameras in another order and each sample angle
once a revolution. The warm-up revolutions start at angle 0 whatever the
seed, so every seed's set-up does the same work: the exact quality grows
its tile capacity, a capture each time, in the order the cameras come.
"""

from __future__ import annotations

import math

import numpy as np

from .reference.camera import flip_xy


class CameraPath:
    """The cameras of one traffic mix for one seed, as (position, target)
    in the Godot world and the field of view."""

    def __init__(self, params: dict, seed: int):
        self.params = params
        self.fov_y = float(params["fov_y"])
        step = float(params["deg_per_frame"])
        per_rev = 360.0 / step
        if abs(per_rev - round(per_rev)) > 1e-9:
            raise ValueError(f"360 / deg_per_frame = {per_rev} is not a "
                             "whole number of frames")
        self.frames_per_revolution = int(round(per_rev))
        self.step = step
        self.start = int(seed) % self.frames_per_revolution
        self.target = flip_xy(params["target"])
        self.samples = [round(float(a) / step) % self.frames_per_revolution
                        for a in params["samples_deg"]]

    def slot(self, i: int) -> int:
        """The revolution's frame that window frame ``i`` shows."""
        return (self.start + i) % self.frames_per_revolution

    def pose(self, slot: int):
        """(position, target) of a revolution frame, Godot world."""
        ang = math.radians(slot * self.step)
        r, h = float(self.params["radius"]), float(self.params["height"])
        pos = self.target + np.array([r * math.sin(ang), h,
                                      r * math.cos(ang)], np.float32)
        return pos.astype(np.float32), self.target

    def warmup_slot(self, i: int) -> int:
        """The revolution's frame that warm-up frame ``i`` shows."""
        return i % self.frames_per_revolution

    @property
    def warmup_frames(self) -> int:
        return int(self.params["warmup_revolutions"]) * \
            self.frames_per_revolution

