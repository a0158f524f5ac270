"""Headless rendering: single frames and camera trajectories to PNG.

Counterpart of ``godotgaussiansplatting_tpu/viewer/offline.py``, the
testable half of the reference's L4 app layer (SURVEY.md §1): where the
Godot viewer blits the render texture to a viewport quad
(resources/shaders/spatial/main.gdshader), this writes sRGB PNGs; BASELINE
config 2's "orbit-camera trajectory" playback lives here.

Each camera is applied with ``update_camera_matrices()``: the engine caches
its view and projection matrices, and the JAX package's copy of this
module sets the camera without that call, so every frame after its first
keeps the first camera's matrices.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from ..engine.rasterizer import Rasterizer
from ..models.camera import Camera, orbit_trajectory
from ..utils.image import write_png


def _set_camera(rasterizer: Rasterizer, camera: Camera) -> None:
    rasterizer.camera = camera
    rasterizer.update_camera_matrices()


def render_frame_png(rasterizer: Rasterizer, path: str,
                     camera: Optional[Camera] = None) -> dict:
    """Render one frame to a PNG; returns debug info for the frame."""
    if camera is not None:
        _set_camera(rasterizer, camera)
    rasterizer.rasterize(sync=True)
    write_png(path, rasterizer.image())
    return rasterizer.debug_info()


def render_trajectory(
    rasterizer: Rasterizer,
    cameras: Sequence[Camera],
    out_dir: str,
    prefix: str = "frame",
) -> dict:
    """Render a camera path to numbered PNGs; returns timing summary (the
    frame times of ``rasterize(sync=True)``, without the PNG writes)."""
    os.makedirs(out_dir, exist_ok=True)
    frame_ms = []
    for i, cam in enumerate(cameras):
        _set_camera(rasterizer, cam)
        t0 = time.perf_counter()
        rasterizer.rasterize(sync=True)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        write_png(os.path.join(out_dir, f"{prefix}_{i:04d}.png"),
                  rasterizer.image())
    arr = np.asarray(frame_ms)
    return {
        "frames": len(cameras),
        "mean_ms": float(arr.mean()),
        "min_ms": float(arr.min()),
        "fps": 1e3 / float(arr.mean()),
        "out_dir": out_dir,
    }


def render_orbit(rasterizer: Rasterizer, out_dir: str, num_frames: int = 24,
                 radius: float = 5.0, target=(0.0, 0.0, 6.0)) -> dict:
    return render_trajectory(
        rasterizer, orbit_trajectory(num_frames, radius, target=target),
        out_dir)
