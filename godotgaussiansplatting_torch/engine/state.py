"""Save and load the engine's state.

Counterpart of ``godotgaussiansplatting_tpu/engine/state.py``, with the same
``.npz`` layout, so a state saved by either package loads in the other: the
splat SoA (read back to the host) and the viewer state (camera pose and
knobs).
"""

from __future__ import annotations

import json

import numpy as np

from ..models.camera import Camera
from ..models.splats import cloud_from_numpy
from .rasterizer import Rasterizer


def save_state(path: str, rasterizer: Rasterizer) -> None:
    cloud = rasterizer.cloud
    cam = rasterizer.camera
    meta = dict(
        num_splats=cloud.num_splats,
        model_scale=rasterizer.model_scale,
        render_scale=rasterizer.render_scale,
        heatmap=rasterizer.should_enable_heatmap,
        quality=rasterizer.quality,
        texture_size=list(rasterizer._cfg.target_size),
        fov_y=cam.fov_y, znear=cam.znear, zfar=cam.zfar,
    )

    def host(t):
        return t.detach().float().cpu().numpy()

    np.savez_compressed(
        path,
        means=host(cloud.means), cov3d=host(cloud.cov3d),
        opacity=host(cloud.opacity), sh=host(cloud.sh),
        upload_time=host(cloud.upload_time),
        camera_position=cam.position, camera_basis=cam.basis,
        basis_override=rasterizer.basis_override,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def load_state(path: str, device="cuda") -> Rasterizer:
    """A Rasterizer on ``device`` (the card unless the caller asks for
    another) from a saved state."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    cloud = cloud_from_numpy(z["means"], z["cov3d"], z["opacity"], z["sh"],
                             z["upload_time"], int(meta["num_splats"]),
                             device=device)
    cam = Camera(position=z["camera_position"], basis=z["camera_basis"],
                 fov_y=meta["fov_y"], znear=meta["znear"], zfar=meta["zfar"])
    r = Rasterizer(cloud, texture_size=tuple(meta["texture_size"]),
                   camera=cam, quality=meta["quality"], device=device)
    r.model_scale = meta["model_scale"]
    r.render_scale = meta["render_scale"]
    r.should_enable_heatmap = meta["heatmap"]
    r.basis_override = np.asarray(z["basis_override"], np.float32)
    return r
