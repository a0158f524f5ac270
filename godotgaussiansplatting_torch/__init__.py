"""godotgaussiansplatting_torch — the PyTorch/CUDA port of the renderer.

A second package beside ``godotgaussiansplatting_tpu`` (the JAX reference,
which this package never imports). It renders both paths of that package —
the exact four-stage frame (projection, sort, boundaries, per-tile
composite) and the fast frame (fused projection, brick blocks, tile binning
and the batch-exact v3 or v4 composite) — through the same ``Rasterizer``
engine, with hand-written CUDA kernels for Hopper (``csrc/``) built at first
use. Each module names the JAX module it answers to. ``render_frame`` and
``render_frame_fast`` run eagerly; where the JAX package compiles a frame
(``render_frame_jit``, ``render_frame_fast_jit``), the port replays it as
captured CUDA graphs (``ops.pipeline.ExactFrameGraph``,
``ops.fast_pipeline.FastFrameGraph``), as the engine does on the card.
"""

from .config import RasterizerConfig, SORT_BUFFER_FACTOR, TILE_SIZE
from .models.camera import Camera, orbit_trajectory
from .models.splats import (SplatCloud, cloud_from_numpy, fast_cloud_view,
                            from_arrays, mortonize, photogrammetry_scene,
                            synthetic_scene)
from .ops.fast_pipeline import (FastFrameOutput, StageTimer,
                                pick_splat_position_fast, render_frame_fast,
                                render_frame_fast_staged)
from .ops.pipeline import (FrameOutput, FrameStats, FrameUniforms,
                           make_uniforms, pick_splat_position, render_frame,
                           render_multiview)
from .engine.rasterizer import Rasterizer

__version__ = "0.1.0"

__all__ = [
    "RasterizerConfig", "TILE_SIZE", "SORT_BUFFER_FACTOR", "Camera",
    "orbit_trajectory", "SplatCloud", "cloud_from_numpy", "fast_cloud_view",
    "from_arrays", "mortonize", "synthetic_scene", "photogrammetry_scene",
    "FastFrameOutput", "StageTimer", "pick_splat_position_fast",
    "render_frame_fast", "render_frame_fast_staged", "FrameOutput",
    "FrameStats", "FrameUniforms", "make_uniforms", "render_frame",
    "render_multiview", "pick_splat_position", "Rasterizer", "__version__",
]
