"""godotgaussiansplatting_torch — the PyTorch/CUDA port of the renderer.

A second package beside ``godotgaussiansplatting_tpu`` (the JAX reference,
which this package never imports). It renders the fast path of that package
— fused projection, brick blocks, tile binning and the batch-exact v3
composite — with two hand-written CUDA kernels for Hopper (``csrc/``), built
at first use. Each module names the JAX module it answers to.
"""

from .config import RasterizerConfig, TILE_SIZE
from .models.camera import Camera, orbit_trajectory
from .models.splats import (SplatCloud, cloud_from_numpy, fast_cloud_view,
                            from_arrays, mortonize, synthetic_scene)
from .ops.fast_pipeline import (FastFrameOutput, StageTimer,
                                pick_splat_position_fast, render_frame_fast,
                                render_frame_fast_staged)
from .ops.pipeline import FrameStats, FrameUniforms, make_uniforms

__version__ = "0.1.0"

__all__ = [
    "RasterizerConfig", "TILE_SIZE", "Camera", "orbit_trajectory",
    "SplatCloud", "cloud_from_numpy", "fast_cloud_view", "from_arrays",
    "mortonize", "synthetic_scene", "FastFrameOutput", "StageTimer",
    "pick_splat_position_fast", "render_frame_fast",
    "render_frame_fast_staged", "FrameStats", "FrameUniforms",
    "make_uniforms", "__version__",
]
