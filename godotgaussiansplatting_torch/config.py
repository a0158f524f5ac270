"""Configuration of the PyTorch/CUDA rasterizer.

Counterpart of ``godotgaussiansplatting_tpu/config.py``: the same frozen
dataclass with the same fields, defaults, ``target_size``, ``tile_dims`` and
``fast_defaults()``, so one config value means the same frame in both
packages. Two fields steer only the TPU kernels' memory layout or schedule;
they are accepted here so configs stay interchangeable, and have no effect:

- ``kernel_vmem_mb``: the TPU's scoped vector-memory budget;
- ``slab_u``: batches pre-gathered into a slab for the TPU's DMA pipeline.

``lockstep_gt`` is the number of tiles the v4 kernel composites together
(ops/render_v4.py), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

TILE_SIZE = 16                  # pixels per tile edge (gsplat_render.glsl:8)
SORT_BUFFER_FACTOR = 10         # max duplicated keys = 10*N
MIN_FACTOR = 255                # saturation early-exit threshold
MIN_ALPHA = 1.0 / MIN_FACTOR    # per-pixel transmittance cutoff
INVALID_KEY = 0xFFFFFFFF        # sort key sentinel for padded/culled slots


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Static configuration of a rasterizer instance (see module docstring).

    Live per-frame knobs (camera, model_scale, heatmap, time) are passed as
    ``ops.pipeline.FrameUniforms`` instead.
    """

    # --- image ---
    width: int = 1920
    height: int = 1080
    render_scale: float = 1.0

    # --- pipeline geometry ---
    tile_size: int = TILE_SIZE
    sort_buffer_factor: int = SORT_BUFFER_FACTOR
    max_tiles_per_splat: int = 32
    giant_splat_capacity: int = 256
    exact_tiers: Tuple[Tuple[int, int], ...] = ((128, 32768), (512, 4096))

    # --- model ---
    sh_degree: int = 3

    # --- fidelity / quirk switches ---
    reference_boundary_quirk: bool = True
    # -focal.y (not -focal.x) multiplies mean.x in J[2][0]
    # (gsplat_projection.glsl:134-137).
    reference_jacobian_quirk: bool = True

    # --- performance knobs ---
    quality: str = "exact"
    dtype: str = "float32"
    # Fast path: lane capacity of the big-splat extraction; None = auto
    # (ops/blocks2.default_big_cap).
    big_capacity: Optional[int] = None
    # Fast path: resident big lanes per tile (ops/bigbin.py).
    big_tile_capacity: int = 128
    # Render kernel generation: "v3" (ops/render_v3.py) or "v4", the
    # lockstep kernel on the cooked payload (ops/render_v4.py).
    kernel: str = "v3"
    # Fast path: blocks per compositing batch (U); None = auto by tile size.
    batch_u: Optional[int] = None
    slab_u: int = 0                       # TPU-only; no effect here
    lockstep_gt: int = 4                  # v4: tiles composited together
    kernel_vmem_mb: Optional[int] = None  # TPU-only; no effect here
    # Fast path: fused projection kernel (ops/projection_kernel.py); False
    # runs the readable projection (ops/projection.py) and the screen
    # clustering of ops/blocks2.build_block_frame2.
    projection_kernel: bool = False
    # Fast path: ship the render kernel the (B, 8, S) word image and unpack
    # in-kernel; False cooks the (B, 16, S) f32 payload. fast_defaults()
    # forces it on for v3 and off for v4, as the JAX package does.
    words_payload: bool = False
    # Fast-path block clustering: "screen" (per-frame cell/depth row sort)
    # or "bricks" (static runs of the load-time curve order).
    cluster: str = "screen"

    @property
    def target_size(self) -> Tuple[int, int]:
        """Render target (width, height) after render_scale, min 1px."""
        w = max(1, int(self.width * self.render_scale))
        h = max(1, int(self.height * self.render_scale))
        return (w, h)

    @property
    def tile_dims(self) -> Tuple[int, int]:
        """Tile grid (cols, rows) = ceil(target / tile_size)."""
        w, h = self.target_size
        t = self.tile_size
        return ((w + t - 1) // t, (h + t - 1) // t)

    @property
    def num_tiles(self) -> int:
        tx, ty = self.tile_dims
        return tx * ty

    def replace(self, **kw) -> "RasterizerConfig":
        return dataclasses.replace(self, **kw)

    def fast_defaults(self) -> "RasterizerConfig":
        """This config with quality='fast' and the fast path's shipped knobs:
        tile_size 32, batch_u 2, the fused projection kernel, the word
        payload and static brick clustering. Knobs already set away from
        their dataclass defaults are respected, except ``words_payload``,
        which is forced for the v3 kernel exactly as the JAX package does."""
        kw = {"quality": "fast", "projection_kernel": True,
              "words_payload": self.kernel != "v4"}
        if self.tile_size == TILE_SIZE:
            kw["tile_size"] = 32
        if self.batch_u is None:
            kw["batch_u"] = 2
        if self.cluster == "screen":
            kw["cluster"] = "bricks"
        return dataclasses.replace(self, **kw)
