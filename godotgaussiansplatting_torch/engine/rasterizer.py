"""The rasterizer engine: device state, per-frame orchestration and knobs.

Counterpart of ``godotgaussiansplatting_tpu/engine/rasterizer.py``
(``GaussianSplattingRasterizer``, util/gaussian_splatting_rasterizer.gd):
it owns the splat model on the device, the camera-change detection,
resize, picking, the heatmap and scale knobs, per-stage telemetry, the
host's phases of each frame and the streaming loader, for both qualities:
``"exact"`` (ops/pipeline.py, the default) and ``"fast"``
(ops/fast_pipeline.py). Its work runs on the card
(``device="cuda"``) unless the caller asks for the CPU, where the plain
versions of the kernels run; without a card the default raises.

Both qualities on the card replay the frame as captured CUDA graphs
(``ops.pipeline.ExactFrameGraph`` and ``ops.fast_pipeline.FastFrameGraph``,
the counterparts of the JAX package's ``render_frame_jit``,
``render_frame_fast_jit`` and their stage jits): one capture per config,
splat count and model (and, for the exact quality, tile capacity), reused
across camera, heatmap, model scale and time, which are uniforms. On the
CPU the same frames run eagerly. Picking runs eagerly. The kernels are
built once per checkout at first use (``kernels``), so there is no
counterpart of the JAX package's persistent XLA compile cache.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RasterizerConfig
from ..models import ply as plyio
from ..models.camera import Camera
from ..models.splats import (SplatCloud, fast_cloud_view, from_soa,
                             mortonize, refresh_fast_view)
from ..ops.fast_pipeline import (FastFrameGraph, pick_splat_position_fast,
                                 render_frame_fast_staged)
from ..ops.pipeline import (ExactFrameGraph, FrameUniforms, exact_graph_key,
                            graph_key, pack_uniforms, pick_splat_position,
                            render_frame_staged, uniforms_from_buffer)
from ..utils import telemetry
from ..utils.image import hwc
from ..utils.telemetry import (CAMERA, CAPTURE, GRAPH, LAUNCH, OVERFLOW,
                               TIMINGS, UNIFORMS, UPLOAD, WAIT, StageTimings,
                               device_memory_stats, format_bytes,
                               make_stage_timer)
from .loader import StreamingLoader


def _on_device(cloud: SplatCloud, device: torch.device) -> SplatCloud:
    if cloud.device == device:
        return cloud
    return dataclasses.replace(
        cloud, means=cloud.means.to(device), cov3d=cloud.cov3d.to(device),
        opacity=cloud.opacity.to(device), sh=cloud.sh.to(device),
        upload_time=cloud.upload_time.to(device))


class Rasterizer:
    """Owns one splat model and its render state.

    Live knobs (the reference's panel, main.gd:49-68): render_scale,
    model_scale, should_enable_heatmap, basis_override. Changing
    texture_size or render_scale changes the next frame's target.

    Each frame's host phases (``utils.telemetry.PHASES``), from
    ``update_camera_matrices`` to the end of ``rasterize``, are one row of
    ``host_phases`` (the process's ``telemetry.HOST_PHASES`` unless
    another ``HostPhases`` is set).
    """

    def __init__(self, source, texture_size: Tuple[int, int] = (1280, 720),
                 camera: Optional[Camera] = None,
                 config: Optional[RasterizerConfig] = None,
                 tile_capacity: int = 2048, stream: bool = False,
                 chunks: int = 64, quality: str | None = None,
                 auto_capacity: bool = True, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Rasterizer: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        base = config or RasterizerConfig()
        if quality is not None:
            base = base.replace(quality=quality)
        if base.quality == "fast" and config is None:
            # no explicit config: the fast path's shipped knobs
            base = base.fast_defaults()
        self.quality = base.quality
        self._cfg = base.replace(width=int(texture_size[0]),
                                 height=int(texture_size[1]))
        self.camera = camera or Camera.reset_pose()
        self.tile_capacity = tile_capacity
        self.auto_capacity = auto_capacity

        self.render_scale = base.render_scale
        self.model_scale = 1.0
        self.should_enable_heatmap = False
        self.basis_override = np.eye(3, dtype=np.float32)

        self.loader: Optional[StreamingLoader] = None
        # Non-streamed models start fully faded in (the clock starts past
        # the ~1.35 s load animation); streaming starts a live clock.
        self._t0 = time.monotonic() - 10.0
        if isinstance(source, SplatCloud):
            self.cloud = _on_device(source, self.device)
        else:
            ply = (source if isinstance(source, plyio.PlyFile)
                   else plyio.PlyFile.parse(source))
            if stream:
                self._t0 = time.monotonic()
                self.loader = StreamingLoader(
                    ply, chunks=chunks, time_fn=self._now,
                    morton=(self.quality == "fast"),
                    device=self.device).start()
                self.cloud = self.loader.cloud
            else:
                self.cloud = from_soa(*plyio.splat_soa_from_ply(ply),
                                      device=self.device)
        if self.quality == "fast" and self.loader is None:
            self.cloud = mortonize(self.cloud)

        self.timings = StageTimings()
        self.host_phases = telemetry.HOST_PHASES
        self.last_frame = None
        self._fast_cloud = None
        self._fast_cloud_src = None
        self._fast_cloud_writes = 0
        # the frame's CUDA graphs (one set at a time) and their captures
        self.fast_graph: Optional[FastFrameGraph] = None
        self.exact_graph: Optional[ExactFrameGraph] = None
        self.graph_captures = 0
        self._cached_view: Optional[np.ndarray] = None
        self._cached_proj: Optional[np.ndarray] = None

    # -- clocks / state ----------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    @property
    def config(self) -> RasterizerConfig:
        return self._cfg.replace(render_scale=self.render_scale)

    @property
    def texture_size(self) -> Tuple[int, int]:
        return self.config.target_size

    @texture_size.setter
    def texture_size(self, wh: Tuple[int, int]) -> None:
        self._cfg = self._cfg.replace(width=int(wh[0]), height=int(wh[1]))
        self._cached_view = None  # force the next frame's matrix rebuild

    @property
    def is_loaded(self) -> bool:
        return self.loader is None or not self.loader.is_loading

    @property
    def num_splats_loaded(self) -> int:
        if self.loader is None:
            return self.cloud.num_splats
        return self.loader.num_splats_loaded

    # -- camera ------------------------------------------------------------

    def update_camera_matrices(self) -> bool:
        """Rebuild view and projection if the camera changed since the last
        call; returns the changed flag (the reference's render-pause power
        saver, gaussian_splatting_rasterizer.gd:175-195). Its time is the
        ``camera`` phase of the frame that follows."""
        was = self.host_phases.phase
        self.host_phases.mark(CAMERA)
        cam = self._camera_with_override()
        w, h = self.texture_size
        view = cam.view_matrix()
        proj = cam.projection_matrix(w, h)
        changed = (self._cached_view is None
                   or not np.array_equal(view, self._cached_view)
                   or not np.array_equal(proj, self._cached_proj))
        if changed:
            self._cached_view, self._cached_proj = view, proj
        self.host_phases.mark(was)
        return changed

    def _camera_with_override(self) -> Camera:
        return dataclasses.replace(self.camera,
                                   basis_override=self.basis_override)

    def _uniform_values(self) -> np.ndarray:
        """This frame's packed (UNIFORM_WIDTH,) f32 uniform vector."""
        if self._cached_view is None:
            self.update_camera_matrices()
        cam = self._camera_with_override()
        return pack_uniforms(self._cached_view, self._cached_proj,
                             cam.camera_pos_ply(), self.model_scale,
                             self._now(),
                             1.0 if self.should_enable_heatmap else 0.0)

    def _uniforms(self) -> FrameUniforms:
        return uniforms_from_buffer(torch.as_tensor(self._uniform_values(),
                                                    device=self.device))

    def _sync(self) -> None:
        self.host_phases.mark(WAIT)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.host_phases.synced()

    def _lock(self):
        return (self.loader.write_lock if self.loader is not None
                else contextlib.nullcontext())

    # -- frame -------------------------------------------------------------

    def rasterize(self, sync: bool = False):
        """Render one frame (gaussian_splatting_rasterizer.gd:122-160).

        With sync=True it waits for the frame and records its wall time and
        per-stage times (CUDA events on the card), which debug_info shows,
        and grows the exact path's tile capacity if a tile overflowed. The
        ``Frame`` time runs from the call to the end of the wait: the
        host phases ``uniforms`` to ``wait`` of the frame's row."""
        phases = self.host_phases
        t0 = phases.begin(UNIFORMS)
        try:
            values = self._uniform_values()
            phases.mark(GRAPH)
            timer = make_stage_timer(self.device, phases) if sync else None
            with self._lock():
                if self.loader is not None:
                    self.cloud = self.loader.cloud
                if self.quality == "fast":
                    out = self._fast_frame(values, timer)
                else:
                    out = self._exact_frame(values, timer)
            if sync:
                self._sync()
                frame_ms = (phases.mark(TIMINGS) - t0) * 1e3
                for name, ms in timer.times_ms().items():
                    self.timings.record(name, ms)
                self.timings.record(telemetry.FRAME, frame_ms)
                timer = None          # its CUDA events are freed here
                regrown = self._check_overflow(out)
                if regrown is not None:
                    out = regrown  # the triggering frame is re-rendered
            self.last_frame = out
            return out
        finally:
            phases.end()

    def _eager_frame(self, values, stages):
        """The CPU frame: the uniform vector onto the device, then
        ``stages(uniforms)`` run eagerly."""
        self.host_phases.mark(UPLOAD)
        uniforms = uniforms_from_buffer(torch.as_tensor(values,
                                                        device=self.device))
        self.host_phases.mark(LAUNCH)
        return stages(uniforms)

    def _exact_frame(self, values, timer):
        """The exact frame: replayed CUDA graphs on the card (captured anew
        when ``exact_graph_key`` moves: config, splat count, model or tile
        capacity), the eager staged frame on the CPU. A streamed model is
        written into the cloud's tensors in place, so the graphs read each
        chunk the loader has written."""
        phases = self.host_phases
        cfg = self.config
        if self.device.type != "cuda":
            return self._eager_frame(values, lambda u: render_frame_staged(
                self.cloud, u, cfg, tile_capacity=self.tile_capacity,
                timer=timer))
        if (self.exact_graph is None or self.exact_graph.key
                != exact_graph_key(self.cloud, cfg, self.tile_capacity)):
            phases.mark(CAPTURE)
            self.exact_graph = None      # the old pool goes first
            self.exact_graph = ExactFrameGraph(self.cloud, cfg, values,
                                               self.tile_capacity)
            self.graph_captures += 1
        return self.exact_graph.render(values, timer, phases)

    def _fast_frame(self, values, timer):
        """The fast frame: replayed CUDA graphs on the card (captured anew
        when ``graph_key`` moves), the eager staged frame on the CPU."""
        phases = self.host_phases
        cloud = self._render_cloud()
        cfg = self.config
        if self.device.type != "cuda":
            return self._eager_frame(
                values,
                lambda u: render_frame_fast_staged(cloud, u, cfg, timer=timer))
        if (self.fast_graph is None
                or self.fast_graph.key != graph_key(cloud, cfg)):
            phases.mark(CAPTURE)
            self.fast_graph = None       # the old pool goes first
            self.fast_graph = FastFrameGraph(cloud, cfg, values)
            self.graph_captures += 1
        return self.fast_graph.render(values, timer, phases)

    def _render_cloud(self) -> SplatCloud:
        """The fast path's view of the model (bf16 SH, splat-minor for the
        fused projection kernel); ``self.cloud`` keeps full precision for
        picking, state save and export. A streamed cloud is written in
        place, so its view's SH is refreshed in place whenever the loader
        wrote a chunk since the last frame (the caller holds
        ``write_lock``)."""
        c = self.cloud
        writes = self.loader.writes if self.loader is not None else 0
        if self._fast_cloud_src is not c:
            self._fast_cloud = fast_cloud_view(
                c, planar_sh=self.config.projection_kernel)
            self._fast_cloud_src = c
        elif writes != self._fast_cloud_writes:
            refresh_fast_view(self._fast_cloud, c)
        self._fast_cloud_writes = writes
        return self._fast_cloud

    def _check_overflow(self, out):
        """The exact path truncates a tile's list at its capacity; grow the
        capacity to the next power of two covering the densest tile and
        re-render (on the card a new capacity is a new capture; the count
        is read after the frame's replay), or warn without auto_capacity
        (the reference's '(buffer overflow!)' flag, main.gd:98-100).
        Returns the re-rendered frame, or None."""
        if self.quality != "exact":
            return None
        self.host_phases.mark(OVERFLOW)
        max_tile = int(out.stats.max_tile_count)
        if self.device.type == "cuda":
            self.host_phases.synced()
        if max_tile <= self.tile_capacity:
            return None
        if self.auto_capacity:
            new_cap = 1 << int(np.ceil(np.log2(max_tile)))
            self.tile_capacity = max(new_cap, self.tile_capacity * 2)
            regrown = self.rasterize(sync=False)
            self._sync()
            return regrown
        import warnings
        warnings.warn(
            f"exact-mode tile_capacity {self.tile_capacity} exceeded "
            f"(densest tile: {max_tile} splats); farthest splats are "
            f"dropped. Raise tile_capacity or pass auto_capacity=True.",
            RuntimeWarning, stacklevel=3)
        return None

    def warmup(self) -> float:
        """Render one synchronised frame (building the kernels on first use);
        returns the wall seconds spent."""
        t0 = time.perf_counter()
        self.rasterize(sync=True)
        return time.perf_counter() - t0

    def image(self) -> np.ndarray:
        """Host copy of the last frame, (H, W, 4) linear f32 (the fast
        path's planar (4, H, W) image is viewed channels-last)."""
        if self.last_frame is None:
            self.rasterize()
        return hwc(self.last_frame.image)

    # -- picking -----------------------------------------------------------

    def get_splat_position(self, screen_position) -> np.ndarray:
        """World-space position of the splat at a window pixel, or +inf
        (gaussian_splatting_rasterizer.gd:162-171); render_scale maps the
        window pixel into the render target."""
        if self.last_frame is None:
            self.rasterize()
        gx, gy = self.config.tile_dims
        ts = self.config.tile_size
        sx = int(screen_position[0] * self.render_scale) // ts
        sy = int(screen_position[1] * self.render_scale) // ts
        if not (0 <= sx < gx and 0 <= sy < gy):
            return np.full(3, np.inf, np.float32)
        tile_id = sy * gx + sx
        with self._lock():
            if self.loader is not None:
                self.cloud = self.loader.cloud
            if self.quality == "fast":
                pos = pick_splat_position_fast(
                    self.last_frame, tile_id, self.cloud, self.model_scale,
                    self.config)
            else:
                pos = pick_splat_position(self.last_frame, tile_id)
            pos = pos.cpu().numpy()
        if not np.all(np.isfinite(pos)):
            return np.full(3, np.inf, np.float32)
        # host transform: basis_override^-1 (-x, -y, z)  (:171)
        flipped = np.array([-pos[0], -pos[1], pos[2]], np.float32)
        return np.linalg.inv(self.basis_override) @ flipped

    # -- stats -------------------------------------------------------------

    def debug_info(self) -> dict:
        """The panel's data (main.gd:93-119): rendered splat count with the
        overflow flag, memory use, per-stage times, sizes."""
        info = {
            "texture_size": self.texture_size,
            "num_splats": self.cloud.num_splats,
            "num_splats_loaded": self.num_splats_loaded,
            "is_loaded": self.is_loaded,
            "timings": self.timings.as_dict(),
            "timing_lines": self.timings.lines(),
            "host_timings": {},
        }
        last = self.host_phases.last_frames(1)
        if len(last):
            info["host_timings"] = telemetry.host_timings(last[-1])
        if self.last_frame is not None:
            stats = self.last_frame.stats
            pairs = int(stats.num_pairs)
            cap = self.cloud.capacity * self.config.sort_buffer_factor
            info["rendered_splats"] = pairs
            info["buffer_overflow"] = pairs > cap  # main.gd:100
            info["pair_overflow_dropped"] = int(stats.num_overflow)
            info["max_tile_count"] = int(stats.max_tile_count)
        mem = device_memory_stats(self.device)
        if mem:
            info["memory_used"] = format_bytes(mem["bytes_in_use"])
        return info

    def cleanup(self) -> None:
        """cleanup_gpu's counterpart: cancel streaming; device memory is
        freed with the tensors."""
        if self.loader is not None:
            self.loader.cancel()
            self.loader.join(timeout=5)
