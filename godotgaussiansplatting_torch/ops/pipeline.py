"""The exact four-stage frame: projection -> sort -> boundaries -> render,
with its per-frame uniforms, statistics and picking, and the captured CUDA
graphs of a staged frame.

Counterpart of ``godotgaussiansplatting_tpu/ops/pipeline.py``. Stage 1 is
the readable projection (ops/projection.py, the kernel
csrc/projection_readable.cu on the card), stages 2-3 ops/sort.py (the
emission kernel csrc/emit_exact.cu, torch's sort and search) and stage 4
ops/render_exact.py (the kernel csrc/render_exact.cu). Every stage keeps
its shapes static and reads nothing back to the host, as the JAX
package's single device-resident program does. ``render_frame`` runs the
four stages eagerly; ``ExactFrameGraph`` captures them as CUDA graphs and
replays them (the engine's exact frame on the card): the counterpart of
``render_frame_jit`` and the four ``_stage_*_x`` jits. ``StageGraphs`` is
the capture and replay both graphed frames share (``FastFrameGraph`` in
ops/fast_pipeline.py is the other).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import RasterizerConfig
from ..utils.telemetry import LAUNCH, NO_PHASES, OUTPUTS, UPLOAD
from .projection import project_splats
from .render_exact import render_tiles
from .sort import emit_and_sort, tile_boundaries


class FrameUniforms(NamedTuple):
    """Per-frame state (the reference's uniforms and push constants,
    gaussian_splatting_rasterizer.gd:125-126, 181-193)."""

    view: torch.Tensor          # (4, 4) f32
    proj: torch.Tensor          # (4, 4) f32
    camera_pos: torch.Tensor    # (3,) f32, PLY frame
    model_scale: torch.Tensor   # () f32
    time: torch.Tensor          # () f32 seconds (fade-in clock)
    heatmap_factor: torch.Tensor  # () f32 0/1


# The packed uniform vector: view (16, row-major), proj (16), camera_pos (3),
# model_scale, time, heatmap_factor.
UNIFORM_WIDTH = 38


def pack_uniforms(view, proj, camera_pos, model_scale, time,
                  heatmap) -> np.ndarray:
    """A frame's uniforms as one (UNIFORM_WIDTH,) f32 host vector, the
    layout ``uniforms_from_buffer`` reads."""
    out = np.empty(UNIFORM_WIDTH, np.float32)
    out[0:16] = np.asarray(view, np.float32).reshape(16)
    out[16:32] = np.asarray(proj, np.float32).reshape(16)
    out[32:35] = np.asarray(camera_pos, np.float32).reshape(3)
    out[35:38] = (model_scale, time, heatmap)
    return out


def uniforms_from_buffer(buf: torch.Tensor) -> FrameUniforms:
    """FrameUniforms as views into one (UNIFORM_WIDTH,) f32 tensor, so that
    one copy uploads a frame's uniforms."""
    return FrameUniforms(view=buf[0:16].view(4, 4),
                         proj=buf[16:32].view(4, 4), camera_pos=buf[32:35],
                         model_scale=buf[35], time=buf[36],
                         heatmap_factor=buf[37])


def make_uniforms(camera, cfg: RasterizerConfig, model_scale: float = 1.0,
                  time: float = 1e9, heatmap: float = 0.0,
                  device="cuda") -> FrameUniforms:
    """Uniforms from a models.camera.Camera, on ``device`` (the card unless
    the caller asks for another; without a card the default raises)."""
    w, h = cfg.target_size
    values = pack_uniforms(camera.view_matrix(),
                           camera.projection_matrix(w, h),
                           camera.camera_pos_ply(), model_scale, time,
                           heatmap)
    return uniforms_from_buffer(torch.as_tensor(values, device=device))


class FrameStats(NamedTuple):
    num_pairs: torch.Tensor      # () i32 splat-tile pairs ("Rendered Splats")
    num_overflow: torch.Tensor   # () i32 pairs dropped by capacity caps
    max_tile_count: torch.Tensor  # () i32 densest tile


class FrameOutput(NamedTuple):
    image: torch.Tensor          # (H, W, 4) f32
    stats: FrameStats
    # what picking reads (get_splat_position):
    sorted_values: torch.Tensor  # (K_max,) i32
    tile_start: torch.Tensor     # (T,) i32
    tile_end: torch.Tensor       # (T,) i32
    tile_t0: torch.Tensor        # (T,) f32
    splat_pos: torch.Tensor      # (P, 3) model-scaled positions


def _exact_stages(cloud, uniforms: FrameUniforms, cfg: RasterizerConfig,
                  tile_capacity: int) -> tuple:
    """The exact frame's four stages as (name, function) pairs, in order:
    each function takes the one before's result (the first takes None) and
    the last returns the FrameOutput."""
    def project(_):
        return project_splats(
            cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uniforms.view, uniforms.proj,
            uniforms.camera_pos, uniforms.model_scale, uniforms.time, cfg)

    def sort(prj):
        return prj, emit_and_sort(prj.valid, prj.rect, prj.num_tiles,
                                  prj.depth16, cfg)

    def boundaries(sorted_):
        prj, pairs = sorted_
        return prj, pairs, tile_boundaries(pairs.keys, pairs.num_pairs, cfg)

    def render(bounded):
        prj, pairs, (start, end) = bounded
        out = render_tiles(pairs.values, start, end, prj.image_pos,
                           prj.conic, prj.color, uniforms.heatmap_factor,
                           cfg, tile_capacity=tile_capacity)
        stats = FrameStats(num_pairs=pairs.num_pairs,
                           num_overflow=pairs.num_overflow,
                           max_tile_count=out.tile_counts.max())
        return FrameOutput(image=out.image, stats=stats,
                           sorted_values=pairs.values, tile_start=start,
                           tile_end=end, tile_t0=out.tile_t0,
                           splat_pos=prj.pos)

    return (("Projection", project), ("Sort", sort),
            ("Boundaries", boundaries), ("Render", render))


def run_stages(stages, timer=None):
    """Run (name, function) stages in order, each timed by ``timer``
    (``timer.stage(name)``, e.g. ``StageTimer``) when one is passed."""
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    out = None
    for name, fn in stages:
        with stage(name):
            out = fn(out)
    return out


def render_frame_staged(cloud, uniforms: FrameUniforms,
                        cfg: RasterizerConfig, tile_capacity: int = 2048,
                        timer=None) -> FrameOutput:
    """One exact frame in the reference's four stages (Projection, Sort,
    Boundaries, Render; gaussian_splatting_rasterizer.gd:135-160), run
    eagerly, each timed by ``timer`` when one is passed."""
    return run_stages(_exact_stages(cloud, uniforms, cfg, tile_capacity),
                      timer)


def render_frame(cloud, uniforms: FrameUniforms, cfg: RasterizerConfig,
                 tile_capacity: int = 2048) -> FrameOutput:
    """One exact frame (the JAX package's ``render_frame``; run it as
    ``ExactFrameGraph`` for ``render_frame_jit``)."""
    return render_frame_staged(cloud, uniforms, cfg, tile_capacity)


def graph_key(cloud, cfg: RasterizerConfig) -> tuple:
    """What a captured frame depends on besides its uniforms: the config,
    the splat count and the cloud's tensors (address, shape, dtype). A
    frame whose key differs needs a new capture; the camera, heatmap,
    model scale and time are uniforms and do not enter it."""
    tensors = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
               cloud.upload_time)
    return (cfg, cloud.num_splats,
            tuple((t.data_ptr(), tuple(t.shape), t.dtype, t.device)
                  for t in tensors))


def exact_graph_key(cloud, cfg: RasterizerConfig, tile_capacity: int) -> tuple:
    """``graph_key`` and the tile capacity, which sizes the exact
    composite: what an ``ExactFrameGraph`` is captured for."""
    return graph_key(cloud, cfg) + (int(tile_capacity),)


class StageGraphs:
    """A staged frame as captured CUDA graphs, one a stage, replayed back
    to back on the current stream with no host work between them.

    Capture (in ``__init__``): one eager warm-up frame on a side stream,
    which builds the kernels, under ``torch.cuda.set_sync_debug_mode
    ("error")``, so that a host read on the path raises there; then the
    stages, each into its own graph, all in one memory pool, with
    ``capture_error_mode="thread_local"`` (other threads may pin memory and
    copy while a frame is captured). The caller holds whatever lock guards
    the cloud's tensors (a streaming loader's ``write_lock``).

    Inputs: whatever the stages read (a cloud's tensors, whose addresses
    the graphs keep), and one (UNIFORM_WIDTH,) f32 device buffer that the
    frame's FrameUniforms are views into: ``make_stages(uniforms)`` returns
    the stages on those views. ``replay`` writes a frame's uniform vector
    (``pack_uniforms``) with one copy from pinned host memory, whose reuse
    waits on the event of the copy before, and returns the last stage's
    output: the graphs' own buffers, valid until the next replay. Given an
    engine frame's ``utils.telemetry.HostPhases``, a replay marks its
    ``upload`` and ``launch`` phases there and counts the upload's wait and
    the graphs it launches.

    Launch counts: a capture records its kernels' launches
    (``kernels.recording_launches``) in ``launches``, and each replay adds
    them to the counters. A failed capture or replay raises; nothing falls
    back to the eager frame.
    """

    def __init__(self, make_stages, device: torch.device, uniform_values):
        if device.type != "cuda":
            raise ValueError(f"{type(self).__name__} captures CUDA work only")
        self._host = torch.empty(UNIFORM_WIDTH, dtype=torch.float32,
                                 pin_memory=True)
        self._dev = torch.empty(UNIFORM_WIDTH, dtype=torch.float32,
                                device=device)
        self._uploaded = torch.cuda.Event()
        stages = make_stages(uniforms_from_buffer(self._dev))
        self._upload(uniform_values)
        self._capture(stages, device)

    def _upload(self, values, phases=NO_PHASES) -> None:
        self._uploaded.synchronize()     # the last copy has left the buffer
        phases.synced()
        self._host.numpy()[:] = values
        self._dev.copy_(self._host, non_blocking=True)
        self._uploaded.record()

    def _capture(self, stages, dev) -> None:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = run_stages(stages)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            del out
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self._graphs, self.launches = [], {}
        out = None
        for name, fn in stages:
            g = torch.cuda.CUDAGraph()
            with kernels.recording_launches() as recorded, torch.cuda.graph(
                    g, pool=pool, stream=side,
                    capture_error_mode="thread_local"):
                out = fn(out)
            for kernel, n in recorded.items():
                self.launches[kernel] = self.launches.get(kernel, 0) + n
            self._graphs.append((name, g))
        self._out = out

    def replay(self, uniform_values, timer=None, phases=NO_PHASES):
        """Replay the frame for one (UNIFORM_WIDTH,) f32 uniform vector,
        each stage timed by ``timer`` when one is passed, the host phases
        marked on ``phases``; returns the graphs' output buffers."""
        phases.mark(UPLOAD)
        self._upload(uniform_values, phases)
        phases.mark(LAUNCH)
        stage = timer.stage if timer is not None else (
            lambda name: contextlib.nullcontext())
        for name, g in self._graphs:
            with stage(name):
                g.replay()
        kernels.count_launches(self.launches)
        phases.launched(len(self._graphs))
        return self._out


class ExactFrameGraph(StageGraphs):
    """The exact frame as four captured CUDA graphs (Projection, Sort,
    Boundaries, Render; see ``StageGraphs``): the port's counterpart of the
    JAX package's ``render_frame_jit`` and its four stage jits
    (``_stage_project_x``, ``_stage_sort_x``, ``_stage_bounds_x``,
    ``_stage_render_x``), compiled once per static configuration. The
    frame is ``render_frame_staged``'s, bit for bit. ``key`` is the
    ``exact_graph_key`` it was captured for: a new tile capacity needs a
    new capture.

    Output: ``render`` copies ``image``, ``tile_t0`` and ``stats`` out of
    the graphs' buffers, so a frame a caller keeps is not overwritten by
    the next. The picking fields (``sorted_values``, ``tile_start``,
    ``tile_end``, ``splat_pos``) are the graphs' buffers: valid until the
    next ``render`` of this graph.
    """

    def __init__(self, cloud, cfg: RasterizerConfig, uniform_values,
                 tile_capacity: int = 2048):
        self.key = exact_graph_key(cloud, cfg, tile_capacity)
        self.cloud = cloud
        super().__init__(
            lambda uniforms: _exact_stages(cloud, uniforms, cfg,
                                           tile_capacity),
            cloud.means.device, uniform_values)

    def render(self, uniform_values, timer=None,
               phases=NO_PHASES) -> FrameOutput:
        """Replay the frame for one (UNIFORM_WIDTH,) f32 uniform vector,
        each stage timed by ``timer`` when one is passed, its host phases
        marked on ``phases`` (a ``utils.telemetry.HostPhases``)."""
        out = self.replay(uniform_values, timer, phases)
        phases.mark(OUTPUTS)
        return out._replace(
            image=out.image.clone(), tile_t0=out.tile_t0.clone(),
            stats=FrameStats(*(s.clone() for s in out.stats)))


def render_multiview(cloud, uniforms_batched: FrameUniforms,
                     cfg: RasterizerConfig,
                     tile_capacity: int = 2048) -> torch.Tensor:
    """Several views of one cloud: every field of ``uniforms_batched`` has a
    leading view axis. Returns (V, H, W, 4)."""
    n = uniforms_batched.view.shape[0]
    return torch.stack([
        render_frame(cloud, FrameUniforms(*(f[i] for f in uniforms_batched)),
                     cfg, tile_capacity).image
        for i in range(n)])


def pick_splat_position(frame: FrameOutput, tile_id) -> torch.Tensor:
    """The splat 10% into the tile's depth-sorted range
    (gaussian_splatting_rasterizer.gd:162-171, gsplat_render.glsl:103-110),
    or +inf when the tile is empty or its pixel (0, 0) is untouched. The
    host applies basis_override^-1 (-x, -y, z)."""
    s = frame.tile_start[tile_id].to(torch.int64)
    n = frame.tile_end[tile_id].to(torch.int64) - s
    K = frame.sorted_values.shape[0]
    idx = frame.sorted_values[torch.clamp(s + n // 10, 0, K - 1)]
    pos = frame.splat_pos[idx.to(torch.int64)]
    hit = (n > 0) & (frame.tile_t0[tile_id] != 1.0)
    return torch.where(hit, pos, float("inf"))
