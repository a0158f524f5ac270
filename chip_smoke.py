"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --binning
    python3 chip_smoke.py --sorts [OTHER_CHECKOUT]

The second form runs phase 1's build and phase 6's Binning check alone
(both kernels bit-equal to their plain versions, timed beside their
bounds, and torch.profiler over 3 eager Binning stages of fast_defaults()
and quality="fast"): a quick comparison of two trees' Binning kernels on
one card. The third runs phase 1's build and phase 6's plan and two sort
records alone (emit_plan, sort_pairs and screen_sort bit-equal to their
plain versions on their 1080p inputs and edge cases, timed beside their
bounds, with the pairs a tile and the passes a row they meet), the 4K
plan and exact sort at end_bit 31, the Sort and the quality="fast"
Blocks profiles; given the root of another checkout (for example one
unpacked with ``git archive <commit> | tar -x -C build/ab_base``), it
also holds that checkout's emit_plan (at 1080p and at 4K), sort_pairs
and screen_sort bit-equal to this one's on the same inputs and times
them in turns, other, this, this, other, the plan with each side's device
kernels and memsets a call. Both log their kernels' records and not
the result line of a full run. With no arguments it builds the
port's CUDA kernels from godotgaussiansplatting_torch/csrc (one
nvcc per source, all started together), then:

1. device: the card's name and power limit, the kernels' build time, the
   v3 kernel's resident blocks, and each v4 instance's shared memory per
   CTA and resident CTAs (the same at every GT);
2. projection kernel against its plain-torch version on a 1M-splat surface
   scene at 1920x1080 (fast_defaults()): key, bkey and cnt bit-equal,
   pc1/pc2/rgb9 within one unit in the last place per packed field, ix/iy
   within 1e-3 px; and the readable projection's kernel
   (projection_readable) on the same scene with f32 and with bf16
   (P, 16, 3) SH: every ProjectedSplats field bit-equal to its plain
   version (f32 compared as bits), timed beside its bound;
3. the v3 render kernel on the word payload against its plain-torch
   version at 512x512 on 200K splats (scales up to 0.12, so tiles carry
   resident big lanes), heatmap 0 and 1: RGB PSNR >= 50 dB, t_final within
   1e-3, channels 5-7 (blocks processed, nb, nbig) equal, finite output.
   The kernel evaluates the big lanes' log-alphas itself; the plain
   version reads prepass_big_la's maps;
3b. the v3 kernel on the cooked payload against its plain version on the
   same scene, at the shapes of RasterizerConfig(quality="fast") (readable
   projection, screen clustering, tile 16, U=4), heatmap 0 and 1, at the
   same tolerances; and against the word kernel on the same blocks:
   >= 60 dB;
3c. the v4 lockstep kernel (RasterizerConfig(kernel="v4").fast_defaults():
   tile 32, U=2, GT=4) against its plain version (>= 50 dB, t_final within
   1e-3, channels 5-7 equal) and bit-equal (all 8 channels) to the cooked
   v3 kernel on the same inputs, at 512x512 and at 480x480 (225 tiles: the
   last group of four is padded); and the same at 512x512 for
   RasterizerConfig(quality="fast", kernel="v4") (tile 16, U=4, GT=4);
4. full frame: render_frame_fast at 1920x1080 under fast_defaults() on the
   5.8M-splat scene of bench.py over 8 orbit cameras; finite images,
   pairs > 0, every kernel of the path launched by the frame, a centre
   pick that is a splat mean; the median frame and stage times (CUDA
   events, after one warm-up frame) and the peak device memory;
5. the same on the same cloud for RasterizerConfig(kernel="v4")
   .fast_defaults() (projection and v4 kernels), for
   RasterizerConfig(quality="fast") (readable projection, cooked v3) and
   for RasterizerConfig(quality="fast", kernel="v4") (readable projection,
   v4 at tile 16; both read a (P, 16, 3) bf16 view and launch
   projection_readable); then, once every configuration is timed,
   torch.profiler
   over three more frames of each: the device's busy share, its top
   kernels, and its matrix products (gemm) by kernel, with launches and
   device ms per frame. The v4 frame of fast_defaults() must show no gemm:
   no prepass_big_la runs on the card (the quality="fast" frames keep the
   readable projection's small gemms);
6. every kernel on the inputs its 1080p frame gives it (the reset camera):
   the projection held to its plain version as in phase 2, each render
   kernel to its plain version (which composites the tiles in chunks) as
   in phase 3, each timed beside its bound; the v4 kernel at GT 1, 2 and 4
   also held bit-equal to the cooked v3 kernel on the same tile-32 inputs
   and timed beside it and its bound, and so at GT 4 on the tile-16 inputs
   of quality="fast", where it is also held to the plain version's output
   that the cooked v3 kernel was held to; and a host count, from the v4 frame's rows, of the
   chain blocks a group's tiles fetch at the same batch that two or more
   of its GT tiles fetch (what TMA multicast across a cluster could load
   once); and the exact composite kernel against its plain version (which
   composites the tiles in batches) on the 1080p exact frame's inputs at
   the tile capacity phase 8 settled on, at phase 7's gates, both timed,
   with its walk (see phase 7) and the ms per G evaluations and FP32-issue
   share they imply; and the exact frame's Projection and Sort kernels on
   its 1080p inputs: projection_readable (f32 SH, the exact frame's; bf16
   logged), emit_plan (the emission's plan: every EmitPlan field
   bit-equal, timed as graph replays beside the plain plan and
   torch.cumsum of the capped counts, its library_ms, with its device
   kernels a call), emit_exact (the write-once emission into the static 10N
   buffer, on the arguments the frame's emission passed it; positions
   [0, n) compared) and sort_pairs (the radix sort of the emission's n
   live pairs; its pairs a tile logged), each bit-equal to its plain
   version and timed beside its bound, both also at a buffer of half the
   pairs (it drops pairs), sort_pairs also on synthetic buffers (n = 0, a
   full buffer, holes, tie-heavy keys, one tile of most pairs, end_bit 31,
   a one-tile grid),
   sort_pairs also beside torch.sort of the buffer with its gather and
   widening (library_ms, with the stable sort of the buffer's 32-bit keys
   against 64-bit ones, and the same call on the n live pairs alone,
   logged); then
   torch.profiler over three eager Sort stages (profile_sort: kernels and
   aten ops by device ms a stage, with the plain plan and then with
   emit_plan's kernel); both projections at SH degree 0
   (benchmarks/configs.py's first workload) bit-equal to their plain
   versions; and the Blocks stage's kernels (block_frame, words and
   cooked, big_lanes, and screen_pack, screen_sort and big_set): the
   stage run through them and through their plain versions on the 1080p
   frames' projections of fast_defaults() (static bricks, the taken mask
   fused), its v4 (cooked), quality="fast" (screen, cooked) and
   fast_defaults() with the screen clustering (words), and on a
   16,384-splat scene at 384x320 with a big-lane capacity past its
   candidates (4,096) and past its window (20,480: pad entries at splat
   0), every BlockFrame2 and BigSet field and each kernel's output on the
   arguments the stage passed it bit-equal (f32 as bits); big_lanes also
   on rows holding 0 to CW live keys, screen_sort also on the
   quality="fast" rows with the keys cut to a few values and with a third
   of the lanes taken, and on rows of every pass count of its narrowing
   (0 to 4, each span at its boundary, full and short rows), its passes a
   row logged on the 1080p rows; each kernel timed beside its plain
   version and its byte bound, big_lanes also beside torch.sort of the u32
   rows (its
   library_ms), screen_sort beside torch.sort of its rows and the seven
   gathers (its library_ms), and the global window sort with int32 keys
   beside int64 ones; and the Binning stage's kernels (bin_blocks,
   bin_bigs): the stage run through them and through their plain
   versions on the 1080p block frames and big sets of fast_defaults(),
   its v4, quality="fast" (tile 16) and fast_defaults() with the screen
   clustering, then on the shipped frame's as the second slab of two (a
   non-zero tile_row_offset), with its depth keys cut to a few values
   (most of them tied), and at caps where C1, C2 and OB all drop entries
   (the overflows above those of C1 alone), every TileBins2 and TileBigs
   field bit-equal (f32 as bits), OB a multiple of 4 in each
   configuration; each kernel timed as graph replays beside its plain
   version and its byte bound, with its device kernels a call
   (torch.profiler); bin_blocks' own stable ranking of the int32 depth
   keys also alone, bit-equal to torch.sort(stable=True) of them and
   timed beside it (bin_blocks' library_ms);
7. the exact composite kernel (render_exact) against its plain version on
   phase 3's cloud at 512x512, tile 16, heatmap 0 and 1, on a tile-32 case
   and with tile capacities of 1000 and 300 (not multiples of the kernel's
   32-slot piece: the kernel must truncate at 1024 and 300 slots as the
   plain version does): RGB within 1e-4, tile_t0 bit-equal, tile counts
   equal, finite output; beside the slots loaded and the (pixel, slot)
   pairs processed, the evaluations the kernel's walk makes (counted by
   the kernel in one more launch, and held equal to
   render_exact.schedule_evaluations' model of the walk) and its
   instructions per evaluation, by opcode, from cuobjdump -sass of the
   built library (these are logged, not part of the kernels line);
8. the engine end to end at full width: the 5.8M-splat scene through
   Rasterizer(cloud, texture_size=(1920, 1080)) (quality "exact", the
   default) and Rasterizer(..., quality="fast"), 8 orbit cameras each with
   rasterize(sync=True) after one warm-up frame: finite images, rendered
   splats > 0, projection_readable, emit_exact, sort_pairs and
   render_exact launched by every exact frame and projection, block_frame,
   big_lanes, big_set, bin_blocks, bin_bigs and render_v3 by every fast
   frame
   (after the same fast frames with the Blocks stage's plain versions
   patched in, their Blocks timed before its kernels),
   a centre pick that is a splat mean on both, the exact frames'
   num_overflow and final tile_capacity; the median frame, the median
   Projection / Sort / Boundaries / Render (or Blocks / Binning) stage
   times of debug_info() and the peak device memory; the
   fast frames are replays of one capture (ops/fast_pipeline.py
   FastFrameGraph: its capture time and the launches a replay counts are
   logged), the exact frames replays of ops/pipeline.py ExactFrameGraph
   (captured again at each tile-capacity regrowth; the captures are
   logged); then torch.profiler over 3 exact frames, and the PSNR of the
   fast frame against the exact one at the reset camera (printed, not
   gated);
9. the rate probe (sfu_probe.py, the port of benchmarks/vpu_probe.py's
   kern), run right after phase 1 so that every bound can read its rate:
   each body timed at (1024, 512), 64 steps of 16 reps (its main path),
   then held to its plain version at that shape on the TPU probe's input
   and on a noisy one (bit-equal for the FMA, bit-trick and power bodies;
   the documented error of expf, __expf and __logf; 2 bf16 ulp), its
   plain version timed, and its kernel's SASS counted (cuobjdump -sass):
   ms, G elem-ops/s, share of its pipe's peak, instructions per element.
   The highest MUFU instruction rate it reaches, or the spec peak where
   that is higher, is the rate of the bounds' special-function term;
10. the viewer (viewer/server.py): make_server on
   Rasterizer(5.8M scene, 1920x1080, quality="fast") on port 0, driven
   over HTTP as the browser page does (90 ticks of /input with free-look
   fly, an orbit drag, wheel steps and centre picks, a /state change, a
   /frame and a /stats each tick). The launch counters are set to 0 once
   the loop has paused on idle, just before the traffic, and read once it
   has paused again: projection, block_frame, big_lanes, big_set,
   bin_blocks, bin_bigs and render_v3 must have launched once for every frame served. The served frame (through /frame and read_png)
   must equal a direct rasterize + to_uint8 of the viewer's camera (or,
   should the direct render not repeat bit for bit, read >= 50 dB). Then
   a 1M-splat .ply (write_ply of synthetic_arrays, 62 properties) is
   POSTed to /load: the native swizzle and Morton calls must have run, the
   model must stream onto the card, the device memory allocated after it
   must be below that before (the 5.8M model freed), and its frames are
   held as above. Last, render_orbit writes 8 frames of that model at
   1080p to build/chip_smoke/orbit/, each launching both kernels once.
   It logs the served frames a second, a served frame's split (rasterize,
   image() readback, PNG encode), the /frame round trip, the parse,
   native and numpy swizzle and upload times; the render loop's
   last_error must stay None, and ViewerState.close() ends the loop;
11. the sharded paths (parallel/sharded.py): phase 4's scene
   padded with inert slots to a multiple of 4 x 8,192 splats (every shard
   a whole number of superblocks 1, 2 and 4 ways) is written once under
   build/chip_smoke/sharded/, with the single-device frames of the 8
   orbit cameras for three paths: fast_defaults(), exact without the
   boundary quirk (at phase 8's tile capacity) and that exact frame with
   one emission group (no tiers, no giant path, no per-splat cap). Ranks
   are spawned (torch.multiprocessing, spawn): one over NCCL on a (1, 1)
   mesh, then four over gloo sharing the card on (1, 2), (1, 4) and
   (2, 2) meshes (NCCL refuses two ranks on one GPU; gloo goes through
   host memory). Each rank reads only its shard through memory-mapped
   .npy files into its shard_cloud on the card and renders each path over
   the orbit (n_view cameras a frame) after a warm-up frame, the launch
   counters (and the mesh's traffic) set to 0 just before each frame and
   read just after it: projection, block_frame, big_lanes, big_set,
   bin_blocks, bin_bigs and render_v3 once a fast frame,
   projection_readable, sort_pairs and render_exact once and emit_exact
   at least once an exact one (its shard read through a (P, 16, 3) view), on every rank
   of the mesh. Rank 0 holds every view to its
   camera's single-device frame: fast >= 50 dB at world 1 and >= 40 dB
   past it; exact within 2e-3 at world 1 and past it >= 70 dB with max
   |d| <= 0.035 (a slab may emit a wide splat's pairs in another group,
   so equal (tile, depth16) keys composite in another order), at the
   cameras where
   neither side dropped pairs; with one emission group within 2e-3 at
   every camera; num_pairs equal and no exchange overflow. Each rank
   prints its median stage times (CUDA events), the bytes its collectives
   moved in a frame (Mesh.traffic: the exchange's blocks, the big lanes,
   the projected splats, the image) and its peak device memory. A rank that raises
   fails the phase;
12. the fast frame as captured CUDA graphs (FastFrameGraph): on
   phase 4's scene at 1920x1080 over 8 orbit cameras, for fast_defaults(),
   RasterizerConfig(kernel="v4").fast_defaults() and
   RasterizerConfig(quality="fast"), first with the Blocks stage's plain
   versions patched in and then with the Binning stage's (eager and
   graphed frames timed in turns with the eager frame of the kernels: the
   frame as it ran before each stage's kernels; and torch.profiler's busy
   share over 3 eager frames with the plain Binning), then each graphed
   frame
   bit-equal to the
   eager render_frame_fast_staged frame (image, tile_t0, tile lists,
   payloads, tile_nbig, stats), the launches a replay counts equal to an
   eager frame's, and a kept frame's image unchanged by later replays; it
   logs the capture seconds, the eager and graphed frames' medians in
   turns (host clock, CUDA events, stages), the memory each holds between
   frames and at its peak, and torch.profiler's busy share over 3 frames
   of each, and for each configuration torch.profiler over 3
   eager Blocks stages alone, with the plain versions and with the
   kernels (busy ms, kernels and aten ops by device ms a stage), and the
   same over the Binning stage alone for fast_defaults() and
   quality="fast" (profile_stage). Then
   Rasterizer(quality="fast") on the scene: one capture over
   the 8 cameras and a heatmap toggle, one more after a texture_size
   change, frames bit-equal to the eager frames of its view; and a 200,000
   splat .ply streamed in 16 chunks while frames render, whose frame after
   the load is bit-equal to the eager frame of the loaded cloud's own
   fast view;
13. the exact frame as captured CUDA graphs (ExactFrameGraph):
   on phase 4's scene (full precision, f32 SH) at 1920x1080 over the 8
   orbit cameras, boundary quirk on, at the tile capacity phase 8 settled
   on: each graphed frame bit-equal to the eager render_frame_staged frame
   (image, sorted_values, tile_start, tile_end, tile_t0, splat_pos, stats;
   f32 compared as bits), the capture's launches one projection_readable,
   one emit_exact a group, one sort_pairs and one render_exact, a replay's
   launches equal
   to an eager frame's, a kept frame's image unchanged by later replays;
   both timed in turns (host clock, CUDA events, stages), their memory
   between frames and at peak, torch.profiler's busy share over 3 frames
   of each. Then Rasterizer() (exact) at that capacity: one capture over
   the 8 cameras and a heatmap toggle, frames bit-equal to the eager
   frames; then its capacity set below the densest tile: captured there,
   grown and captured once more, the regrown frame bit-equal to the eager
   frame at the new capacity;
14. the five workloads of benchmarks/configs.py:100-113 as the port runs
   them, run last (a bring-up check, not a benchmark): bench.py's scene
   kind in load order at each one's splat count (500K, 500K, 2.5M, phase
   4's 5.8M scene, 10M), RasterizerConfig(width, height, sh_degree) with
   its defaults (quality="fast": readable projection, screen clustering,
   tile 16, cooked v3) over 4 orbit cameras: graphed frames bit-equal to
   the eager frames, every kernel of the path launched by each graphed
   frame, eager and graphed frames timed in turns (stage medians), the
   eager frame's peak memory; config 4's centre pick finite; config 5
   (3840x2160, 240x135 tiles) also with early exit off (timed, PSNR
   against on logged), and screen_pack, screen_sort and big_set
   bit-equal to their plain versions on its Blocks arguments, with the
   radix passes screen_sort's narrowing gives its rows; then the exact
   frame's emission plan (emit_plan bit-equal to its plain version and
   timed), its emission at 3840x2160 on config 5's scene and sort_pairs at
   end_bit 31 on it (a 100M-slot buffer), bit-equal to its plain version
   and timed, with its pairs a tile.

The launch counters are set to 0 just before each full-frame path and read
just after it; the `launches` of a kernel come from the path that runs it
(projection_readable's, emit_plan's, emit_exact's, sort_pairs' and
render_exact's from
phase 8's exact frames, screen_pack's and screen_sort's from phase 5's
quality="fast" frames, sfu_probe's from phase 9's timed runs). The other numbers
of the kernels line come from phase 6, the main paths' inputs, and phase
9 for sfu_probe (the render kernels' chain, __expf / __logf / __expf).
`bound_ms` is the larger of the bytes the kernel must move over 3.35
TB/s and its operations over 67 TFLOP/s (f32) and, for the render
kernels and the probe, the special-function (MUFU)
instructions the function needs over the MUFU rate (`sfu_ms`: the
alpha's exp a (pixel, lane); `bound_ms_f32` keeps the larger of the first
two, `bound_term` names the largest; `formulation_sfu_ms` reads the MUFU
instructions of the render kernels' log-domain blend beside it; the
projections', the emission's and the sort's `sfu_ms` are null), counted from this
run's inputs (see `proj_bound`, `readable_vs_plain`, `emit_vs_plain`,
`sort_bound`,
`block_frame_record`, `big_lanes_record`, `screen_pack_record`,
`screen_sort_record`, `big_set_record`, `bin_record` (bytes only),
`render_bound`
and `exact_bound`: the render kernels read the payload
rows of a tile's live big lanes, its first nbig, and evaluate each
(pixel, live big lane) themselves; the exact kernel reads the id and
splat data of each slot a tile loads, and its operations are counted per
(pixel, slot that pixel processes), with the per-tile lockstep reading
beside it); each record's `bound_counts` says what was counted. Any
failed check raises, and the script exits non-zero. Without a CUDA device
it raises before printing any result. The last three lines are the card's
name and power limit, the kernels' JSON record and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import statistics
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import kernels, native
from godotgaussiansplatting_torch import sfu_probe as sp
from godotgaussiansplatting_torch.ops import bigbin as bb
from godotgaussiansplatting_torch.ops import binning2 as bn
from godotgaussiansplatting_torch.ops import blocks2 as b2
from godotgaussiansplatting_torch.ops import projection as prj_mod
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_torch.ops import render_exact as rx
from godotgaussiansplatting_torch.ops import render_v3 as rv
from godotgaussiansplatting_torch.ops import render_v4 as r4
from godotgaussiansplatting_torch.ops import sort as so
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.binning2 import bin_blocks2
from godotgaussiansplatting_torch.ops.fast_pipeline import (FastFrameGraph,
                                                            _frame_stages)
from godotgaussiansplatting_torch.ops.pipeline import (ExactFrameGraph,
                                                       _exact_stages,
                                                       pack_uniforms,
                                                       render_frame_staged)
from godotgaussiansplatting_torch.ops.blocks2 import (
    _bits16, adaptive_cell_shift, build_block_frame2, build_block_frame2_words,
    u32)
from godotgaussiansplatting_torch.ops.projection import project_splats
from godotgaussiansplatting_torch.config import INVALID_KEY
from godotgaussiansplatting_torch.utils import telemetry
from godotgaussiansplatting_torch.ops.sort import (emit_and_sort,
                                                   tile_boundaries)
from godotgaussiansplatting_torch.models.ply import (PlyFile,
                                                     splat_arrays_from_ply,
                                                     splat_soa_from_ply,
                                                     write_ply)
from godotgaussiansplatting_torch.models.splats import (build_covariance,
                                                        synthetic_arrays)
from godotgaussiansplatting_torch.utils.image import (png_bytes, read_png,
                                                      to_uint8)
from godotgaussiansplatting_torch.parallel import sharded
from godotgaussiansplatting_torch.viewer import server as vserver
from godotgaussiansplatting_torch.viewer.offline import render_orbit

CSRC = "godotgaussiansplatting_torch/csrc/"
TPU = "godotgaussiansplatting_tpu/ops/"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "projection": (CSRC + "projection.cu", TPU + "projection_pallas.py:133"),
    "render_v3": (CSRC + "render_v3.cu", TPU + "render_pallas3.py:178"),
    "render_v3_cooked": (CSRC + "render_v3.cu", TPU + "render_pallas3.py:380"),
    "render_v4": (CSRC + "render_v4.cu", TPU + "render_pallas4.py:66"),
    # XLA there, no Pallas kernel
    "projection_readable": (CSRC + "projection_readable.cu",
                            TPU + "projection.py:57"),
    "emit_plan": (CSRC + "emit_plan.cu", TPU + "sort.py:77"),
    "emit_exact": (CSRC + "emit_exact.cu", TPU + "sort.py:43"),
    "sort_pairs": (CSRC + "sort_pairs.cu", TPU + "sort.py:187"),
    "block_frame": (CSRC + "block_frame.cu", TPU + "blocks2.py:470"),
    "block_frame_cooked": (CSRC + "block_frame.cu", TPU + "blocks2.py:521"),
    "big_lanes": (CSRC + "big_lanes.cu", TPU + "blocks2.py:239"),
    "screen_pack": (CSRC + "screen_pack.cu", TPU + "blocks2.py:313"),
    "screen_sort": (CSRC + "screen_sort.cu", TPU + "blocks2.py:461"),
    "big_set": (CSRC + "big_set.cu", TPU + "blocks2.py:269"),
    "bin_blocks": (CSRC + "bin_blocks.cu", TPU + "binning2.py:39"),
    "bin_bigs": (CSRC + "bin_bigs.cu", TPU + "bigbin.py:55"),
    "render_exact": (CSRC + "render_exact.cu", TPU + "render.py:79"),
    "sfu_probe": (CSRC + "sfu_probe.cu", "benchmarks/vpu_probe.py:34"),
}
BUILD = Path(__file__).resolve().parent / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# The special-function (MUFU) rate of the third bound term: the spec peak
# (sfu_probe.card_peaks: SMs x 16 per clock at the maximum SM clock), or
# the rate phase 9 measured where it is higher. Phase 9 sets it.
SFU = {"per_s": None, "from": None}
# Operations per splat of the fused projection: view and clip transforms,
# fade-in, EWA covariance and eigen radius, tile rect, depth key, degree-3
# SH colour (~200 of them) and the packing, each transcendental counted as
# one operation.
PROJ_OPS_PER_SPLAT = 400
# Operations per splat of the readable projection (csrc/projection_readable
# .cu): the transforms (45), fade-in (12), covariance and eigen radius (70),
# rect and depth key (20), view direction (10) and degree-3 SH colour
# (3 x 45), the conic (3), each transcendental one.
READABLE_OPS_PER_SPLAT = 300
# Per emitted pair of the exact emission: the slot's row and column (a
# divide, a product and a difference), the tile id (two products, two sums)
# and the key (shift, or, xor): integer operations at the f32 rate.
EMIT_OPS_PER_PAIR = 10
# Bytes read per splat by the base emission: valid 1, rect 16, capped
# count 4, offset 8, depth16 4; a dense row reads its id, count and offset
# (16) and its splat's rect and depth16 (20).
EMIT_BYTES_PER_SPLAT = 33
EMIT_BYTES_PER_ROW = 36
# Operations per (pixel, chain lane that passes the tile's coverage gate)
# of the render: the six-term power (10), the clamp, exp and log1p (3), the
# prefix add, the weight's exp and product (3) and the three colour sums
# (6). A lane that fails the gate is dropped when it is decoded.
RENDER_OPS_PER_LANE = 22
# Operations per (pixel, live resident big lane): its log-alpha, evaluated
# in the kernel once (the six-term power (10), the clamp, exp and log1p
# (3)), the prefix and chain-mass adds (2), the weight's two exps and
# difference (3), the three colour sums (6) and the t_final sum (1).
RENDER_OPS_PER_BIG = 25
# Operations per (pixel, processed slot) of the exact composite, from the
# kernel's loop body (built with --fmad=false, so no product and sum fuse):
# the offsets dx, dy (2), the three-term power (9), exp (1), alpha (1), the
# transmittance q * c and c * (1 - alpha) (3), the 1/255 test (1), the
# weight (1) and the three colour products and sums (6).
EXACT_OPS_PER_SLOT = 24
# Special-function instructions (MUFU) that the blend needs: the alpha's
# exp, one per (pixel, chain lane), (pixel, big lane) and exact (pixel,
# slot); T = prod(1 - alpha) and w = alpha T are products. The render
# kernels' log-domain formulation issues more, and its reading stands
# beside the bound as formulation_sfu_ms: per chain lane the alpha's exp,
# log(1 - alpha) and the weight's exp; per big lane its log-alpha (exp and
# log) and the weight's two exps (render_tile.cuh finish_tile).
RENDER_MUFU_PER_LANE = 1
RENDER_MUFU_PER_BIG = 1
EXACT_MUFU_PER_SLOT = 1
RENDER_FORM_MUFU_PER_LANE = 3
RENDER_FORM_MUFU_PER_BIG = 4
# The probe's own chain: per element evaluation, besides its 3 MUFU, the
# min, 1 - a, la * 0.5, + a, x + r and the sum's add.
PROBE_CHAIN_OPS = 6
# Bytes per processed slot: its splat id and the 9 floats of splat data.
EXACT_BYTES_PER_SLOT = 4 + 36
# What each kernel's bound counts (the kernels line carries it).
def _sfu_counts(what: str) -> str:
    return (f"; special functions: {what}, in MUFU instructions over the MUFU "
            "rate (sfu_rate: measured in phase 9, or the spec peak); "
            "bound_ms is the largest of the three terms, bound_ms_f32 the "
            "larger of the first two")


_RENDER_COUNTS = ("bytes: tile rows, the 16 payload rows of each tile's live "
                  "big lanes, each processed block and the output once; "
                  f"operations: {RENDER_OPS_PER_LANE} per (pixel, chain lane "
                  f"past the coverage gate), {RENDER_OPS_PER_BIG} per (pixel,"
                  " live big lane), its log-alpha evaluated in the kernel"
                  + _sfu_counts(f"the alpha's exp, {RENDER_MUFU_PER_LANE} "
                                "per (pixel, chain lane) and "
                                f"{RENDER_MUFU_PER_BIG} per (pixel, live big "
                                "lane)")
                  + "; formulation_sfu_ms: the MUFU instructions of the "
                  f"kernels' log-domain blend, {RENDER_FORM_MUFU_PER_LANE} "
                  f"per (pixel, chain lane) and {RENDER_FORM_MUFU_PER_BIG} "
                  "per (pixel, live big lane), over the same rate")
_BLOCK_COUNTS = ("bytes: the seven int32 stage-1 words a lane read once (28 "
                 "B), the taken mask (1 B a lane) where the static bricks "
                 "pass it, and the payload (32 B a lane of words, 64 B "
                 "cooked), rect, bitmap, depth range and count written "
                 "once; operations: not counted (the extents' pow, log and "
                 "square roots and the rect and bitmap math, some 60 a "
                 "lane, stay far below the bytes term); special functions: "
                 "not counted (sfu_ms null); ms: a CUDA graph of 20 "
                 "launches replayed, over 20")
BOUND_COUNTS = {
    "projection": ("bytes: the splat arrays read and the words written once; "
                   f"operations: {PROJ_OPS_PER_SPLAT} per splat, each "
                   "transcendental one; special functions: not counted "
                   "(sfu_ms null): the divides, square roots, exp, log and "
                   "pow issue a few dozen MUFU instructions a splat, against "
                   "about 170 bytes, so that term stays far below the bytes "
                   "term"),
    "projection_readable": (
        "bytes: the splat arrays (f32 (P, 16, 3) SH: the exact frame's) and "
        "the uniforms read once, every ProjectedSplats field written once "
        f"(77 B a splat); operations: {READABLE_OPS_PER_SPLAT} per splat, "
        "each transcendental one; special functions: not counted (sfu_ms "
        "null): a few divides, square roots and a pow a splat against 313 "
        "bytes"),
    "emit_plan": (
        "the exact emission's plan (each splat's capped count and offset, "
        "each dense group's compacted slots and the totals; a memset, a "
        "persistent scan of 4096-splat tiles in ticket order, two CTAs an "
        "SM of eight worker warps, a sums warp (tickets, TMA bulk copies "
        "of the inputs, the tile's sums) and a scan warp (a decoupled "
        "look-back over self-validating 16-byte record words), the vector "
        "narrowed to the ladder's groups, outputs sent by bulk stores; and "
        "a finish kernel): bytes: each "
        "splat's valid flag and num_tiles read once (5 B) and its capped "
        "count and offset written once (12 B), each group slot's id, count "
        "and offset (16 B) and the totals written once; operations: not "
        "counted (a few integer operations a splat); special functions: "
        "none (sfu_ms null); ms: a CUDA graph of 20 calls replayed, over "
        "20; plain_ms: emit_plan_reference eager (plain_graphed_ms: the "
        "same as graph replays, its device time); library_ms: "
        "torch.cumsum of the (P,) capped counts as int64, one of the plan's "
        "outputs, as graph replays; launches_a_call: the device kernels "
        "and memsets torch.profiler saw over 3 calls, a call"),
    "emit_exact": (
        "the write-once emission into the static sort buffer (the base and "
        "dense launches, no fill): bytes: the n = min(num_pairs, k_max) "
        "positions written once (8 B a position: key and value), "
        f"{EMIT_BYTES_PER_SPLAT} B read per splat and {EMIT_BYTES_PER_ROW}"
        " per dense row; operations: "
        f"{EMIT_OPS_PER_PAIR} integer operations per emitted pair at the "
        "f32 rate; special functions: none (sfu_ms null); ms and plain_ms "
        "time the kernels or their plain versions on the frame's recorded "
        "arguments; bound_ms_k_max_fill keeps the count of the emission "
        "that filled the buffer first, all k_max slots written"),
    "sort_pairs": (
        "the stable key-value radix sort of the n live pairs: bytes: the n "
        "int32 keys and values read once (8 B a pair) and the k_max output "
        "slots written once (int64 key and int32 value, 12 B); operations: "
        "not counted (a few integer operations a key and pass, far below "
        "the bytes term); special functions: none (sfu_ms null); ms: the "
        "sort on a copy of the emission's buffers (it overwrites them), "
        "less the copy, a CUDA graph of 5 replayed; plain_ms: "
        "sort_pairs_reference; library_ms: torch.sort(stable=True) of the "
        "int32 buffer with its tail filled, the values' gather and the "
        "keys' widening (the Sort stage before this kernel: a graph-safe "
        "torch.sort cannot be sized by the device-side n, so it sorts all "
        "k_max slots); library_ms_live: the same on the n live pairs alone, "
        "n read on the host (eager only); pass_bytes: what the histogram "
        "and the passes move"),
    "block_frame": _BLOCK_COUNTS,
    "block_frame_cooked": _BLOCK_COUNTS,
    "big_lanes": (
        "bytes: the (R, CW) int32 chunk keys read once and the (R, KC) "
        "window's pos_w and gk (int32) written once; operations: not "
        "counted (a row's sort runs in shared memory; its compares, about "
        "CW log2 CW a row, stay far below the bytes term); special "
        "functions: none (sfu_ms null); ms: a CUDA graph of 20 launches "
        "replayed, over 20; library_ms: torch.sort(u32(bkey), "
        "dim=1).values[:, :KC] on the same keys"),
    "screen_pack": (
        "bytes: each splat's valid flag, depth16, image position, conic and "
        "colour (41 B) read once and its seven int32 words (chunk key, "
        "stage-1 key, ix, iy, pc1, pc2, rgb9e5: 28 B) and the big count "
        "written once; operations: not counted (the extents' pow, log and "
        "square roots and the packing, some 80 a splat, far below the bytes "
        "term); special functions: not counted (sfu_ms null); ms: a CUDA "
        "graph of 20 launches replayed, over 20; plain_ms: "
        "screen_pack_reference"),
    "screen_sort": (
        "bytes: each element's key, taken byte and five payload words (25 "
        "B) read once and its seven stage-1 words (28 B) written once; "
        "operations: not counted (at most four radix passes in shared "
        "memory, as many as the row's narrowed width needs, a few dozen "
        "integer operations an element and pass); special functions: "
        "none (sfu_ms null); ms: a CUDA graph of 20 launches replayed, over "
        "20; plain_ms: screen_sort_reference; library_ms: torch.sort("
        "stable=True) of the (SB, sb_size) u32 keys along the rows and the "
        "seven torch.gather of the rows, the stage's sort before this "
        "kernel"),
    "big_set": (
        "bytes: each lane's index and flag (9 B) and its six packed words "
        "(24 B) read once, its cooked row (64 B), rect (16 B) and depth16 "
        "(4 B) written once; operations: not counted (some 80 a lane); "
        "special functions: not counted (sfu_ms null); ms: a CUDA graph of "
        "20 launches replayed, over 20; plain_ms: big_set_reference; "
        "empty_ms: an empty kernel of the same grid, replayed the same way "
        "(the launch's floor); sector_bound_ms: the 32-byte sectors the "
        "lanes' scattered word reads move (distinct sectors of each word "
        "array), with the coalesced reads and writes, over the memory "
        "rate"),
    "bin_blocks": (
        "bytes: each block's rect and depth range (24 B) read once, the "
        "bitmap and count (8 B) of each block in a tile's list, and the "
        "(T, C2) block ids and packed depth ranges, the (T,) counts and "
        "candidate sums and the overflow written once; operations: not "
        "counted (a few dozen integer "
        "operations a (supertile, block) and a (tile, candidate), far below "
        "the bytes term); special functions: none (sfu_ms null); ms: the "
        "wrapper (its own stable ranking of the B int32 depth keys "
        "included, no library call), a CUDA graph of 20 calls replayed, "
        "over 20; plain_ms: bin_blocks2_reference; library_ms: "
        "torch.sort(stable=True) of the same int32 keys alone, the pre-sort "
        "the ranking replaced (rank_ms: the ranking alone); launches_a_call:"
        " the distinct device kernels torch.profiler saw over 3 calls, each "
        "launched once a call"),
    "bin_bigs": (
        "bytes: the valid mask (N B), each valid lane's rect (16 B) and "
        "each table row kept in a tile's list (64 B, distinct rows) read "
        "once, and the (T, 16, OB) f32 payload, the (T, 128) bucket "
        "prefix, the (T,) counts and the overflow written once; "
        "operations: not counted (integer tests and a histogram, far "
        "below the bytes term); special functions: none (sfu_ms null); "
        "ms: a CUDA graph of 20 calls replayed, over 20; plain_ms: "
        "bin_bigs_reference; launches_a_call: the distinct device kernels "
        "torch.profiler saw over 3 calls, each launched once a call"),
    "render_v3": _RENDER_COUNTS,
    "render_v3_cooked": _RENDER_COUNTS,
    "render_v4": _RENDER_COUNTS,
    "render_exact": (f"bytes: {EXACT_BYTES_PER_SLOT} per slot a tile loads "
                     "(its id and splat data; the most slots any of the "
                     "tile's target pixels processes), the tile ranges and "
                     f"the image once; operations: {EXACT_OPS_PER_SLOT} per "
                     "(target pixel, slot that pixel processes), from the "
                     "plain version's per-pixel counts; lockstep_bound_ms "
                     "charges every pixel of a tile the tile's most, which "
                     "is what the kernel evaluates"
                     + _sfu_counts(f"the alpha's exp, {EXACT_MUFU_PER_SLOT}"
                                   " per (pixel, slot)")),
    "sfu_probe": ("the kernel of the render kernels' chain (__expf, __logf, "
                  "__expf): bytes: the (1024, 512) f32 input read and the "
                  f"output written once; operations: {PROBE_CHAIN_OPS} per "
                  "element evaluation" + _sfu_counts(f"{sp.CHAIN.units} per element")
                  + "; ms, plain_ms and max_abs_err are that body's, the "
                  "other bodies are in phase 9's lines"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_graphed_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls captured in
    one CUDA graph and replayed, after a warm-up call: no host launch cost
    between the calls, which a kernel of a few tens of microseconds would
    otherwise show. Its outputs come from the graph's pool."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    return a.elapsed_time(b) / reps


def time_once(fn):
    """(result, ms) of one call."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def time_host(fn):
    """(result, ms) of one call on the host's clock."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, n_ops: float, n_mufu: float | None,
          form_mufu: float | None = None) -> dict:
    """The least time the card could take: the largest of bytes over the
    memory rate, operations over the f32 rate and the special-function
    instructions the function needs, ``n_mufu``, over SFU["per_s"]
    (``sfu_ms``; ``bound_ms_f32`` keeps the larger of the first two). An
    ``n_mufu`` of None leaves that term out (``sfu_ms`` None).
    ``formulation_sfu_ms`` reads ``form_mufu``, the instructions the
    kernel's own formulation issues (``n_mufu`` where not given), over the
    same rate; it is not part of the bound."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / F32_OPS_PER_S * 1e3
    ts = None if n_mufu is None else n_mufu / SFU["per_s"] * 1e3
    tf = (ts if form_mufu is None
          else form_mufu / SFU["per_s"] * 1e3)
    term = max((tb, "bytes"), (to, "f32"), (ts or 0.0, "sfu"))[1]
    return {"bound_ms": max(tb, to, ts or 0.0),
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_ms_f32": max(tb, to),
            "sfu_ms": ts, "formulation_sfu_ms": tf,
            "sfu_rate": dict(SFU) if ts is not None else None}


def bound_text(bnd: dict) -> str:
    """'bound X ms (by, term; f32-only Y ms, SFU Z ms, formulation's SFU
    W ms)', the SFU readings where counted."""
    t = (f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
         f"{bnd['bound_term']}; f32-only {bnd['bound_ms_f32']:.4f} ms")
    if bnd["sfu_ms"] is not None:
        t += f", SFU {bnd['sfu_ms']:.4f} ms"
    if bnd["formulation_sfu_ms"] not in (None, bnd["sfu_ms"]):
        t += f", formulation's SFU {bnd['formulation_sfu_ms']:.4f} ms"
    return t + ")"


def record(name: str, err: float, ms: float, plain_ms: float,
           bnd: dict) -> dict:
    src, tpu = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": tpu,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "bound_counts": BOUND_COUNTS[name]}


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a[:3].clamp(0, 1) - b[:3].clamp(0, 1)) ** 2).mean())
    return 10 * np.log10(1.0 / max(mse, 1e-20))


def phase_device() -> str:
    card = kernels.card_name_and_power()
    t0 = time.perf_counter()
    kernels.build(*kernels.SIGNATURES)
    wall = time.perf_counter() - t0
    for name in kernels.SIGNATURES:
        kernels.library(name)
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{wall:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in kernels.build_seconds.items()})})")
    occ = {f"v3 tile {t} U={u} {'cooked' if c else 'words'} OBIG 128":
           rv.resident_blocks("render_v3", t, u, c, 128)
           for t, u in ((32, 2), (16, 4)) for c in (0, 1)}
    log(f"[1 device] render_v3 resident blocks on the card: {json.dumps(occ)}")
    lib = kernels.library("render_v4")
    shapes = [{"tile": tile, "U": U,
               "smem_per_cta": lib.gs_render_v4_smem_bytes(U, 128),
               "resident_ctas": rv.resident_blocks("render_v4", tile, U, 128)}
              for tile, U in ((32, 2), (16, 4), (32, 4), (16, 2))]
    log(f"[1 device] render_v4 at OBIG 128, one tile a CTA, any GT: "
        f"{json.dumps(shapes)}")
    return card


def _f16_ulps(a, b):
    """Max difference of the two f16 halves of int32 words, in ulps."""
    worst = 0
    for sh in (0, 16):
        ha = _bits16((u32(a) >> sh) & 0xFFFF).to(torch.int64)
        hb = _bits16((u32(b) >> sh) & 0xFFFF).to(torch.int64)
        worst = max(worst, int((ha - hb).abs().max()))
    return worst


def proj_bound(args, words) -> dict:
    """Each input splat array read once, each output word written once;
    PROJ_OPS_PER_SPLAT operations per splat slot."""
    means, cov3d, opacity, sh, upload_time, vec = args[:6]
    P = means.shape[0]
    return bound(nbytes(means, cov3d, opacity, sh, upload_time, vec)
                 + nbytes(*words), P * PROJ_OPS_PER_SPLAT, None)


def projection_vs_plain(tag: str, cloud, cfg, plain_reps: int,
                        exact: bool = False):
    """The projection kernel against its plain version on one camera:
    (max |d ix,iy|, kernel ms, plain ms, bound). ``exact``: every word
    bit-equal."""
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device)
    vec = pk.frame_uniform_vector(uni.view, uni.proj, uni.camera_pos,
                                  uni.model_scale, uni.time, cfg)
    gx, gy = cfg.tile_dims
    cell = adaptive_cell_shift(cloud.num_splats, gx, gy)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, vec, cfg, cell)
    wk = pk._project_words_cuda(*args)
    wr = pk.project_words_reference(*args)
    torch.cuda.synchronize()
    bad = {f: int((getattr(wk, f) != getattr(wr, f)).sum())
           for f in pk.ProjWords._fields}
    valid = wr.key.reshape(-1) != -1
    ix_err = max(float((wk.ix.view(torch.float32) - wr.ix.view(torch.float32))
                       .reshape(-1)[valid].abs().max()),
                 float((wk.iy.view(torch.float32) - wr.iy.view(torch.float32))
                       .reshape(-1)[valid].abs().max()))
    pc_ulps = max(_f16_ulps(wk.pc1.reshape(-1)[valid], wr.pc1.reshape(-1)[valid]),
                  _f16_ulps(wk.pc2.reshape(-1)[valid], wr.pc2.reshape(-1)[valid]))
    ka, kb = u32(wk.rgb9.reshape(-1)[valid]), u32(wr.rgb9.reshape(-1)[valid])
    rgb_ok = bool(((ka >> 27) == (kb >> 27)).all()) and all(
        int((((ka >> s) & 0x1FF) - ((kb >> s) & 0x1FF)).abs().max()) <= 1
        for s in (0, 9, 18))
    ms = time_ms(lambda: pk._project_words_cuda(*args), 20)
    plain_ms = time_ms(lambda: pk.project_words_reference(*args), plain_reps)
    bnd = proj_bound(args, wk)
    w, h = cfg.target_size
    log(f"[{tag}] {cloud.num_splats} splats {w}x{h}: valid "
        f"{int(valid.sum())}, mismatching words {json.dumps(bad)}, "
        f"max |d ix,iy| {ix_err:.3g} px, f16 max ulps {pc_ulps}, rgb9e5 "
        f"within 1 ulp {rgb_ok}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" {bound_text(bnd)}")
    for f in ("key", "bkey", "cnt"):
        check(bad[f] == 0, f"{tag}: {f} differs on {bad[f]} entries")
    check(ix_err <= 1e-3, f"{tag}: ix/iy error {ix_err}")
    check(pc_ulps <= 1, f"{tag}: f16 halves {pc_ulps} ulps apart")
    check(rgb_ok, f"{tag}: rgb9e5 fields more than 1 ulp apart")
    check(not exact or not any(bad.values()),
          f"{tag}: words not bit-equal: {bad}")
    return ix_err, ms, plain_ms, bnd


def sh_rows(cloud):
    """``cloud`` with (P, 16, 3) SH, the layout the readable projection's
    kernel takes: a planar fast view laid out again, any other cloud as it
    is."""
    if cloud.sh.ndim == 2:
        return gt.fast_cloud_view(cloud, planar_sh=False)
    return cloud


def readable_vs_plain(tag: str, cloud, cfg, plain_reps: int):
    """The readable projection's kernel against its plain version on one
    camera: every field bit-equal (f32 as bits). Returns (max |d| over the
    f32 fields, kernel ms, plain ms, bound)."""
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uni.view, uni.proj, uni.camera_pos,
            uni.model_scale, uni.time, cfg)
    k = prj_mod._project_splats_cuda(*args)
    r = prj_mod.project_splats_reference(*args)
    torch.cuda.synchronize()

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    bad = {f: int((bits(getattr(k, f)) != bits(getattr(r, f))).sum())
           for f in prj_mod.ProjectedSplats._fields}
    err = max(float((getattr(k, f) - getattr(r, f)).abs().max())
              for f in ("image_pos", "conic", "color", "radius", "pos"))
    ms = time_ms(lambda: prj_mod._project_splats_cuda(*args), 20)
    plain_ms = time_ms(lambda: prj_mod.project_splats_reference(*args),
                       plain_reps)
    P = cloud.means.shape[0]
    bnd = bound(nbytes(*args[:5]) + 37 * 4 + nbytes(*k),
                P * READABLE_OPS_PER_SPLAT, None)
    w, h = cfg.target_size
    log(f"[{tag}] {P} splats, {cloud.sh.dtype} (P, 16, 3) SH, {w}x{h}: "
        f"valid {int(k.valid.sum())}, entries not bit-equal to the plain "
        f"version {json.dumps(bad)}, max |d| {err:.3g}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {bound_text(bnd)}")
    check(not any(bad.values()), f"{tag}: not bit-equal: {bad}")
    return err, ms, plain_ms, bnd


def emit_vs_plain(tag: str, prj, cfg, capacity: int | None = None,
                  plain_reps: int = 2):
    """The emission kernels against their plain versions on a frame's
    projected splats: the static buffer's written positions [0, n), n =
    min(num_pairs, k_max), num_pairs and num_overflow bit-equal. Timed on
    the arguments the frame's emission passed them (recorded), on buffers
    made once. Returns (0.0, kernel ms, plain ms, bound, num_pairs, the
    kernels' (keys, values, num_pairs) buffers)."""
    calls = []

    def recorder(kind, fn):
        def call(*a):
            calls.append((kind, a[2:]))
            fn(*a)
        return call

    inputs = (prj.valid, prj.rect, prj.num_tiles, prj.depth16)
    kk, kv, kn, ko = so.emit_pairs(*inputs, cfg, capacity,
                                   base=recorder("base", so.emit_base),
                                   dense=recorder("dense", so.emit_dense))
    with plan_dispatch(plain=True):
        rk, rv_, rn, ro = so.emit_pairs(*inputs, cfg, capacity,
                                        base=so.emit_base_reference,
                                        dense=so.emit_dense_reference)
    torch.cuda.synchronize()
    k_max = kk.shape[0] - 1
    n = min(int(kn), k_max)
    bad = {"keys": int((kk[:n] != rk[:n]).sum()),
           "values": int((kv[:n] != rv_[:n]).sum())}
    counts = [int(kn), int(rn), int(ko), int(ro)]
    del rk, rv_
    live = int((kk[:n] != INVALID_KEY - so.SIGN).sum())
    fns = {True: {"base": so.emit_base, "dense": so.emit_dense},
           False: {"base": so.emit_base_reference,
                   "dense": so.emit_dense_reference}}
    keys, vals = torch.empty_like(kk), torch.empty_like(kv)

    def run(kernel: bool):
        for kind, a in calls:
            fns[kernel][kind](keys, vals, *a)

    ms = time_ms(lambda: run(True), 10)
    plain_ms = time_ms(lambda: run(False), plain_reps)
    del keys, vals
    rows = sum(a[0].shape[0] for kind, a in calls if kind == "dense")
    P = prj.valid.shape[0]
    reads = P * EMIT_BYTES_PER_SPLAT + rows * EMIT_BYTES_PER_ROW
    bnd = bound(n * 8 + reads, live * EMIT_OPS_PER_PAIR, None)
    bnd["bound_ms_k_max_fill"] = bound(k_max * 8 + reads,
                                       live * EMIT_OPS_PER_PAIR,
                                       None)["bound_ms"]
    groups = [a[0].shape[0] if kind == "dense" else P for kind, a in calls]
    log(f"[{tag}] {P} splats, k_max {k_max}: {counts[0]} pairs emitted "
        f"({live} live, {n - live} holes in the buffer's {n} written "
        f"positions), overflow {counts[2]}, groups (rows) {groups}; "
        f"entries of [0, n) not bit-equal to the plain version "
        f"{json.dumps(bad)}, counts kernel / plain {counts}; emission: "
        f"kernel {ms:.4f} ms ({len(calls)} launches), plain {plain_ms:.4f} "
        f"ms, {bound_text(bnd)}; the old count (all k_max slots written) "
        f"{bnd['bound_ms_k_max_fill']:.4f} ms")
    check(not any(bad.values()) and counts[0] == counts[1]
          and counts[2] == counts[3], f"{tag}: differs from the plain "
          f"version: {bad}, {counts}")
    return 0.0, ms, plain_ms, bnd, counts[0], (kk, kv, kn)


def plan_dispatch(plain: bool = False, calls: list | None = None):
    """The plan's kernel wrapper (``sort._emit_plan_cuda``) replaced inside
    a block (``_dispatch``): with ``plain``, the Sort stage's plan as it ran
    before its kernel (``emit_plan_reference``)."""
    return _dispatch(((so, "_emit_plan_cuda", so.emit_plan_reference,
                       "plan"),), plain, calls)


def plan_differ(a, b) -> dict:
    """{field: entries that differ} of two EmitPlans (a dtype that
    differs counts every entry)."""
    pairs = [(f, getattr(a, f), getattr(b, f)) for f in
             ("nt_capped", "offsets", "base_total", "total", "overflow")]
    for g, (ga, gb) in enumerate(zip(a.groups, b.groups)):
        pairs += [(f"group{g}.{f}", getattr(ga, f), getattr(gb, f))
                  for f in ("idx", "nt_c", "off_c", "pos0")]
    bad = {f: int(x.numel()) if x.dtype != y.dtype or x.shape != y.shape
           else int((x != y).sum()) for f, x, y in pairs}
    if len(a.groups) != len(b.groups) or any(
            ga.width != gb.width for ga, gb in zip(a.groups, b.groups)):
        bad["groups"] = 1
    return {f: n for f, n in bad.items() if n}


def plan_vs_plain(tag: str, prj, cfg, full: bool = True) -> dict | None:
    """The plan's kernel against its plain version on a frame's projected
    splats: every EmitPlan field bit-equal, one count a call. With
    ``full``, timed as graph replays beside the plain version (eager and
    graphed), torch.cumsum of the capped counts (library_ms) and its byte
    bound, with its device kernels a call; returns the record."""
    v, nt = prj.valid, prj.num_tiles
    kernels.reset_launch_counts()
    k = so.emit_plan(v, nt, cfg)
    count = kernels.launch_counts()["emit_plan"]
    r = so.emit_plan_reference(v, nt, cfg)
    torch.cuda.synchronize()
    bad = plan_differ(k, r)
    P = v.shape[0]
    live = [int(g.nt_c.count_nonzero()) for g in k.groups]
    log(f"[{tag}] {P} splats, groups' live slots {live} of "
        f"{[g.idx.shape[0] for g in k.groups]}, base total "
        f"{int(k.base_total)}, total {int(k.total)}, overflow "
        f"{int(k.overflow)}: fields not bit-equal to emit_plan_reference "
        f"{json.dumps(bad)}, launches counted {count}")
    check(not bad and count == 1, f"{tag}: differs from the plain version "
          f"{bad} or counted {count} launches")
    if not full:
        return None
    ms = time_graphed_ms(lambda: so._emit_plan_cuda(v, nt, cfg), 20)
    plain_ms = time_ms(lambda: so.emit_plan_reference(v, nt, cfg), 3)
    plain_graphed = time_graphed_ms(lambda: so.emit_plan_reference(v, nt,
                                                                   cfg), 3)
    lib_ms = time_graphed_ms(lambda: torch.cumsum(k.nt_capped, 0,
                                                  dtype=torch.int64), 20)
    split = kernel_split(lambda: so._emit_plan_cuda(v, nt, cfg))
    n_bytes = nbytes(v, nt, k.nt_capped, k.offsets, k.total) + sum(
        nbytes(g.idx, g.nt_c, g.off_c, g.pos0) for g in k.groups) + nbytes(
        k.base_total, k.overflow)
    bnd = bound(n_bytes, 0, None)
    log(f"[{tag}] kernel {ms:.4f} ms (graph replays of 20 calls; device "
        f"kernels and memsets a call {json.dumps(split)}), plain "
        f"{plain_ms:.4f} ms eager, {plain_graphed:.4f} ms as graph replays, "
        f"library (torch.cumsum of the capped counts, int64) {lib_ms:.4f} "
        f"ms, {n_bytes / 1e6:.1f} MB moved, {bound_text(bnd)}")
    rec = record("emit_plan", 0.0, ms, plain_ms, bnd)
    rec.update(library_ms=lib_ms, plain_graphed_ms=plain_graphed,
               launches_a_call=sum(n for n, _ in split.values()))
    return rec


def sort_bound(n: int, k_max: int) -> dict:
    """The sort's work (BOUND_COUNTS["sort_pairs"]): the n live pairs read
    once, the k_max output slots written once."""
    return bound(n * 8 + k_max * 12, 0, None)


def sort_pass_bytes(n: int, k_max: int, end_bit: int) -> int:
    """What the radix sort moves: the histogram's key read and tail write,
    and each pass's pair read and write (an int64 key in the last)."""
    passes = kernels.library("sort_pairs").gs_sort_pairs_passes(end_bit)
    return n * 4 + (k_max - n) * 12 + n * 16 * (passes - 1) + n * 20


def pairs_a_tile(keys: torch.Tensor, n: int, end_bit: int) -> dict:
    """The distribution of the n live pairs of an emission's int32 key
    buffer over the tiles (the bits [16, end_bit) of the masked key): what
    a sort by tile, then by depth in each tile's run, would meet; "over_N":
    the tiles of more than N pairs, more than one CTA's shared memory
    sorts at once (8192 at 12 B a pair in 112 KB)."""
    mask = (1 << end_bit) - 1
    tile = ((keys[:n].to(torch.int64) + so.SIGN) & mask) >> 16
    cnt = torch.bincount(tile, minlength=1 << max(0, end_bit - 16))
    full = cnt[cnt > 0].to(torch.float64)
    q = torch.quantile(full, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                          device=full.device)).tolist() \
        if full.numel() else [0.0, 0.0]
    return {"pairs": n, "tiles": cnt.numel(),
            "nonempty": int(full.numel()),
            "mean_nonempty": round(float(full.mean()), 1)
            if full.numel() else 0.0,
            "p50": q[0], "p99": q[1], "max": int(cnt.max()),
            "over_4096": int((cnt > 4096).sum()),
            "pairs_over_4096": int(cnt[cnt > 4096].sum()),
            "over_8192": int((cnt > 8192).sum()),
            "pairs_over_8192": int(cnt[cnt > 8192].sum())}


def synthetic_pairs(kind: str, T: int, k_max: int, total: int, seed: int):
    """An emission-shaped (k_max + 1,) int32 key and value buffer on the
    card, keys ``tile << 16 | depth16`` over T tiles: "random", "holes" (a
    tenth INVALID_KEY), "ties" (four tiles, four depths) or "oversize"
    (six tenths of the pairs on one tile, many of one depth)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    size = k_max + 1
    tile = torch.randint(0, T, (size,), generator=g, device="cuda")
    depth = torch.randint(0, 1 << 16, (size,), generator=g, device="cuda")
    if kind == "ties":
        tile = tile % min(T, 4)
        depth = torch.tensor([3, 4, 40000, 0xFFFF], device="cuda")[depth % 4]
    if kind == "oversize":
        r = torch.rand(size, generator=g, device="cuda")
        tile = torch.where(r < 0.6, T // 2, tile)
        depth = torch.where(r < 0.2, 1234, depth)
    u = (tile << 16) | depth
    if kind == "holes":
        u = torch.where(torch.rand(size, generator=g, device="cuda") < 0.1,
                        INVALID_KEY, u)
    vals = torch.randint(-2**31, 2**31, (size,), generator=g, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    return ((u - so.SIGN).to(torch.int32), vals,
            torch.tensor(total, dtype=torch.int64, device="cuda"))


# (tag, kind, tiles, k_max, total): n = 0, a full buffer, holes, tie-heavy
# keys, one tile holding most pairs, end_bit 31, a one-tile grid
SORT_EDGES = (("n = 0", "random", 8160, 100_000, 0),
              ("n = k_max", "random", 8160, 3_000_000, 3_000_007),
              ("holes", "holes", 8160, 2_000_000, 1_900_001),
              ("tie-heavy keys", "ties", 8160, 2_000_000, 2_000_000),
              ("one tile of 1.2M pairs", "oversize", 8160, 2_000_000,
               2_000_000),
              ("end_bit 31", "random", 32400, 4_000_000, 3_999_999),
              ("one tile", "random", 1, 200_000, 150_000))


def sort_edge_cases() -> None:
    """sort_pairs bit-equal to its plain version on SORT_EDGES' synthetic
    buffers, with each one's pairs a tile."""
    for i, (tag, kind, T, k_max, total) in enumerate(SORT_EDGES):
        keys, vals, tot = synthetic_pairs(kind, T, k_max, total, 17 + i)
        end_bit = so.sort_key_bits(T)
        ref = so.sort_pairs_reference(keys, vals, tot, k_max, end_bit)
        out = so.sort_pairs(keys.clone(), vals.clone(), tot, k_max, end_bit)
        torch.cuda.synchronize()
        bad = {"keys": int((out[0] != ref[0]).sum()),
               "values": int((out[1] != ref[1]).sum())}
        dist = pairs_a_tile(keys, min(total, k_max), end_bit)
        check(not any(bad.values()), f"6 sort_pairs {tag}: not bit-equal "
              f"to the plain version {bad}")
        if kind == "oversize":
            check(dist["over_8192"] == 1, f"6 sort_pairs {tag}: {dist}")
        log(f"[6 sort_pairs edge] {tag}: k_max {k_max}, end_bit {end_bit}: "
            f"bit-equal to sort_pairs_reference; pairs a tile "
            f"{json.dumps(dist)}")


def sort_vs_plain(tag: str, emitted, cfg, full: bool = True) -> dict:
    """The radix sort against its plain version on an emission's buffers
    (``emitted``: keys, values, num_pairs): both SortedPairs fields
    bit-equal. With ``full``, also timed (on a copy of the buffers, less
    the copy), beside the plain version, the library's torch.sort + gather
    + widening on the same buffer with its tail filled (and on its n live
    pairs alone), and its byte bound. Returns the record's numbers."""
    keys, vals, total = emitted
    k_max = keys.shape[0] - 1
    n = min(int(total), k_max)
    end_bit = so.sort_key_bits(cfg.num_tiles)
    ref = so.sort_pairs_reference(keys, vals, total, k_max, end_bit)
    out = so.sort_pairs(keys.clone(), vals.clone(), total, k_max, end_bit)
    torch.cuda.synchronize()
    bad = {"keys": int((out[0] != ref[0]).sum()),
           "values": int((out[1] != ref[1]).sum())}
    log(f"[{tag}] n {n} of k_max {k_max}, end_bit {end_bit}: slots not "
        f"bit-equal to sort_pairs_reference {json.dumps(bad)}")
    check(not any(bad.values()), f"{tag}: differs from the plain version")
    del ref, out
    if not full:
        return {}
    k, v = keys.clone(), vals.clone()

    def copy():
        k[:n].copy_(keys[:n])
        v[:n].copy_(vals[:n])

    def copy_and_sort():
        copy()
        so.sort_pairs(k, v, total, k_max, end_bit)

    ms = min(time_graphed_ms(copy_and_sort, 5) - time_graphed_ms(copy, 5)
             for _ in range(2))
    plain_ms = time_ms(lambda: so.sort_pairs_reference(keys, vals, total,
                                                       k_max, end_bit), 3)
    filled = torch.where(torch.arange(k_max, device=keys.device) < n,
                         keys[:k_max], INVALID_KEY - so.SIGN)

    def library(m: int):
        s, order = torch.sort(filled[:m], stable=True)
        return vals[:m].gather(0, order), s.to(torch.int64).add_(so.SIGN)

    lib_ms = time_ms(lambda: library(k_max), 5)
    lib_live_ms = time_ms(lambda: library(n), 5)
    sort_only = time_ms(lambda: torch.sort(filled, stable=True), 5)
    wide = filled.to(torch.int64) + so.SIGN
    sort64 = time_ms(lambda: torch.sort(wide, stable=True), 5)
    del filled, wide, k, v
    bnd = sort_bound(n, k_max)
    moved = sort_pass_bytes(n, k_max, end_bit)
    log(f"[{tag}] radix sort {ms:.4f} ms; the histogram and passes move "
        f"{moved} B ({moved / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory "
        f"rate); plain {plain_ms:.4f} ms; library (torch.sort of the int32 "
        f"buffer's k_max slots, gather and widening) {lib_ms:.4f} ms, of "
        f"it torch.sort alone {sort_only:.4f} ms (int64 keys {sort64:.4f} "
        f"ms); the same on the n live pairs alone (n read on the host) "
        f"{lib_live_ms:.4f} ms; {bound_text(bnd)}")
    return {"ms": ms, "plain_ms": plain_ms, "bnd": bnd,
            "library_ms": lib_ms, "library_ms_live": lib_live_ms,
            "pass_bytes": moved}


def phase_projection(n: int, width: int, height: int) -> dict:
    """Phase 2: the fused projection kernel and the readable projection's
    (f32 and bf16 SH) against their plain versions. Returns the largest
    error of each."""
    full = gt.mortonize(gt.synthetic_scene(n, seed=1, surfaces=True))
    base = gt.RasterizerConfig(width=width, height=height)
    worst = {"projection": projection_vs_plain(
        "2 projection", gt.fast_cloud_view(full), base.fast_defaults(), 3)[0]}
    worst["projection_readable"] = max(
        readable_vs_plain(f"2 projection_readable {tag}", cloud, base, 3)[0]
        for tag, cloud in (("f32", full), ("bf16", gt.fast_cloud_view(
            full, planar_sh=False))))
    return worst


def _frame_inputs(cloud, cfg, heatmap: float, words: bool):
    """The render kernels' inputs for one camera: through the fused
    projection (cfg.projection_kernel) or the readable projection and
    screen clustering, on the word or the cooked payload."""
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    dev = cloud.device
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=dev,
                           heatmap=heatmap)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uni.view, uni.proj, uni.camera_pos,
            uni.model_scale, uni.time, cfg)
    if cfg.projection_kernel:
        bf, bigs = build_block_frame2_words(
            pk.project_words(*args, num_splats=cloud.num_splats), cfg,
            words_payload=words)
    else:
        bf, bigs = build_block_frame2(project_splats(*args), cfg,
                                      num_splats=cloud.num_splats,
                                      words_payload=words)
    tbig = bin_bigs(bigs, cfg, obig=cfg.big_tile_capacity)
    rows, bigla, U, max_batches = rv.tile_inputs(
        bin_blocks2(bf, cfg), tbig, uni.heatmap_factor, cfg)
    return (rows, bf.payload, tbig.bigpay, bigla, cfg, U, max_batches)


def _processed_ids(rows, processed):
    """(tile, block id) of every block a render call processed: the first
    ``processed`` (output channel 5) entries of each tile's list."""
    TG = rows.shape[0]
    ids = rows[:, 1:3].reshape(TG, 256).to(torch.int64) & 0x7FFFFF
    pos = torch.arange(256, device=rows.device)[None]
    tile, slot = torch.nonzero(pos < processed[:, None], as_tuple=True)
    return tile, ids[tile, slot]


def active_lanes(args, processed) -> tuple[int, int]:
    """(lanes of the processed blocks that pass their tile's coverage gate,
    all lanes of the processed blocks), from the plain version's decode."""
    rows, payload, _, _, cfg = args[:5]
    dev = rows.device
    tile, bid = _processed_ids(rows, processed)
    ox, oy = rv._tile_origins(rows.shape[0], cfg, 0, dev)
    oy = oy + rows[:, 0, 3].float()
    decode = (rv._decode_cooked if payload.dtype == torch.float32
              else rv._decode_words)
    n, step = 0, 8192
    for a in range(0, tile.numel(), step):
        t = tile[a:a + step]
        pay = payload[bid[a:a + step]]
        live = torch.ones((t.numel(), pay.shape[2]), dtype=torch.bool,
                          device=dev)
        n += int(decode(pay, live, ox[t], oy[t], float(cfg.tile_size))[3]
                 .sum())
    return n, tile.numel() * payload.shape[2]


def render_bound(args, processed: torch.Tensor):
    """Work of one render call from this run's data: ``processed`` blocks
    per tile (output channel 5). Bytes: the tile rows, the 16 payload rows
    of each tile's live big lanes and the payload of each distinct
    processed block read once, the (TG, 8, NPX) output written once.
    Operations: RENDER_OPS_PER_LANE per (pixel, lane of a processed block
    that passes the tile's coverage gate), and RENDER_OPS_PER_BIG per
    (pixel, live big lane). Returns the bound and the share of the
    processed blocks' lanes that pass the gate."""
    rows, payload, bigpay, _, cfg = args[:5]
    TG = rows.shape[0]
    NPX = cfg.tile_size ** 2
    n_blocks = int(torch.unique(_processed_ids(rows, processed)[1]).numel())
    lane_bytes = payload[0].numel() * payload.element_size()
    n_big = int(rows[:, 0, 4].sum())
    n_bytes = (nbytes(rows) + n_big * bigpay.shape[1] * 4
               + n_blocks * lane_bytes + TG * 8 * NPX * 4)
    active, lanes = active_lanes(args, processed)
    n_ops = (active * RENDER_OPS_PER_LANE + n_big * RENDER_OPS_PER_BIG) * NPX
    n_mufu = (active * RENDER_MUFU_PER_LANE
              + n_big * RENDER_MUFU_PER_BIG) * NPX
    form = (active * RENDER_FORM_MUFU_PER_LANE
            + n_big * RENDER_FORM_MUFU_PER_BIG) * NPX
    return bound(n_bytes, n_ops, n_mufu, form), active / max(lanes, 1)


def _describe(rows, processed):
    nb = rows[:, 0, 0]
    return (f"tiles {rows.shape[0]}, blocks/tile mean "
            f"{float(nb.float().mean()):.1f} max {int(nb.max())}, tiles with "
            f"bigs {int((rows[:, 0, 4] > 0).sum())}, blocks processed "
            f"{int(processed.sum())} of {int(nb.sum())}")


def _hold(tag, tk, tr, cfg, v4: bool = False) -> float:
    """Hold a render kernel's output to its plain version's: RGB PSNR >= 50
    dB, t_final within 1e-3, finite. Returns max |d| of channels 0-4."""
    asm, chans = ((r4.assemble_image_v4, r4.tile_channels_v4) if v4
                  else (rv.assemble_image_v3, rv.tile_channels_v3))
    ik, tfk = asm(tk, cfg)
    ir, tfr = asm(tr, cfg)
    finite = bool(torch.isfinite(tk).all())
    p = psnr(ik, ir)
    tf_err = float((tfk - tfr).abs().max())
    err = float((chans(tk, cfg)[..., :5] - chans(tr, cfg)[..., :5])
                .abs().max())
    diag = torch.equal(chans(tk, cfg)[..., 5:], chans(tr, cfg)[..., 5:])
    log(f"[{tag}] PSNR vs plain {p:.2f} dB, max |d t_final| {tf_err:.3g}, "
        f"max |d| {err:.3g}, channels 5-7 equal {diag}, finite {finite}")
    check(finite, f"{tag}: non-finite kernel output")
    check(p >= 50.0, f"{tag}: PSNR {p:.2f} dB < 50")
    check(tf_err <= 1e-3, f"{tag}: t_final error {tf_err}")
    check(diag, f"{tag}: channels 5-7 differ from the plain version")
    return err


def v3_kernel(args, early_exit: bool = True):
    """The v3 kernel on the plain version's arguments: it takes no big
    log-alpha maps."""
    rows, payload, bigpay, _, cfg, U, max_batches = args
    return rv._render_cuda(rows, payload, bigpay, cfg, U, max_batches,
                           early_exit)


def v4_kernel(args, GT: int, early_exit: bool = True):
    """The v4 kernel on the plain version's arguments: it takes no big
    log-alpha maps."""
    rows, payload, bigpay, _, cfg, U, max_batches = args
    return r4._render_v4_cuda(rows, payload, bigpay, cfg, U, max_batches, GT,
                              early_exit)


def _hold_v4_to_v3(tag, t4, t3, cfg) -> None:
    """The v4 kernel against the cooked v3 kernel on the same inputs:
    bit-equal in all 8 channels of every true tile (both run the same
    per-tile pipeline)."""
    same = torch.equal(r4.tile_channels_v4(t4, cfg),
                       rv.tile_channels_v3(t3, cfg))
    log(f"[{tag}] bit-equal to the cooked v3 kernel: {same}")
    check(same, f"{tag}: v4 and cooked v3 kernels differ")


def _render_vs_plain(tag, args):
    """The v3 kernel against its plain version on one set of inputs."""
    tk = v3_kernel(args)
    tr = rv.render_tiles_v3_reference(*args, early_exit=True)
    torch.cuda.synchronize()
    err = _hold(f"{tag}; {_describe(args[0], tk[:, 5, 0])}", tk, tr, args[4])
    return tk, err


def _time_render(tag, fn_kernel, fn_plain, args, processed):
    ms = time_ms(fn_kernel, 10)
    plain_ms = time_ms(fn_plain, 2)
    bnd, share = render_bound(args, processed)
    log(f"[{tag}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{bound_text(bnd)}; lanes past the coverage gate "
        f"{100 * share:.1f}%")


def render_cloud(n: int):
    return gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        n, seed=2, scale_range=(0.005, 0.12), surfaces=True)))


def phase_render(cloud, size: int) -> float:
    """Phase 3: the v3 kernel on the word payload (fast_defaults())."""
    cfg = gt.RasterizerConfig(width=size, height=size).fast_defaults()
    worst = 0.0
    for hm in (0.0, 1.0):
        args = _frame_inputs(cloud, cfg, hm, words=True)
        tk, err = _render_vs_plain(f"3 render {size}x{size} heatmap {hm}",
                                   args)
        worst = max(worst, err)
        if hm == 0.0:
            _time_render(
                "3 render", lambda: v3_kernel(args),
                lambda: rv.render_tiles_v3_reference(*args, early_exit=True),
                args, tk[:, 5, 0])
    return worst


def phase_render_cooked(cloud, size: int) -> float:
    """Phase 3b: the v3 kernel on the cooked payload at the shapes of
    RasterizerConfig(quality="fast"), and against the word kernel on the
    same blocks."""
    cfg = gt.RasterizerConfig(width=size, height=size, quality="fast")
    worst = 0.0
    for hm in (0.0, 1.0):
        args = _frame_inputs(cloud, cfg, hm, words=False)
        check(args[1].dtype == torch.float32 and args[1].shape[1] == 16,
              "3b: the payload is not the cooked one")
        tk, err = _render_vs_plain(f"3b cooked {size}x{size} tile "
                                   f"{cfg.tile_size} U={args[5]} heatmap "
                                   f"{hm}", args)
        worst = max(worst, err)
        wargs = _frame_inputs(cloud, cfg, hm, words=True)
        tw = v3_kernel(wargs)
        p = psnr(rv.assemble_image_v3(tk, cfg)[0],
                 rv.assemble_image_v3(tw, cfg)[0])
        log(f"[3b cooked] heatmap {hm}: cooked vs word kernel PSNR {p:.2f} dB")
        check(p >= 60.0, f"3b: cooked vs words PSNR {p:.2f} dB < 60")
        if hm == 0.0:
            _time_render(
                "3b cooked", lambda: v3_kernel(args),
                lambda: rv.render_tiles_v3_reference(*args, early_exit=True),
                args, tk[:, 5, 0])
    return worst


def phase_render_v4(cloud, sizes) -> float:
    """Phase 3c: the v4 kernel against its plain version, and bit-equal to
    the cooked v3 kernel on the same inputs: tile 32 at each size, and
    quality="fast" (tile 16) at the first."""
    worst = 0.0
    shapes = [gt.RasterizerConfig(width=size, height=size,
                                  kernel="v4").fast_defaults()
              for size in sizes]
    shapes.append(gt.RasterizerConfig(width=sizes[0], height=sizes[0],
                                      quality="fast", kernel="v4"))
    for i, cfg in enumerate(shapes):
        GT = cfg.lockstep_gt
        args = _frame_inputs(cloud, cfg, 1.0, words=False)
        t4 = v4_kernel(args, GT)
        t3 = v3_kernel(args)
        tr = r4.render_tiles_v4_reference(*args, GT, True)
        torch.cuda.synchronize()
        T = cfg.num_tiles
        T4 = t4.shape[0]
        w, h = cfg.target_size
        tag = (f"3c v4 {w}x{h} tile {cfg.tile_size} U={args[5]} GT={GT}, {T} "
               f"tiles in {T4} groups ({T4 * GT - T} padded slots)")
        worst = max(worst, _hold(tag, t4, tr, cfg, v4=True))
        _hold_v4_to_v3(f"3c v4 {w}x{h} tile {cfg.tile_size}", t4, t3, cfg)
        if i == 0:
            _time_render(
                "3c v4", lambda: v4_kernel(args, GT),
                lambda: r4.render_tiles_v4_reference(*args, GT, True),
                args, t3[:, 5, 0])
    return worst


def exact_inputs(cloud, cfg, heatmap: float):
    """The exact composite's inputs for the reset camera: the readable
    projection, emit_and_sort and tile_boundaries."""
    cloud = sh_rows(cloud)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device,
                           heatmap=heatmap)
    prj = project_splats(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                         cloud.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, cfg)
    pairs = emit_and_sort(prj.valid, prj.rect, prj.num_tiles, prj.depth16,
                          cfg)
    start, end = tile_boundaries(pairs.keys, pairs.num_pairs, cfg)
    return (pairs.values, start, end, prj.image_pos, prj.conic, prj.color,
            uni.heatmap_factor)


def exact_plain(args, cfg, capacity: int):
    """The plain version on the card, 256 tiles a batch: its RenderOutput
    and the (T, ts * ts) count of slots each tile pixel processed."""
    return rx._composite(*args, cfg, capacity, 256, (0, 0))


def exact_slots(cfg, n_proc: torch.Tensor) -> tuple:
    """(slots the tiles load, (pixel, slot) pairs processed) from the plain
    version's per-pixel counts, over the target's pixels only: a tile loads
    the most slots any of its pixels processes."""
    w, h = cfg.target_size
    gx, gy = cfg.tile_dims
    ts = cfg.tile_size
    dev = n_proc.device
    inside = ((torch.arange(gy * ts, device=dev) < h).reshape(gy, 1, ts, 1)
              & (torch.arange(gx * ts, device=dev) < w).reshape(1, gx, 1, ts))
    need = n_proc.reshape(gy, gx, ts, ts) * inside
    return (int(need.amax(dim=(2, 3)).sum()), int(need.sum()))


def exact_bound(args, cfg, n_proc: torch.Tensor) -> dict:
    """Work of one exact composite from this run's data (see
    BOUND_COUNTS["render_exact"]): the function's need, and as
    ``lockstep_bound_ms`` the operations the kernel's per-tile lockstep
    evaluates."""
    w, h = cfg.target_size
    tile_slots, pixel_slots = exact_slots(cfg, n_proc)
    n_bytes = (tile_slots * EXACT_BYTES_PER_SLOT + nbytes(args[1], args[2])
               + w * h * 16)
    lock_pairs = tile_slots * cfg.tile_size ** 2
    lockstep = bound(n_bytes, lock_pairs * EXACT_OPS_PER_SLOT,
                     lock_pairs * EXACT_MUFU_PER_SLOT)
    return {**bound(n_bytes, pixel_slots * EXACT_OPS_PER_SLOT,
                    pixel_slots * EXACT_MUFU_PER_SLOT),
            "lockstep_bound_ms": lockstep["bound_ms"]}


def hold_exact(tag, ok, pr) -> float:
    """The exact kernel against its plain version: RGB within 1e-4, tile_t0
    bit-equal, counts equal, finite. Returns the RGB max |d|."""
    finite = bool(torch.isfinite(ok.image).all())
    err = float((ok.image - pr.image).abs().max())
    t0_equal = torch.equal(ok.tile_t0, pr.tile_t0)
    counts = torch.equal(ok.tile_counts, pr.tile_counts)
    log(f"[{tag}] max |d rgb| {err:.3g}, max |d tile_t0| "
        f"{float((ok.tile_t0 - pr.tile_t0).abs().max()):.3g} (bit-equal "
        f"{t0_equal}), counts equal {counts}, finite {finite}, PSNR "
        f"{psnr(ok.image.permute(2, 0, 1), pr.image.permute(2, 0, 1)):.2f} dB")
    check(finite, f"{tag}: non-finite kernel output")
    check(err <= 1e-4, f"{tag}: RGB error {err}")
    check(t0_equal, f"{tag}: tile_t0 not bit-equal")
    check(counts, f"{tag}: tile counts differ")
    return err


def exact_walk(args, cfg, n_proc, counts, capacity: int,
               ms: float | None = None) -> str:
    """The kernel's walk on these inputs, for the log: the (pixel, slot)
    evaluations it makes, counted by the kernel in one launch
    (render_exact.count_evaluations) and held equal to the count
    render_exact.schedule_evaluations models from the plain version's
    per-pixel counts; the instructions an evaluation takes in its kernel
    instance (render_exact.sass_per_evaluation of the built library:
    "all", base opcodes and MUFU.EX2); with the kernel's ``ms``, ms per G
    evaluations and the issue share they imply (instructions over the
    card's 128 lane-instructions per SM and clock)."""
    piece, threads = rx.walk_shape()
    ev = rx.count_evaluations(*args, cfg, capacity)
    model = rx.schedule_evaluations(n_proc, cfg, piece, threads, counts,
                                    capacity)
    check(ev == model, f"render_exact {cfg.target_size}: the kernel made "
          f"{ev} evaluations, schedule_evaluations models {model}")
    ppt = rx.pixels_per_thread(cfg.tile_size, threads)
    sass = rx.sass_per_evaluation(kernels.sass("render_exact"))[ppt]
    shown = {k: round(v, 3) for k, v in sass.items()
             if "." not in k or k == "MUFU.EX2"}
    t = (f"walk: {ev} evaluations counted by the kernel (schedule_evaluations"
         f" {model}; pieces of {piece}), SASS per evaluation of "
         f"render_exact_kernel<{ppt}> {json.dumps(shown)}")
    if ms is not None:
        issue = ev * sass["all"] / (ms * 1e-3) / sp.card_peaks()["fma_per_s"]
        t += (f", {ms / (ev / 1e9):.4f} ms per G evaluations, issue share "
              f"{100 * issue:.1f}%")
    return t


def phase_exact(cloud, size: int) -> float:
    """Phase 7: the exact composite kernel against its plain version."""
    worst = 0.0
    cases = [(gt.RasterizerConfig(width=size, height=size), 2048, hm)
             for hm in (0.0, 1.0)]
    cases += [(gt.RasterizerConfig(width=size // 2, height=size // 2,
                                   tile_size=32), 2048, 1.0),
              (gt.RasterizerConfig(width=size, height=size), 1000, 0.0),
              (gt.RasterizerConfig(width=size, height=size), 300, 1.0)]
    for i, (cfg, cap, hm) in enumerate(cases):
        args = exact_inputs(cloud, cfg, hm)
        ok = rx.render_tiles(*args, cfg, tile_capacity=cap)
        pr, n_proc = exact_plain(args, cfg, cap)
        torch.cuda.synchronize()
        w, h = cfg.target_size
        counts = pr.tile_counts
        tile_slots, pixel_slots = exact_slots(cfg, n_proc)
        tag = (f"7 exact {w}x{h} tile {cfg.tile_size} capacity {cap} "
               f"heatmap {hm}; tiles {counts.numel()}, count mean "
               f"{float(counts.float().mean()):.1f} max {int(counts.max())}, "
               f"over the capacity {int((counts > cap).sum())}, slots "
               f"loaded {tile_slots} of "
               f"{int(counts.clamp(max=rx.effective_capacity(cap)).sum())}, "
               f"(pixel, slot) pairs processed {pixel_slots}")
        worst = max(worst, hold_exact(tag, ok, pr))
        if cap in (300, 1000):
            check(int((counts > rx.effective_capacity(cap)).sum()) > 0,
                  "7: no tile is long enough to test the truncation")
        ms = (time_ms(lambda: rx.render_tiles(*args, cfg), 10) if i == 0
              else None)
        log(f"[{tag}] {exact_walk(args, cfg, n_proc, counts, cap, ms)}")
        if i == 0:
            plain_ms = time_ms(lambda: exact_plain(args, cfg, 2048), 2)
            bnd = exact_bound(args, cfg, n_proc)
            log(f"[7 exact] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"{bound_text(bnd)}, lockstep bound "
                f"{bnd['lockstep_bound_ms']:.4f} ms")
    return worst


def frame_cloud(n: int):
    """bench.py's scene in its load order (full precision; the fast frames
    read its fast_cloud_view)."""
    t0 = time.perf_counter()
    cloud = gt.mortonize(gt.synthetic_scene(
        n, seed=42, extent=4.0, scale_range=(0.004, 0.03), surfaces=True))
    return cloud, time.perf_counter() - t0


def phase_frame(tag: str, cloud, cfg, frames: int, expect) -> dict:
    """Drive render_frame_fast_staged over an orbit: the launch counters
    are set to 0 just before the timed frames and read just after."""
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    dev = cloud.means.device
    width, height = cfg.target_size
    cams = gt.orbit_trajectory(frames, radius=5.0, target=(0, 0, 6.0))
    unis = [gt.make_uniforms(c, cfg) for c in cams]
    out = gt.render_frame_fast(cloud, unis[0], cfg)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    frame_ms, stages = [], []
    for uni in unis:
        timer = gt.StageTimer(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = gt.render_frame_fast_staged(cloud, uni, cfg, timer=timer)
        b.record()
        stages.append(timer.times_ms())
        frame_ms.append(a.elapsed_time(b))
        check(out.image.device.type == "cuda", f"{tag}: image not on the card")
        check(bool(torch.isfinite(out.image).all()),
              f"{tag}: non-finite image")
        check(int(out.stats.num_pairs) > 0, f"{tag}: no splat-tile pairs")
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gx, gy = cfg.tile_dims
    centre = (gy // 2) * gx + gx // 2
    pick = gt.pick_splat_position_fast(out, centre, cloud, 1.0, cfg)
    check(bool(torch.isfinite(pick).all()), f"{tag}: centre pick {pick}")
    d_pick = float((cloud.means[:cloud.num_splats] - pick).norm(dim=1).min())
    check(d_pick < 1e-4, f"{tag}: centre pick is not a splat mean ({d_pick})")
    for name in expect:
        check(launches[name] > 0, f"{tag}: kernel {name} never launched")
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    log(f"[{tag}] {cloud.num_splats} splats {width}x{height}, tile "
        f"{cfg.tile_size} U={cfg.batch_u or rv.default_batch_u(cfg.tile_size)}"
        f" kernel {cfg.kernel} projection_kernel {cfg.projection_kernel} "
        f"words {cfg.words_payload} cluster {cfg.cluster}, {frames} orbit "
        f"frames: median {statistics.median(frame_ms):.3f} ms/frame (all "
        f"{[round(x, 3) for x in frame_ms]}), median stages "
        f"{json.dumps({k: round(v, 3) for k, v in med.items()})}, peak "
        f"memory {peak / 2**30:.2f} GiB, pairs {int(out.stats.num_pairs)}, "
        f"overflow {int(out.stats.num_overflow)}, launches "
        f"{json.dumps(launches)}, centre pick {pick.tolist()}")
    return launches


def profile(tag: str, run_frame, frames: int) -> dict:
    """torch.profiler over ``frames`` calls of ``run_frame(i)`` (after a
    warm-up call): the device's busy time (the union of its kernels'
    intervals) over the device span, the kernels with the most device time
    and the matrix products (gemm). Returns the gemms by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    run_frame(0)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            run_frame(i)
        torch.cuda.synchronize()
    ivs = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(ivs), f"{tag} profile: no device activity was traced")
    busy, end = 0.0, ivs[0][0]
    for a, b in ivs:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = ivs[-1][1] - ivs[0][0]
    by_name: dict = {}
    gemms: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
            if "gemm" in e.name.lower():
                n, t = gemms.get(e.name[:60], (0, 0.0))
                gemms[e.name[:60]] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"[{tag} profile] {frames} frames: device busy {busy / 1e3:.3f} ms "
        f"of a {span / 1e3:.3f} ms device span ({100 * busy / span:.1f}%), "
        f"{len(ivs)} device activities; top by device ms per frame "
        f"{json.dumps({n[:60]: round(t / 1e3 / frames, 3) for n, t in top})}")
    log(f"[{tag} profile] matrix products (gemm), launches and device ms per "
        f"frame: {json.dumps({n: [c / frames, round(t / 1e3 / frames, 3)] for n, (c, t) in gemms.items()})}")
    return gemms


def profile_stage(tag: str, cloud, cfg, stage: str, frames: int = 3) -> None:
    """torch.profiler over one stage of the fast frame alone (``stage``:
    "Blocks" or "Binning"), eager, on the inputs the stages before it give
    for ``frames`` orbit cameras: the device's busy time a stage, its
    kernels and the aten ops that launch them, each with launches and
    device ms a stage."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    cams = gt.orbit_trajectory(frames, radius=5.0, target=(0, 0, 6.0))
    stages = [dict(_frame_stages(cloud, gt.make_uniforms(c, cfg), cfg))
              for c in cams]
    before = list(stages[0])[:list(stages[0]).index(stage)]
    inputs = []
    for s in stages:
        x = None
        for name in before:
            x = s[name](x)
        inputs.append(x)
    stages[0][stage](inputs[0])                             # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for s, x in zip(stages, inputs):
            s[stage](x)
        torch.cuda.synchronize()
    kern: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = kern.get(e.name[:110], (0, 0.0))
            kern[e.name[:110]] = (n + 1, t + e.time_range.elapsed_us())
    busy = sum(t for _, t in kern.values())
    ops = [(a.key, a.count, a.self_device_time_total)
           for a in prof.key_averages() if a.key.startswith("aten::")
           and a.self_device_time_total > 0]

    def top(items, k):
        return {n: [round(c / frames, 2), round(t / 1e3 / frames, 4)]
                for n, c, t in sorted(items, key=lambda x: -x[2])[:k]}

    log(f"[{tag} {stage} profile] {frames} eager {stage} stages: "
        f"{busy / 1e3 / frames:.3f} device ms a stage in "
        f"{sum(c for c, _ in kern.values()) / frames:.0f} kernel launches; "
        f"top kernels [launches, device ms] a stage "
        f"{json.dumps(top([(n, c, t) for n, (c, t) in kern.items()], 16))}")
    log(f"[{tag} {stage} profile] aten ops by self device ms, [calls, ms] a "
        f"stage {json.dumps(top(ops, 20))}")


def profile_frames(tag: str, cloud, cfg, frames: int = 3) -> None:
    """The profile of ``frames`` orbit frames of render_frame_fast. A v4
    frame must run no gemm: its render kernel takes no prepass_big_la
    maps."""
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    cams = gt.orbit_trajectory(frames, radius=5.0, target=(0, 0, 6.0))
    unis = [gt.make_uniforms(c, cfg) for c in cams]
    gemms = profile(tag, lambda i: gt.render_frame_fast(cloud, unis[i], cfg),
                    frames)
    if cfg.kernel == "v4" and cfg.projection_kernel:
        check(not gemms, f"{tag} profile: the v4 frame runs a gemm")


def last_capture_s(r) -> float:
    """The ``capture`` phase of the Rasterizer's last frame that captured
    its graphs, in seconds (its host-phase ring's last 64 frames)."""
    took = r.host_phases.last_frames(64)[:, telemetry.CAPTURE]
    took = took[took > 0]
    return float(took[-1]) if len(took) else float("nan")


def engine_frames(tag: str, r, cloud, frames: int, expect) -> dict:
    """Drive a Rasterizer over ``frames`` orbit cameras with
    rasterize(sync=True) after one warm-up frame; the launch counters are
    set to 0 just before each timed frame and read just after it, and every
    kernel of ``expect`` must launch in every frame. Returns the launches
    summed over the frames."""
    cams = gt.orbit_trajectory(frames, radius=5.0, target=(0, 0, 6.0))
    r.rasterize(sync=True)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings, overflow = [], []
    launches = {name: 0 for name in kernels.COUNTERS}
    for i, cam in enumerate(cams):
        r.camera = cam
        r.update_camera_matrices()
        kernels.reset_launch_counts()
        out = r.rasterize(sync=True)
        counts = kernels.launch_counts()
        for name in launches:
            launches[name] += counts[name]
        for name in expect:
            check(counts[name] >= 1,
                  f"{tag}: {name} not launched by frame {i} ({counts})")
        info = r.debug_info()
        timings.append(info["timings"])
        overflow.append(info["pair_overflow_dropped"])
        check(out.image.device.type == "cuda", f"{tag}: image not on the card")
        check(bool(torch.isfinite(out.image).all()), f"{tag}: non-finite image")
        check(info["rendered_splats"] > 0, f"{tag}: no rendered splats")
    peak = torch.cuda.max_memory_allocated()
    pick = r.get_splat_position((960, 540))
    check(bool(np.all(np.isfinite(pick))), f"{tag}: centre pick {pick}")
    ply = torch.tensor([-pick[0], -pick[1], pick[2]], device=cloud.device)
    d_pick = float((cloud.means[:cloud.num_splats] - ply).norm(dim=1).min())
    check(d_pick < 1e-4, f"{tag}: centre pick is not a splat mean ({d_pick})")
    med = {k: statistics.median(t[k] for t in timings) for k in timings[0]}
    log(f"[{tag}] {cloud.num_splats} splats 1920x1080, quality {r.quality}, "
        f"tile {r.config.tile_size}, {frames} orbit frames with "
        f"rasterize(sync=True): median frame {med['Frame']:.3f} ms (all "
        f"{[round(t['Frame'], 3) for t in timings]}), median stages "
        f"{json.dumps({k: round(v, 3) for k, v in med.items() if k != 'Frame'})}"
        f", peak memory {peak / 2**30:.2f} GiB, rendered splats "
        f"{info['rendered_splats']}, num_overflow {overflow}, final "
        f"tile_capacity {r.tile_capacity}, launches {json.dumps(launches)}, "
        f"centre pick {[float(x) for x in pick]}")
    return launches


EXACT_PATH = ("projection_readable", "emit_plan", "emit_exact",
              "sort_pairs", "render_exact")
FAST_PATH = ("projection", "block_frame", "big_lanes", "big_set",
             "bin_blocks", "bin_bigs", "render_v3")


def phase_engine(cloud, frames: int) -> tuple:
    """Phase 8: the engine end to end at 1920x1080 on both qualities; then
    torch.profiler over 3 exact frames and the fast frame's PSNR against
    the exact one at the reset camera. Returns (the exact frames'
    launches, the exact Rasterizer's final tile capacity)."""
    t0 = time.perf_counter()
    exact = gt.Rasterizer(cloud, texture_size=(1920, 1080))
    fast = gt.Rasterizer(cloud, texture_size=(1920, 1080), quality="fast")
    log(f"[8 engine] both Rasterizers set up in "
        f"{time.perf_counter() - t0:.1f} s")
    check(exact.quality == "exact" and fast.quality == "fast",
          "8: unexpected qualities")
    launches = engine_frames("8 engine exact", exact, cloud, frames,
                             EXACT_PATH)
    log(f"[8 engine exact] frames replayed from {exact.graph_captures} "
        f"capture(s) (a tile-capacity regrowth recaptures; the last of "
        f"{last_capture_s(exact):.2f} s: warm-up frame and four "
        f"graphs), launches a replay "
        f"{json.dumps(exact.exact_graph.launches)}")
    with blocks_dispatch(plain=True):
        plain = gt.Rasterizer(cloud, texture_size=(1920, 1080),
                              quality="fast")
        engine_frames("8 engine fast, plain Blocks", plain, cloud, frames,
                      ("projection", "render_v3"))
    del plain
    engine_frames("8 engine fast", fast, cloud, frames, FAST_PATH)
    check(fast.graph_captures == 1,
          f"8 engine fast: {fast.graph_captures} graph captures over the "
          f"orbit (one expected: its frames are replays)")
    log(f"[8 engine fast] frames replayed from one capture of "
        f"{last_capture_s(fast):.2f} s (warm-up frame and four "
        f"graphs), launches a replay {json.dumps(fast.fast_graph.launches)}")
    cams = gt.orbit_trajectory(3, radius=5.0, target=(0, 0, 6.0))

    def exact_frame(i):
        exact.camera = cams[i]
        exact.update_camera_matrices()
        exact.rasterize()

    profile("8 engine exact", exact_frame, 3)
    images = []
    for r in (exact, fast):
        r.camera = gt.Camera.reset_pose()
        r.update_camera_matrices()
        r.rasterize(sync=True)
        images.append(torch.from_numpy(np.ascontiguousarray(
            r.image())).permute(2, 0, 1))
    log(f"[8 engine] fast against exact at the reset camera, 1920x1080: "
        f"PSNR {psnr(images[1], images[0]):.2f} dB (not gated)")
    return launches, exact.tile_capacity


def _processed(tiles, cfg):
    """Blocks processed per true tile (output channel 5) of a v3 or v4
    kernel's output."""
    if cfg.kernel == "v4":
        return r4.tile_channels_v4(tiles, cfg)[:, 0, 5]
    return tiles[:, 5, 0]


def lockstep_sharing(rows, processed, GT: int, U: int) -> dict:
    """Of the chain blocks the GT tiles of a group fetch at the same batch
    k (each tile's processed list positions k*U .. k*U+U-1), the distinct
    (group, k, block) fetches and the share of them that two or more of
    the group's tiles make: what one TMA multicast across the group's
    cluster could load once. Counted on the host from the rows."""
    T = rows.shape[0]
    ids = rows[:, 1:3].reshape(T, 256).to(torch.int64) & 0x7FFFFF
    pos = torch.arange(256, device=rows.device)[None]
    tile, slot = torch.nonzero(pos < processed[:, None], as_tuple=True)
    key = ((tile // GT) * 256 + slot // U) << 23 | ids[tile, slot]
    # a tile fetches a block once per batch
    key = torch.unique(torch.stack([key, tile]), dim=1)[0]
    _, counts = torch.unique(key, return_counts=True)
    return {"fetches": int(key.numel()), "distinct": int(counts.numel()),
            "shared_by_2_or_more": int((counts >= 2).sum()),
            "share": float((counts >= 2).sum()) / max(int(counts.numel()), 1),
            "fetches_saved": 1.0 - counts.numel() / max(key.numel(), 1)}


def _render_1080p(name, cfg, args, kernel, plain) -> dict:
    """One render kernel on its 1080p frame's inputs: held to its plain
    version (one call, timed), then timed beside its bound."""
    tk = kernel()
    tr, plain_ms = time_once(plain)
    v4 = name == "render_v4"
    processed = _processed(tk, cfg)
    tag = (f"6 {name} 1080p tile {cfg.tile_size} U={args[5]}"
           f"{f' GT={cfg.lockstep_gt}' if v4 else ''}")
    err = _hold(f"{tag}; {_describe(args[0], processed)}", tk, tr, cfg, v4)
    ms = time_ms(kernel, 5)
    bnd, share = render_bound(args, processed)
    log(f"[{tag}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (one call, "
        f"tiles in chunks), {bound_text(bnd)}; lanes past the coverage "
        f"gate {100 * share:.1f}%")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bnd": bnd,
            "processed": processed, "kernel_out": tk, "plain_out": tr}


def phase_kernels_1080p(cloud, base, worst: dict) -> list:
    """Phase 6: every kernel on the inputs of the 1080p frame that runs it
    (the reset camera), held to its plain version and timed beside its
    bound; the v4 kernel at GT 1, 2 and 4 (tile 32) and 4 (tile 16) also
    held bit-equal to the cooked v3 kernel and timed beside it. Returns the
    kernels' records (``worst``: the largest error of the earlier
    phases)."""
    e, ms, plain_ms, bnd = projection_vs_plain(
        "6 projection 1080p", cloud, base.fast_defaults(), 2)
    rec = [record("projection", max(worst["projection"], e), ms, plain_ms,
                  bnd)]
    # SH degree 0 (benchmarks/configs.py's first workload): both
    # projections bit-equal to their plain versions
    sh0 = base.replace(sh_degree=0)
    projection_vs_plain("6 projection 1080p SH degree 0", cloud,
                        sh0.fast_defaults(), 1, exact=True)
    readable_vs_plain("6 projection_readable 1080p SH degree 0",
                      sh_rows(cloud), sh0.replace(quality="fast"), 1)
    runs = {}
    for name, cfg, words in (
            ("render_v3", base.fast_defaults(), True),
            ("render_v3_cooked", base.replace(quality="fast"), False),
            ("render_v4", base.replace(kernel="v4").fast_defaults(), False)):
        args = _frame_inputs(cloud, cfg, 0.0, words)
        GT = cfg.lockstep_gt
        if name == "render_v4":
            r = _render_1080p(
                name, cfg, args, lambda: v4_kernel(args, GT),
                lambda: r4.render_tiles_v4_reference(*args, GT, True))
        else:
            r = _render_1080p(
                name, cfg, args, lambda: v3_kernel(args),
                lambda: rv.render_tiles_v3_reference(*args, True))
        rec.append(record(name, max(worst[name], r["err"]), r["ms"],
                          r["plain_ms"], r["bnd"]))
        runs[name] = (cfg, args, r)
    del runs["render_v3"]
    cfg, args, r = runs["render_v4"]   # the v4 frame's tile-32 inputs
    share = lockstep_sharing(args[0], r["processed"], cfg.lockstep_gt,
                             args[5])
    log(f"[6 v4 lockstep sharing 1080p] chain-block fetches of a group's "
        f"tiles at one batch: {json.dumps(share)}")
    res = {"bound tile 32": r["bnd"]}
    # tile 32 on the v4 frame's inputs; tile 16 on the quality="fast"
    # frame's, where the cooked v3 kernel's output and its plain version's
    # are those just held to each other
    for name in ("render_v4", "render_v3_cooked"):
        cfg, args, r = runs[name]
        t3 = v3_kernel(args) if name == "render_v4" else r["kernel_out"]
        v3_ms = [time_ms(lambda: v3_kernel(args), 5)]
        for GT in ((1, 2, 4) if cfg.tile_size == 32 else (4,)):
            t4 = v4_kernel(args, GT)
            tag = f"6 v4 tile {cfg.tile_size} GT={GT} 1080p"
            _hold_v4_to_v3(tag, t4, t3, cfg.replace(lockstep_gt=GT))
            if cfg.tile_size == 16:
                as_v3 = r4.tile_channels_v4(t4, cfg).transpose(1, 2)
                _hold(tag, as_v3.contiguous(), r["plain_out"], cfg)
            res[f"render_v4 tile {cfg.tile_size} U={args[5]} GT={GT}"] = (
                time_ms(lambda: v4_kernel(args, GT), 5))
            del t4
        v3_ms.append(time_ms(lambda: v3_kernel(args), 5))
        res[f"render_v3_cooked tile {cfg.tile_size} U={args[5]}, before "
            f"and after"] = v3_ms
        if cfg.tile_size == 16:
            res["bound tile 16"] = r["bnd"]
    log(f"[6 v4 vs cooked v3 1080p] kernel ms on the same inputs "
        f"{json.dumps(res)}")
    return rec


def exact_1080p(cloud, base, capacity: int, worst: float) -> dict:
    """Phase 6, the exact composite: the kernel against its plain version
    on the 1080p exact frame's inputs (reset camera) at the tile capacity
    the engine settled on, at phase 7's gates; both timed, beside the
    bound. Returns the kernel's record."""
    cfg = base
    args = exact_inputs(cloud, cfg, 0.0)
    ok = rx.render_tiles(*args, cfg, tile_capacity=capacity)
    (pr, n_proc), plain_ms = time_once(lambda: exact_plain(args, cfg,
                                                           capacity))
    counts = pr.tile_counts
    tile_slots, pixel_slots = exact_slots(cfg, n_proc)
    tag = (f"6 render_exact 1080p tile {cfg.tile_size} capacity {capacity}; "
           f"tiles {counts.numel()}, count mean "
           f"{float(counts.float().mean()):.1f} max {int(counts.max())}, "
           f"slots loaded {tile_slots} of "
           f"{int(counts.clamp(max=rx.effective_capacity(capacity)).sum())}, "
           f"(pixel, slot) pairs processed {pixel_slots}")
    err = hold_exact(tag, ok, pr)
    ms = time_ms(lambda: rx.render_tiles(*args, cfg, tile_capacity=capacity),
                 5)
    bnd = exact_bound(args, cfg, n_proc)
    walk = exact_walk(args, cfg, n_proc, counts, capacity, ms)
    log(f"[6 render_exact 1080p] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(one call, 256 tiles a batch), {bound_text(bnd)}, lockstep "
        f"bound {bnd['lockstep_bound_ms']:.4f} ms; {walk}")
    return record("render_exact", max(worst, err), ms, plain_ms, bnd)


def exact_stages_1080p(full, base, worst: dict) -> list:
    """Phase 6, the exact frame's Projection and Sort kernels on the 1080p
    exact frame's inputs (reset camera): the readable projection (f32 SH,
    the exact frame's; bf16 logged), the write-once emission and the radix
    sort of its live pairs, each held bit-equal to its plain version and
    timed beside its bound; the emission and the sort also at a sort
    buffer of half the pairs (it drops pairs); the sort also beside
    torch.sort (library_ms). Returns the three kernels' records."""
    e, ms, plain_ms, bnd = readable_vs_plain(
        "6 projection_readable 1080p f32", full, base, 2)
    rec = [record("projection_readable",
                  max(worst["projection_readable"], e), ms, plain_ms, bnd)]
    readable_vs_plain("6 projection_readable 1080p bf16",
                      gt.fast_cloud_view(full, planar_sh=False), base, 2)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), base)
    prj = project_splats(full.means, full.cov3d, full.opacity, full.sh,
                         full.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, base)
    rec.append(plan_vs_plain("6 emit_plan 1080p", prj, base))
    e, ms, plain_ms, bnd, n, emitted = emit_vs_plain("6 emit_exact 1080p",
                                                     prj, base)
    rec.append(record("emit_exact", e, ms, plain_ms, bnd))
    k_max = emitted[0].shape[0] - 1
    dist = pairs_a_tile(emitted[0], min(n, k_max),
                        so.sort_key_bits(base.num_tiles))
    log(f"[6 sort_pairs 1080p] pairs a tile: {json.dumps(dist)}")
    srt = sort_vs_plain("6 sort_pairs 1080p", emitted, base)
    del emitted
    r = record("sort_pairs", 0.0, srt["ms"], srt["plain_ms"], srt["bnd"])
    r.update(library_ms=srt["library_ms"],
             library_ms_live=srt["library_ms_live"],
             pass_bytes=srt["pass_bytes"])
    rec.append(r)
    check(n // 2 < min(n, k_max), "6 emit_exact: no pair to drop")
    emitted = emit_vs_plain(f"6 emit_exact 1080p capacity {n // 2}", prj,
                            base, capacity=n // 2, plain_reps=1)[-1]
    sort_vs_plain(f"6 sort_pairs 1080p capacity {n // 2}", emitted, base,
                  full=False)
    sort_edge_cases()
    return rec


def exact_sort_4k(cloud, other_so=None, card: str = "") -> dict:
    """The exact frame's emission and sort_pairs at 3840x2160 (tile 16:
    32,400 tiles, end_bit 31) on benchmarks/configs.py's fifth workload's
    scene (the reset camera): the plan and the sort bit-equal to their
    plain versions and timed, with its pairs a tile; with ``other_so``
    (``--sorts OTHER``), the other checkout's plan against this one's
    (``ab_plan``). Returns the sort's numbers."""
    cfg = gt.RasterizerConfig(width=3840, height=2160)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    prj = project_splats(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                         cloud.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, cfg)
    plan_vs_plain("14 emit_plan 4K", prj, cfg, full=False)
    ms = time_graphed_ms(lambda: so._emit_plan_cuda(prj.valid, prj.num_tiles,
                                                    cfg), 20)
    log(f"[14 emit_plan 4K] {prj.valid.shape[0]} splats: kernel {ms:.4f} ms "
        f"(graph replays of 20 calls)")
    if other_so is not None:
        ab_plan("ab emit_plan 4K", other_so, prj.valid, prj.num_tiles, cfg,
                card)
    keys, vals, total, _ = so.emit_pairs(prj.valid, prj.rect, prj.num_tiles,
                                         prj.depth16, cfg)
    del prj
    k_max = keys.shape[0] - 1
    end_bit = so.sort_key_bits(cfg.num_tiles)
    check(end_bit == 31, f"14 exact sort 4K: end_bit {end_bit}")
    dist = pairs_a_tile(keys, min(int(total), k_max), end_bit)
    log(f"[14 exact sort 4K] {cloud.num_splats} splats, {cfg.num_tiles} "
        f"tiles: pairs a tile {json.dumps(dist)}")
    return sort_vs_plain("14 sort_pairs 4K end_bit 31", (keys, vals, total),
                         cfg)


def profile_sort(tag: str, full, cfg, capacity: int, frames: int = 3,
                 plain_plan: bool = False) -> None:
    """torch.profiler over the exact frame's Sort stage alone, eager, on
    the projected splats of ``frames`` orbit cameras: the device's busy
    time a stage, its kernels and the aten ops that launch them, each with
    launches and device ms a stage. With ``plain_plan``, the stage's plan
    runs as it did before its kernel (``plan_dispatch``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    cams = gt.orbit_trajectory(frames, radius=5.0, target=(0, 0, 6.0))
    stages = [dict(_exact_stages(full, gt.make_uniforms(c, cfg), cfg,
                                 capacity)) for c in cams]
    inputs = [s["Projection"](None) for s in stages]
    if plain_plan:
        tag += " plain plan"
    with plan_dispatch(plain=plain_plan):
        stages[0]["Sort"](inputs[0])                        # warm-up
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for s, x in zip(stages, inputs):
                s["Sort"](x)
            torch.cuda.synchronize()
    kern: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = kern.get(e.name[:110], (0, 0.0))
            kern[e.name[:110]] = (n + 1, t + e.time_range.elapsed_us())
    busy = sum(t for _, t in kern.values())
    ops = [(a.key, a.count, a.self_device_time_total)
           for a in prof.key_averages() if a.key.startswith("aten::")
           and a.self_device_time_total > 0]

    def top(items, k):
        return {n: [round(c / frames, 2), round(t / 1e3 / frames, 4)]
                for n, c, t in sorted(items, key=lambda x: -x[2])[:k]}

    log(f"[{tag} Sort profile] {frames} eager Sort stages: "
        f"{busy / 1e3 / frames:.3f} device ms a stage in "
        f"{sum(c for c, _ in kern.values()) / frames:.0f} device "
        f"activities; top [launches, device ms] a stage "
        f"{json.dumps(top([(n, c, t) for n, (c, t) in kern.items()], 16))}")
    log(f"[{tag} Sort profile] aten ops by self device ms, [calls, ms] a "
        f"stage {json.dumps(top(ops, 12))}")


# --- the Blocks stage's kernels ----------------------------------------------

@contextlib.contextmanager
def _dispatch(targets, plain: bool, calls: list | None):
    """Inside the block, each (module, attribute, plain version, kind) of
    ``targets`` is replaced: with ``plain``, by its plain version; with
    ``calls``, each call's (kind, args, kwargs) is appended to it. A graph
    captured inside the block keeps what it captured."""
    saved = [getattr(m, a) for m, a, _, _ in targets]

    def recorded(kind, fn):
        def call(*a, **kw):
            if calls is not None:
                calls.append((kind, a, kw))
            return fn(*a, **kw)
        return call

    for (m, a, ref, kind), fn in zip(targets, saved):
        setattr(m, a, recorded(kind, ref if plain else fn))
    try:
        yield
    finally:
        for (m, a, _, _), fn in zip(targets, saved):
            setattr(m, a, fn)


# The Blocks stage's kernels by the kind its calls are recorded as: (the
# dispatcher's name, the kernel's wrapper, the plain version).
BLOCK_KINDS = {
    "frame": ("_frame_from_stage1", b2._frame_from_stage1_cuda,
              b2.frame_from_stage1_reference),
    "window": ("big_window", b2._big_window_cuda, b2.big_window_reference),
    "pack": ("screen_pack", b2._screen_pack_cuda, b2.screen_pack_reference),
    "sort": ("screen_sort", b2._screen_sort_cuda, b2.screen_sort_reference),
    "bigset": ("big_set", b2._big_set_cuda, b2.big_set_reference),
}


def blocks_dispatch(plain: bool = False, calls: list | None = None):
    """The Blocks stage's five dispatchers (``blocks2._frame_from_stage1``,
    ``big_window``, ``screen_pack``, ``screen_sort`` and ``big_set``)
    replaced inside a block (``_dispatch``): with ``plain``, the Blocks
    stage as it ran before its kernels; calls recorded by their kind in
    ``BLOCK_KINDS``."""
    return _dispatch(tuple((b2, name, ref, kind) for kind, (name, _, ref)
                           in BLOCK_KINDS.items()), plain, calls)


def _outputs_differ(prefix: str, a, b) -> dict:
    """{prefix.field: entries that differ} of two outputs (NamedTuples or
    tuples of tensors), f32 compared as bits."""
    names = getattr(a, "_fields", None) or [str(i) for i in range(len(a))]
    return {f"{prefix}.{n}": _differ(x, y) for n, x, y in zip(names, a, b)}


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of ``a`` and ``b`` that differ (f32 compared as bits); -1
    for other shapes or types."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def blocks_vs_plain(tag: str, cloud, cfg) -> dict:
    """The Blocks stage on the reset camera's projection, through its
    kernels and through their plain versions: every BlockFrame2 and BigSet
    field bit-equal (f32 as bits), and each kernel the stage called
    bit-equal to its plain version on the arguments the stage passed it
    (recorded). Both stages timed. Returns {kind: (args, kwargs, the
    kernel's output)} and the kernels' big set."""
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device)
    st = dict(_frame_stages(cloud, uni, cfg))
    prj = st["Projection"](None)
    calls: list = []
    with blocks_dispatch(calls=calls):
        bf_k, big_k = st["Blocks"](prj)
    with blocks_dispatch(plain=True):
        bf_r, big_r = st["Blocks"](prj)
    torch.cuda.synchronize()
    want = {"frame", "window", "bigset"}
    want |= {"pack"} if not cfg.projection_kernel else set()
    want |= {"sort"} if cfg.cluster == "screen" else set()
    kinds = sorted(c[0] for c in calls)
    check(kinds == sorted(want), f"{tag}: the stage called {kinds}")
    found = {kind: (a, kw) for kind, a, kw in calls}
    bad = _outputs_differ("frame", bf_k, bf_r)
    bad.update(_outputs_differ("bigs", big_k, big_r))
    run = {}
    for kind, (a, kw) in found.items():
        _, kernel, plain = BLOCK_KINDS[kind]
        out_k, out_r = kernel(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        bad.update(_outputs_differ(BLOCK_KINDS[kind][0].strip("_"), out_k,
                                   out_r))
        run[kind] = (a, kw, out_k)
    kern_ms = time_ms(lambda: st["Blocks"](prj), 5)
    with blocks_dispatch(plain=True):
        plain_ms = time_ms(lambda: st["Blocks"](prj), 3)
    fa, fkw, fk = run["frame"]
    B = fa[1]
    big_cap = big_k.valid.shape[0]
    R, CW = run["window"][0][0].shape
    if bad["frame_from_stage1.payload"]:
        fr = b2.frame_from_stage1_reference(*fa, **fkw)
        a, b = fk.payload, fr.payload
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        at = torch.nonzero(a != b)
        rows = torch.bincount(at[:, 1], minlength=a.shape[1]).tolist()
        first = [(tuple(ix), hex(int(a[tuple(ix)]) & 0xFFFFFFFF),
                  hex(int(b[tuple(ix)]) & 0xFFFFFFFF),
                  int(fk.num_valid[ix[0]])) for ix in at[:8].tolist()]
        log(f"[{tag}] payload entries not bit-equal by row {rows}; first "
            f"(brick, row, lane), kernel, plain, brick's count: {first}")
    log(f"[{tag}] {cloud.num_splats} splats, tile {cfg.tile_size}, cluster "
        f"{cfg.cluster}, {'words' if fkw['words'] else 'cooked'} payload, "
        f"taken mask fused {fkw.get('taken') is not None}: kernels "
        f"{kinds}; {B} bricks ({int(bf_k.num_valid.sum())} lanes valid, "
        f"{int((bf_k.num_valid == 0).sum())} bricks empty), window "
        f"({R}, {CW}) KC {run['window'][0][1]}, big lanes "
        f"{int(big_k.valid.sum())} of {big_cap} (residual "
        f"{int(big_k.residual)}); entries not bit-equal "
        f"{json.dumps({k: v for k, v in bad.items() if v})}; the stage, "
        f"eager: kernels {kern_ms:.4f} ms, plain versions {plain_ms:.4f} ms")
    check(not any(bad.values()), f"{tag}: not bit-equal: {bad}")
    return {**run, "big_k": big_k}


def block_frame_record(name: str, run: dict) -> dict:
    """The brick build on the arguments its stage passed it, timed beside
    its plain version and its byte bound."""
    fa, fkw, fk = run["frame"]
    ms = time_graphed_ms(lambda: b2._frame_from_stage1_cuda(*fa, **fkw), 20)
    plain_ms = time_ms(lambda: b2.frame_from_stage1_reference(*fa, **fkw), 3)
    taken = fkw.get("taken")
    n_bytes = (nbytes(*fa[0]) + (nbytes(taken) if taken is not None else 0)
               + nbytes(*fk[:6]))
    bnd = bound(n_bytes, 0, None)
    log(f"[6 {name} 1080p] {fa[1]} bricks: kernel {ms:.4f} ms (graph "
        f"replays of 20 launches), plain "
        f"{plain_ms:.4f} ms, {n_bytes / 1e6:.1f} MB moved, {bound_text(bnd)}")
    return record(name, 0.0, ms, plain_ms, bnd)


def big_lanes_record(run: dict) -> dict:
    """The big-lane window on its stage's chunk keys, timed beside its
    plain version, the one torch call that computes it, and its byte
    bound; and the global stable sort of the window with int32 keys
    against the same keys as int64."""
    (bkey, KC), _, wk = run["window"]
    ms = time_graphed_ms(lambda: b2._big_window_cuda(bkey, KC), 20)
    eager_ms = time_ms(lambda: b2._big_window_cuda(bkey, KC), 20)
    plain_ms = time_ms(lambda: b2.big_window_reference(bkey, KC), 5)
    lib_ms = time_ms(lambda: torch.sort(u32(bkey), dim=1).values[:, :KC], 5)
    gk = wk[1].reshape(-1)
    t32 = time_ms(lambda: torch.sort(gk, stable=True), 5)
    wide = gk.to(torch.int64)
    t64 = time_ms(lambda: torch.sort(wide, stable=True), 5)
    bnd = bound(nbytes(bkey) + nbytes(*wk), 0, None)
    R, CW = bkey.shape
    log(f"[6 big_lanes 1080p] ({R}, {CW}) keys, KC {KC}: kernel {ms:.4f} "
        f"ms (launched eagerly back to back: {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, library (torch.sort of the u32 rows, "
        f"first KC) {lib_ms:.4f} ms, {bound_text(bnd)}; the global stable "
        f"sort of the {gk.numel()}-entry window: int32 keys {t32:.4f} ms, "
        f"the same keys as int64 {t64:.4f} ms")
    rec = record("big_lanes", 0.0, ms, plain_ms, bnd)
    rec["library_ms"] = lib_ms
    return rec


def screen_pack_record(run: dict) -> dict:
    """The readable projection's pack on the arguments its stage passed
    it, timed beside its plain version and its byte bound."""
    a, kw, out = run["pack"]
    ms = time_graphed_ms(lambda: b2._screen_pack_cuda(*a, **kw), 20)
    plain_ms = time_ms(lambda: b2.screen_pack_reference(*a, **kw), 3)
    prj = a[0]
    n_bytes = nbytes(prj.valid, prj.depth16, prj.image_pos, prj.conic,
                     prj.color) + nbytes(*out)
    bnd = bound(n_bytes, 0, None)
    log(f"[6 screen_pack 1080p] {prj.valid.shape[0]} splats, cell "
        f"{a[1]}, chunks of {a[2]}: kernel {ms:.4f} ms (graph replays of 20"
        f" launches), plain {plain_ms:.4f} ms, {n_bytes / 1e6:.1f} MB moved,"
        f" {bound_text(bnd)}; big splats {int(out.num_big)}")
    return record("screen_pack", 0.0, ms, plain_ms, bnd)


def _sort_and_gather(key, words, idx):
    """torch's stable row sort of the u32 keys and the seven gathers of
    the rows (key, five words, source positions): the screen clustering's
    sort before its kernel, the taken mask's where left out."""
    order = torch.sort(u32(key), dim=1, stable=True).indices
    return tuple(torch.gather(a, 1, order) for a in (key, *words, idx))


def screen_sort_record(run: dict) -> dict:
    """The row sort on the arguments its stage passed it, timed beside its
    plain version, the torch sort and gathers it replaced, and its byte
    bound."""
    a, kw, out = run["sort"]
    ms = time_graphed_ms(lambda: b2._screen_sort_cuda(*a, **kw), 20)
    plain_ms = time_ms(lambda: b2.screen_sort_reference(*a, **kw), 3)
    key, taken, words = a
    idx = torch.arange(key.numel(), dtype=torch.int32,
                       device=key.device).reshape(key.shape)
    lib_ms = time_ms(lambda: _sort_and_gather(key, words, idx), 5)
    n_bytes = nbytes(key, taken, *words) + nbytes(*out)
    bnd = bound(n_bytes, 0, None)
    log(f"[6 screen_sort 1080p] {tuple(key.shape)} rows: kernel {ms:.4f} ms"
        f" (graph replays of 20 launches), plain {plain_ms:.4f} ms, library"
        f" (torch.sort of the u32 rows and seven torch.gather) {lib_ms:.4f}"
        f" ms, {n_bytes / 1e6:.1f} MB moved, {bound_text(bnd)}")
    rec = record("screen_sort", 0.0, ms, plain_ms, bnd)
    rec["library_ms"] = lib_ms
    return rec


def big_set_record(run: dict) -> dict:
    """The big set on the arguments its stage passed it, timed beside its
    plain version, its byte bound, an empty kernel of its grid (the
    launch's floor) and the bound of the 32-byte sectors its scattered
    word reads move."""
    a, kw, out = run["bigset"]
    ms = time_graphed_ms(lambda: b2._big_set_cuda(*a, **kw), 20)
    lib = kernels.library("big_set")
    N = a[1].shape[0]
    empty_ms = time_graphed_ms(lambda: kernels.check(lib.gs_big_set_empty(
        N, kernels.stream_ptr(a[1].device)), "big_set empty launch"), 20)
    plain_ms = time_ms(lambda: b2.big_set_reference(*a, **kw), 3)
    words, tk_idx, tk_ok = a[:3]
    written = nbytes(out.table, out.rect, out.depth16)
    n_bytes = nbytes(tk_idx, tk_ok) + N * 4 * len(words) + written
    bnd = bound(n_bytes, 0, None)
    # every lane reads its six words (a pad lane splat 0's): each distinct
    # 8-word run of a word array is one 32-byte sector
    sectors = int(torch.unique(tk_idx // 8).numel()) * len(words)
    sector_bytes = nbytes(tk_idx, tk_ok) + sectors * 32 + written
    sector_ms = sector_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[6 big_set 1080p] {N} lanes ({int(tk_ok.sum())} valid): kernel "
        f"{ms:.4f} ms (graph replays of 20 launches), an empty kernel of "
        f"its grid {empty_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{bound_text(bnd)}; the scattered reads move {sectors} sectors "
        f"({sector_bytes / 1e6:.2f} MB in all: {sector_ms:.4f} ms)")
    rec = record("big_set", 0.0, ms, plain_ms, bnd)
    rec.update(empty_ms=empty_ms, sector_bound_ms=sector_ms)
    return rec


def sort_ties_vs_plain(run: dict) -> None:
    """screen_sort on its stage's rows with the keys cut to a few values
    (most of them tied, the sentinel among them) and with a third of the
    lanes taken: bit-equal to the plain version."""
    (key, taken, words), _, _ = run["sort"]
    g = torch.Generator(device="cuda").manual_seed(16)
    ties = torch.where(key == -1, key, key & 0x00030003)
    more = taken | (torch.rand(key.shape, generator=g, device="cuda") < 0.3)
    for tag, k, t in (("tie-heavy keys", ties, taken),
                      ("a third taken", key, more)):
        bad = [_differ(x, y) for x, y in zip(
            b2._screen_sort_cuda(k, t, words),
            b2.screen_sort_reference(k, t, words))]
        check(not any(bad), f"6 screen_sort {tag}: entries not bit-equal "
              f"{bad}")
    log(f"[6 screen_sort 1080p] {tuple(key.shape)} rows with the keys cut "
        f"to key & 0x00030003 and with a third of the lanes taken: "
        f"bit-equal to the plain version")


def passes_a_row(key: torch.Tensor, taken: torch.Tensor) -> dict:
    """{radix passes: rows} of screen_sort's narrowing on (SB, n) rows: a
    row's live keys (not taken, not 0xFFFFFFFF) span b = bit_length(hi -
    lo + 1) bits, or fewer with the key's halves narrowed apart (b =
    bit_length(top + 1), top = (hh - hl) << db | (dh - dl), db =
    bit_length(dh - dl)); sorted in ceil(b / 8) passes (0 for a row with
    no live key). "whole keys only": the first rule alone; the parent
    design ran four passes on every row."""
    u = torch.where(taken, -1, key).to(torch.int64) & 0xFFFFFFFF
    live = u != 0xFFFFFFFF
    powers = torch.ones(33, dtype=torch.int64, device=u.device) << \
        torch.arange(33, device=u.device)

    def bit_length(x):
        return (torch.clamp(x, min=0)[:, None] >= powers).sum(1)

    def rng(x, cap):
        return (torch.where(live, x, cap).amin(dim=1),
                torch.where(live, x, -1).amax(dim=1))

    lo, hi = rng(u, 1 << 32)
    whole = bit_length(hi - lo + 1)
    (hl, hh), (dl, dh) = rng(u >> 16, 1 << 16), rng(u & 0xFFFF, 1 << 16)
    db = bit_length(dh - dl)
    top = ((hh - hl) << db) | (dh - dl)
    bits = torch.where(live.any(1), torch.minimum(bit_length(top + 1),
                                                  whole), 0)

    def count(b):
        return {str(p): int(((b + 7) // 8 == p).sum()) for p in range(5)}

    return {"passes": count(bits), "whole keys only": count(whole)}


def _narrow_row(kind: str, n: int, g) -> tuple:
    """One row on the card for screen_sort_edge_cases: no live key, one
    live key, every live key equal, live keys whose span hi - lo is
    exactly 2^b - 2 or 2^b - 1 ("span b", "span b+"), a tenth dead, or
    three cells whose depths span 8 bits ("halves")."""
    dead = torch.rand(n, generator=g, device="cuda") < 0.1
    if kind == "none":
        return torch.full((n,), -1, dtype=torch.int64, device="cuda"), dead
    if kind == "one":
        key = torch.full((n,), -1, dtype=torch.int64, device="cuda")
        key[n // 3] = 12345
        return key, torch.zeros(n, dtype=torch.bool, device="cuda")
    if kind == "equal":
        return torch.where(dead, -1, 0x00AB0CD0).to(torch.int64), dead
    if kind == "halves":      # three cells, depths over 8 bits: 2 passes
        cell = torch.tensor([0x10, 0x20, 0x90], device="cuda")[
            torch.randint(0, 3, (n,), generator=g, device="cuda")]
        key = (cell << 16) | torch.randint(100, 301, (n,), generator=g,
                                           device="cuda")
        key[0], key[1] = (0x10 << 16) | 100, (0x90 << 16) | 300
        dead[:2] = False
        return key, dead
    b = int(kind.split()[1].rstrip("+"))
    span = (1 << b) - (1 if kind.endswith("+") else 2)
    lo = 0x40000000 if b < 31 else 0
    key = lo + torch.randint(0, span + 1, (n,), generator=g, device="cuda")
    key[0], key[1] = lo, lo + span
    dead[:2] = False
    key[1::97] = lo + span
    key = torch.where(torch.rand(n, generator=g, device="cuda") < 0.1,
                      0xFFFFFFFF, key)
    key[0], key[1] = lo, lo + span
    return key, dead


NARROW_ROWS = ("none", "one", "equal", "span 8", "span 8+", "span 16",
               "span 16+", "span 24", "span 24+", "span 31", "span 31+",
               "halves")


def screen_sort_edge_cases() -> None:
    """screen_sort on rows of every pass count (NARROW_ROWS: 0 to 4
    passes, each span at its boundary), as full rows of 8192 and short
    rows of 1000, bit-equal to its plain version."""
    g = torch.Generator(device="cuda").manual_seed(161)
    for n in (8192, 1000):
        rows = [_narrow_row(k, n, g) for k in NARROW_ROWS]
        key = b2.i32(torch.stack([r[0] for r in rows]))
        taken = torch.stack([r[1] for r in rows])
        words = tuple(torch.randint(-2**31, 2**31, key.shape, generator=g,
                                    device="cuda", dtype=torch.int64)
                      .to(torch.int32) for _ in range(5))
        bad = [_differ(x, y) for x, y in zip(
            b2._screen_sort_cuda(key, taken, words),
            b2.screen_sort_reference(key, taken, words))]
        check(not any(bad), f"6 screen_sort rows of every pass count, n "
              f"{n}: entries not bit-equal {bad}")
        log(f"[6 screen_sort edge] {len(NARROW_ROWS)} rows of {n} "
            f"({', '.join(NARROW_ROWS)}): passes a row "
            f"{json.dumps(passes_a_row(key, taken))}; bit-equal to the "
            f"plain version")


def dense_window_keys(R: int, CW: int, seed: int) -> torch.Tensor:
    """(R, CW) int32 chunk keys on the card whose rows hold from 0 to CW
    big candidates (evenly spread), at random columns, with depths from a
    narrow range (many equal depths)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    counts = torch.linspace(0, CW, R, device="cuda").round().to(torch.int64)
    place = torch.argsort(torch.rand(R, CW, generator=g, device="cuda"),
                          dim=1).argsort(dim=1)
    depth = torch.randint(40000, 40040, (R, CW), generator=g, device="cuda")
    col = torch.arange(CW, device="cuda")
    keys = torch.where(place < counts[:, None], (depth << 10) | col,
                       b2.U32_MAX)
    return b2.i32(keys)


def window_dense_vs_plain() -> None:
    """big_lanes against its plain version on rows of every fill, from
    none to all CW keys live (both of the kernel's ways: a count of the
    keys below each, and the bitonic sort past 256 live keys)."""
    for R, CW, seed in ((64, 1024, 5), (33, 512, 6), (9, 128, 7)):
        bkey = dense_window_keys(R, CW, seed)
        for KC in sorted({CW // 4, CW}):
            k = b2._big_window_cuda(bkey, KC)
            r = b2.big_window_reference(bkey, KC)
            bad = [_differ(a, b) for a, b in zip(k, r)]
            check(not any(bad), f"6 big_lanes dense ({R}, {CW}) KC {KC}: "
                  f"pos_w, gk entries not bit-equal {bad}")
    log("[6 big_lanes dense] rows of 0 to CW live keys, (64, 1024), "
        "(33, 512), (9, 128) at KC CW/4 and CW: bit-equal to the plain "
        "version")


def phase_blocks(cloud, base) -> list:
    """Phase 6, the Blocks stage's kernels: block_frame (words and cooked),
    big_lanes, screen_pack, screen_sort and big_set held bit-equal to their
    plain versions on the 1080p frames' inputs of the four clusterings and
    payloads (fused projection and static bricks with the taken mask
    fused, words and cooked; screen clustering, words and cooked), and on a
    16,384-splat scene at 384x320 whose big-lane capacity exceeds its
    candidates (4,096: entries past the candidates point at splat 0, not
    ok) and its window (20,480: pad entries); screen_sort also on
    tie-heavy keys; each kernel timed on the shipped (words), v4 (cooked)
    or quality="fast" frame's arguments. Returns the six records."""
    runs = {}
    for tag, cfg in (
            ("shipped", base.fast_defaults()),
            ("v4", base.replace(kernel="v4").fast_defaults()),
            ("quality=fast", base.replace(quality="fast")),
            ("screen words", base.fast_defaults().replace(cluster="screen"))):
        runs[tag] = blocks_vs_plain(f"6 blocks {tag} 1080p", cloud, cfg)
    small = gt.mortonize(gt.synthetic_scene(16384, seed=9, extent=3.0,
                                            scale_range=(0.01, 0.25)))
    small_cfg = gt.RasterizerConfig(width=384, height=320)
    for cfg, cap in ((small_cfg.fast_defaults(), 4096),
                     (small_cfg.replace(quality="fast"), 20480)):
        run = blocks_vs_plain(f"6 blocks padded big lanes, big_cap {cap}",
                              small, cfg.replace(big_capacity=cap))
        check(0 < int(run["big_k"].valid.sum()) < cap - 100,
              f"6 blocks padded: {int(run['big_k'].valid.sum())} big lanes "
              f"of {cap}: no entries past the candidates")
    window_dense_vs_plain()
    sort_ties_vs_plain(runs["quality=fast"])
    (key, taken, _), _, _ = runs["quality=fast"]["sort"]
    log(f"[6 screen_sort 1080p] {tuple(key.shape)} rows, radix passes a "
        f"row: {json.dumps(passes_a_row(key, taken))}")
    screen_sort_edge_cases()
    return [block_frame_record("block_frame", runs["shipped"]),
            block_frame_record("block_frame_cooked", runs["v4"]),
            big_lanes_record(runs["shipped"]),
            screen_pack_record(runs["quality=fast"]),
            screen_sort_record(runs["quality=fast"]),
            big_set_record(runs["quality=fast"])]


# --- the Binning stage's kernels ---------------------------------------------

def binning_dispatch(plain: bool = False, calls: list | None = None):
    """The Binning stage's two kernel paths (``binning2._bin_blocks2_cuda``
    and ``bigbin._bin_bigs_cuda``, which its dispatchers call for CUDA
    tensors) replaced inside a block (``_dispatch``): with ``plain``, the
    Binning stage as it ran before its kernels; calls recorded as kind
    "blocks" or "bigs"."""
    return _dispatch(
        ((bn, "_bin_blocks2_cuda", bn.bin_blocks2_reference, "blocks"),
         (bb, "_bin_bigs_cuda", bb.bin_bigs_reference, "bigs")), plain, calls)


def _bins_differ(prefix: str, k, r) -> dict:
    return {f"{prefix}.{f}": _differ(a, b)
            for f, a, b in zip(k._fields, k, r)}


def binning_vs_plain(tag: str, cloud, cfg) -> dict:
    """The Binning stage on the reset camera's block frame and big set,
    through its kernels and through their plain versions: every TileBins2
    and TileBigs field bit-equal (f32 as bits); both stages timed eagerly.
    Returns the stage's input, its recorded calls and the kernels'
    outputs."""
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device)
    st = dict(_frame_stages(cloud, uni, cfg))
    frame = st["Blocks"](st["Projection"](None))
    calls: list = []
    with binning_dispatch(calls=calls):
        _, bins_k, bigs_k = st["Binning"](frame)
    with binning_dispatch(plain=True):
        _, bins_r, bigs_r = st["Binning"](frame)
    torch.cuda.synchronize()
    check(sorted(c[0] for c in calls) == ["bigs", "blocks"],
          f"{tag}: the stage called {[c[0] for c in calls]}")
    bad = {**_bins_differ("bins", bins_k, bins_r),
           **_bins_differ("bigs", bigs_k, bigs_r)}
    kern_ms = time_ms(lambda: st["Binning"](frame), 5)
    with binning_dispatch(plain=True):
        plain_ms = time_ms(lambda: st["Binning"](frame), 3)
    gx, gy = cfg.tile_dims
    log(f"[{tag}] tile {cfg.tile_size} ({gx} x {gy} tiles), "
        f"{frame[0].rect.shape[0]} bricks, {int(frame[1].valid.sum())} of "
        f"{frame[1].valid.shape[0]} big lanes valid: tile lists max "
        f"{int(bins_k.tile_nblocks.max())} blocks, "
        f"{int(bigs_k.tile_nbig.max())} big lanes; overflow "
        f"{int(bins_k.overflow)} + {int(bigs_k.overflow)}; entries not "
        f"bit-equal {json.dumps({k: v for k, v in bad.items() if v})}; the "
        f"stage, eager: kernels {kern_ms:.4f} ms, plain versions "
        f"{plain_ms:.4f} ms")
    check(not any(bad.values()), f"{tag}: not bit-equal: {bad}")
    return {"frame": frame, "cfg": cfg, "bins": bins_k, "bigs": bigs_k,
            "calls": {kind: (a, kw) for kind, a, kw in calls}}


def binning_case(tag: str, frame, cfg, blocks_kw: dict,
                 bigs_kw: dict) -> tuple:
    """Both kernels against their plain versions on one block frame and
    big set at the given caps and row offset: every field bit-equal.
    Returns the kernels' TileBins2 and TileBigs."""
    bf, bigs = frame
    kb = bn._bin_blocks2_cuda(bf, cfg, **blocks_kw)
    kg = bb._bin_bigs_cuda(bigs, cfg, **bigs_kw)
    rb = bn.bin_blocks2_reference(bf, cfg, **blocks_kw)
    rg = bb.bin_bigs_reference(bigs, cfg, **bigs_kw)
    torch.cuda.synchronize()
    bad = {**_bins_differ("bins", kb, rb), **_bins_differ("bigs", kg, rg)}
    log(f"[{tag}] {cfg.tile_dims[0]} x {cfg.tile_dims[1]} tiles, blocks "
        f"{json.dumps(blocks_kw)}, bigs {json.dumps(bigs_kw)}: tile lists "
        f"max {int(kb.tile_nblocks.max())} blocks, {int(kg.tile_nbig.max())}"
        f" big lanes; overflow {int(kb.overflow)} + {int(kg.overflow)}; "
        f"entries not bit-equal "
        f"{json.dumps({k: v for k, v in bad.items() if v})}")
    check(not any(bad.values()), f"{tag}: not bit-equal: {bad}")
    return kb, kg


def kernel_split(fn, calls: int = 3) -> dict:
    """torch.profiler over ``calls`` eager calls of ``fn`` (after a warm-up
    call): {device kernel or memset: [launches a call, device ms a
    call]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = split.get(e.name[:60], (0, 0.0))
            split[e.name[:60]] = (n + 1, t + e.time_range.elapsed_us())
    return {k: [n / calls, round(t / 1e3 / calls, 4)]
            for k, (n, t) in split.items()}


def rank_vs_sort(bf) -> tuple:
    """bin_blocks' stable ranking alone on the block frame's int32 depth
    keys, bit-equal to torch.sort(stable=True).indices, and both timed as
    graph replays: (rank ms, torch.sort ms)."""
    key = (bf.min_depth - 32768) * 65536 + (bf.max_depth & 0xFFFF)
    got = bn._rank_keys_cuda(key)
    want = torch.sort(key, stable=True).indices
    check(torch.equal(got.long(), want),
          "6 bin_blocks: the ranking differs from torch.sort(stable=True)")
    return (time_graphed_ms(lambda: bn._rank_keys_cuda(key), 20),
            time_graphed_ms(lambda: torch.sort(key, stable=True), 20))


def bin_record(name: str, tag: str, run: dict) -> dict:
    """One binning kernel on the arguments its stage passed it, timed as
    graph replays beside its plain version and its byte bound, with its
    device kernels a call; bin_blocks also its ranking alone beside
    torch.sort(stable=True) of the same keys (its library_ms)."""
    a, kw = run["calls"]["blocks" if name == "bin_blocks" else "bigs"]
    library_ms = None
    if name == "bin_blocks":
        kern, plain = bn._bin_blocks2_cuda, bn.bin_blocks2_reference
        bf, bins = a[0], run["bins"]
        listed = torch.unique(bins.tile_blocks[bins.tile_blocks >= 0]).numel()
        n_bytes = (nbytes(bf.rect, bf.min_depth, bf.max_depth)
                   + listed * 8 + nbytes(*bins))
        rank_ms, library_ms = rank_vs_sort(bf)
        extra = (f"; its stable ranking of the {bf.min_depth.numel()} int32 "
                 f"depth keys alone {rank_ms:.4f} ms, torch.sort(stable="
                 f"True) of them {library_ms:.4f} ms")
    else:
        kern, plain = bb._bin_bigs_cuda, bb.bin_bigs_reference
        bigs, tbig = a[0], run["bigs"]
        n_valid = int(bigs.valid.sum())
        ob = tbig.bigpay.shape[2]
        live = (torch.arange(ob, device=tbig.bigpay.device)[None]
                < tbig.tile_nbig[:, None])                    # (T, OB)
        cols = tbig.bigpay.view(torch.int32).transpose(1, 2)[live]
        kept = torch.unique(cols, dim=0).shape[0]   # distinct table rows
        n_bytes = (nbytes(bigs.valid) + n_valid * 16 + kept * 64
                   + nbytes(*tbig))
        extra = (f"; {n_valid} of {bigs.valid.numel()} lanes valid, {kept} "
                 f"kept in a tile, OB {ob}")
    ms = time_graphed_ms(lambda: kern(*a, **kw), 20)
    eager_ms = time_ms(lambda: kern(*a, **kw), 20)
    plain_ms = time_ms(lambda: plain(*a, **kw), 3)
    split = kernel_split(lambda: kern(*a, **kw))
    bnd = bound(n_bytes, 0, None)
    log(f"[6 {name} {tag}] kernel {ms:.4f} ms (graph replays of 20 calls; "
        f"eagerly back to back {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"{n_bytes / 1e6:.1f} MB moved, {bound_text(bnd)}{extra}; device "
        f"kernels a call [launches, ms] {json.dumps(split)}")
    rec = record(name, 0.0, ms, plain_ms, bnd)
    rec["library_ms"] = library_ms
    # each of the wrapper's kernels launches once a call; the profiler can
    # drop events in a long run, so its distinct kernels count them
    rec["launches_a_call"] = len(split)
    if name == "bin_blocks":
        rec["rank_ms"] = rank_ms
    return rec


def phase_binning(cloud, base) -> list:
    """Phase 6, the Binning stage's kernels: bin_blocks and bin_bigs held
    bit-equal to their plain versions on the 1080p frames' block frames
    and big sets of fast_defaults(), its v4, quality="fast" (tile 16) and
    fast_defaults() with the screen clustering (words); on the shipped
    frame's inputs binned as the second slab of two (sharded._slab_rows:
    a non-zero tile_row_offset); and at caps where C1, C2 and OB all drop
    entries (both overflows > 0, and above the first level's alone). Each
    kernel timed on the shipped frame's arguments (and logged on
    quality="fast"'s). Returns the two records."""
    runs = {}
    for tag, cfg in (
            ("shipped", base.fast_defaults()),
            ("v4", base.replace(kernel="v4").fast_defaults()),
            ("quality=fast", base.replace(quality="fast")),
            ("screen words", base.fast_defaults().replace(cluster="screen"))):
        runs[tag] = binning_vs_plain(f"6 binning {tag} 1080p", cloud, cfg)
    shipped = runs["shipped"]
    cfg, frame = shipped["cfg"], shipped["frame"]
    for tag, run in runs.items():
        ob = run["bigs"].bigpay.shape[2]
        check(ob % 4 == 0, f"6 binning {tag}: OB {ob} is no multiple of 4: "
              "bin_bigs' 16-byte payload stores would not run")
    rows = sharded._slab_rows(cfg, 2)
    binning_case(f"6 binning slab 2 of 2 (tile_row_offset {rows})", frame,
                 sharded._slab_cfg(cfg, rows), {"tile_row_offset": rows},
                 {"tile_row_offset": rows})
    bf, bigs = frame
    tied = bf._replace(min_depth=bf.min_depth & 0xF000,
                       max_depth=bf.max_depth & 0x3)
    check(torch.unique(tied.min_depth * 4 + tied.max_depth).numel() <= 64,
          "6 binning tie-heavy: more than 64 distinct depth keys")
    binning_case("6 binning tie-heavy depth keys (min16 & 0xF000, max16 & 3)",
                 (tied, bigs), cfg, {}, {})
    kb, kg = binning_case("6 binning every cap biting", frame, cfg,
                          {"supertile_cap": 64, "tile_cap": 16},
                          {"supertile_cap": 64, "obig": 16})
    lb, lg = binning_case("6 binning the first level's cap alone", frame,
                          cfg, {"supertile_cap": 64, "tile_cap": 64},
                          {"supertile_cap": 64, "obig": 64})
    check(0 < int(lb.overflow) < int(kb.overflow)
          and 0 < int(lg.overflow) < int(kg.overflow),
          f"6 binning caps: overflow {int(kb.overflow)}, {int(kg.overflow)}"
          f" with C1 64 and C2, OB 16; {int(lb.overflow)}, "
          f"{int(lg.overflow)} with C1 alone biting")
    for name in ("bin_blocks", "bin_bigs"):
        bin_record(name, "quality=fast 1080p", runs["quality=fast"])
    return [bin_record(name, "shipped 1080p", shipped)
            for name in ("bin_blocks", "bin_bigs")]


def phase_sfu_probe() -> tuple:
    """Phase 9: the rate probe (python3 -m ...sfu_probe) on the card. The
    launch counter is set to 0 just before the probe's timed runs of every
    body (its main path) and read just after; then sfu_probe.report holds
    every body to its plain version, checks its SASS and rates and times
    its plain version, and SFU["per_s"] is set. Returns (the sfu_probe
    record, its launches)."""
    dev = torch.device("cuda")
    peaks = sp.card_peaks()
    kernels.reset_launch_counts()
    times = sp.probe_times(dev)
    launches = kernels.launch_counts()["sfu_probe"]
    check(launches >= len(sp.BODIES), f"9: sfu_probe launched {launches} "
          f"times for {len(sp.BODIES)} bodies")
    res = sp.report(dev, times, peaks)
    worst = res["worst"]
    log(f"[9 sfu_probe] {sp.peaks_line(peaks)}; every body held to its "
        f"plain version (max |d| "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})})")
    for text in res["lines"]:
        log(f"[9 sfu_probe] {text}")
    measured, spec = res["mufu_per_s"], peaks["mufu_per_s"]
    SFU.update({"per_s": max(measured, spec),
                "from": "phase 9" if measured > spec else "spec peak"})
    log(f"[9 sfu_probe] MUFU instructions per second: measured "
        f"{measured / 1e12:.4f} T/s ({100 * measured / spec:.1f}% of the "
        f"spec peak); the render bounds use {SFU['per_s'] / 1e12:.4f} T/s "
        f"(the {SFU['from']})")
    name = sp.CHAIN.name
    bnd = bound(2 * sp.R * sp.C * 4, sp.ELEM_OPS * PROBE_CHAIN_OPS,
                sp.ELEM_OPS * sp.CHAIN.units)
    log(f"[9 sfu_probe] {name}: kernel {times[name]:.4f} ms, "
        f"{bound_text(bnd)}")
    return (record("sfu_probe", worst[name], times[name],
                   res["plain_ms"][name], bnd), launches)


def _viewer_get(base: str, path: str) -> bytes:
    with urllib.request.urlopen(base + path, timeout=120) as resp:
        return resp.read()


def _viewer_post(base: str, path: str, payload) -> None:
    data = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"10 viewer: POST {path} -> {resp.status}")


def _viewer_wait(what: str, cond, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"10 viewer: timed out on {what}")
        time.sleep(0.05)


def _viewer_settle(state) -> None:
    """Wait until the render loop has paused on idle: no frame is in
    flight, and the last one served showed the current camera and state."""
    _viewer_wait("the idle pause", lambda: state.paused, 120)


def _viewer_drive(base: str, ticks: int) -> list:
    """The browser's traffic for ``ticks`` ticks of 33 ms: free-look fly
    with the mouse, a UI change, an orbit drag with a wheel step, a centre
    pick, one /frame and one /stats a tick. Returns the /frame round trips
    in ms."""
    trips = []
    for i in range(ticks):
        phase = i * 3 // ticks
        if phase == 0:
            body = {"keys": {"w": 1, "d": int(i % 4 == 0)}, "rmb": 1,
                    "dx": 6, "dy": -2}
        elif phase == 1:
            body = {"lmb": 1, "dx": 8, "dy": 1, "wheel": int(i % 7 == 0)}
        else:
            body = {"pick": {"x": 0.5, "y": 0.5}} if i % 5 == 0 else {}
        if i == ticks // 2:
            _viewer_post(base, "/state", {"fov": 70.0, "mscale": 1.1,
                                          "rscale": 1.0, "heatmap": 0,
                                          "pause": 1})
        _viewer_post(base, "/input", body)
        t0 = time.perf_counter()
        png = _viewer_get(base, "/frame")
        trips.append((time.perf_counter() - t0) * 1e3)
        check(png[:8] == b"\x89PNG\r\n\x1a\n", "10 viewer: /frame not a PNG")
        json.loads(_viewer_get(base, "/stats"))
        time.sleep(0.033)
    return trips


def _viewer_served_vs_direct(tag: str, base: str, state) -> str:
    """The served frame (read back through /frame and read_png) against a
    direct rasterize + to_uint8 of the viewer's camera: equal."""
    path = BUILD / "served.png"
    path.write_bytes(_viewer_get(base, "/frame"))
    served = read_png(path)
    with state.render_lock:
        r = state.r
        r.camera = dataclasses.replace(state.ctl.camera, fov_y=state.fov)
        r.update_camera_matrices()
        r.rasterize(sync=True)
        direct = to_uint8(r.image())
        del r
    check(served.shape == direct.shape,
          f"{tag}: served {served.shape}, direct {direct.shape}")
    diff = np.abs(served.astype(np.int32) - direct.astype(np.int32))
    check(np.array_equal(served, direct),
          f"{tag}: served frame differs from the direct render in "
          f"{int((diff > 0).sum())} values, by up to {int(diff.max())}")
    return "served frame equal to the direct render"


def _viewer_split(state) -> str:
    split = np.median(np.asarray(state.frame_ms), axis=0)
    return (f"median split of the last {len(state.frame_ms)} served frames: "
            f"rasterize {split[0]:.3f} ms, image() readback {split[1]:.3f} "
            f"ms, PNG encode {split[2]:.3f} ms")


def _encode_split(state) -> str:
    """The PNG encode of the last frame, timed in its two parts: to_uint8
    (the sRGB transfer and the cast) and the PNG bytes (row filter bytes,
    zlib level 1, CRCs)."""
    with state.render_lock:
        img = state.r.image()
    rgb8, u8_ms = time_host(lambda: to_uint8(img))
    png, png_ms = time_host(lambda: vserver.encode_jpeg_fallback_png(img))
    _, zlib_ms = time_host(lambda: png_bytes(rgb8, 1))
    check(png == png_bytes(rgb8, 1), "10 viewer: PNG bytes differ")
    return (f"one encode of the served image on the host, alone: "
            f"{png_ms:.1f} ms, of which to_uint8 {u8_ms:.1f} ms and the PNG "
            f"bytes (rows, zlib level 1) {zlib_ms:.1f} ms")


def phase_viewer(full, card: str) -> None:
    """Phase 10: the viewer (viewer/server.py) on the card, driven over
    HTTP as a browser does; then a .ply POSTed to /load and render_orbit."""
    t0 = time.perf_counter()
    httpd, state = vserver.make_server(
        gt.Rasterizer(full, texture_size=(1920, 1080), quality="fast"),
        port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _viewer_wait("the first frame", lambda: state.frames > 0, 300)
        log(f"[10 viewer] {card}: server on {base}, Rasterizer(5.8M scene, "
            f"1920x1080, quality fast) set up and first frame served in "
            f"{time.perf_counter() - t0:.1f} s")
        _viewer_settle(state)
        # (a) the browser's traffic; the counters read while no frame is in
        # flight, just before and just after
        frames0 = state.frames
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trips = _viewer_drive(base, 90)
        drive_s = time.perf_counter() - t0
        served = state.frames - frames0
        _viewer_settle(state)
        launches = kernels.launch_counts()
        rendered = state.frames - frames0
        check(rendered >= 5, f"10 viewer: only {rendered} frames served")
        for name in FAST_PATH:
            check(launches[name] == rendered,
                  f"10 viewer: {name} launched {launches[name]} times for "
                  f"{rendered} frames")
        stats = json.loads(_viewer_get(base, "/stats"))
        check(stats["last_error"] is None,
              f"10 viewer: render loop error {stats['last_error']}")
        log(f"[10 viewer] {len(trips)} input ticks of the browser's "
            f"traffic in {drive_s:.2f} s: {served} frames served, "
            f"{served / drive_s:.2f} served frames a second; {rendered} "
            f"frames rendered until the idle pause, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}; "
            f"{_viewer_split(state)}; /frame round trip median "
            f"{statistics.median(trips):.3f} ms (min {min(trips):.3f}, max "
            f"{max(trips):.3f}), {len(state.frame_png)} bytes a frame")
        log(f"[10 viewer] camera {np.round(state.ctl.camera.position, 3)}"
            f", fov {state.fov}: "
            f"{_viewer_served_vs_direct('10 viewer', base, state)}; "
            f"{_encode_split(state)}")
        # (b) a 1M-splat .ply through /load: native swizzle, streamed in
        arrays = synthetic_arrays(1_000_000, seed=7, extent=4.0,
                                  scale_range=(0.004, 0.03), surfaces=True)
        blob = write_ply(io.BytesIO(), *arrays)
        n = arrays[0].shape[0]
        ply, parse_ms = time_host(lambda: PlyFile.parse(blob))
        _, build_ms = time_host(native.load)       # g++ at first use
        native.reset_call_counts()
        soa, native_ms = time_host(lambda: splat_soa_from_ply(ply))
        check(native.call_counts()["swizzle"] == 1,
              "10 viewer: splat_soa_from_ply did not take the native swizzle")

        def numpy_soa():
            m, s, q, o, sh = splat_arrays_from_ply(ply)
            return m, build_covariance(s, q), o, sh

        ref, numpy_ms = time_host(numpy_soa)
        cov_err = float(np.abs(soa[1] - ref[1]).max())
        check(all(np.array_equal(a, b) for a, b in ((soa[0], ref[0]),
                                                     (soa[3], ref[3]))),
              "10 viewer: native and numpy swizzles disagree on means/sh")
        del ply, soa, ref
        # the viewer frees its model before it allocates the new, smaller
        # one: the peak over the load stays at or below the start
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        native.reset_call_counts()
        t0 = time.perf_counter()
        _viewer_post(base, "/load", blob)
        post_s = time.perf_counter() - t0
        _viewer_wait("the streamed load", lambda: (
            state.r.is_loaded and state.r.num_splats_loaded == n), 600)
        load_s = time.perf_counter() - t0
        r = state.r
        check(r.loader.error is None, f"10 viewer: loader {r.loader.error}")
        check(r.cloud.device.type == "cuda" and r.cloud.num_splats == n,
              "10 viewer: the streamed model is not on the card")
        calls = native.call_counts()
        check(calls["swizzle"] >= 1 and calls["morton3"] >= 1,
              f"10 viewer: /load did not go through the native library "
              f"({calls})")
        seconds = dict(r.loader.seconds)
        del r
        mem_peak = torch.cuda.max_memory_allocated()
        check(mem_peak <= mem_before, f"10 viewer: device memory peaked at "
              f"{mem_peak} during the load of the 1M model, above the "
              f"{mem_before} before it (the viewer's 5.8M model was not "
              f"freed first)")
        time.sleep(1.5)                # past the last chunk's fade-in
        # the counters read while no frame is in flight, as in (a): a frame
        # still encoding at the reset would count as served, unlaunched
        _viewer_settle(state)
        frames0 = state.frames
        kernels.reset_launch_counts()
        _viewer_drive(base, 30)
        _viewer_settle(state)
        launches = kernels.launch_counts()
        rendered = state.frames - frames0
        for name in FAST_PATH:
            check(launches[name] == rendered and rendered > 0,
                  f"10 viewer /load: {name} launched {launches[name]} "
                  f"times for {rendered} frames")
        mem_after = torch.cuda.memory_allocated()
        check(mem_after < mem_before, f"10 viewer: device memory "
              f"{mem_after} after the load of the 1M model, {mem_before} "
              f"before (the viewer's 5.8M model was not freed)")
        log(f"[10 viewer /load] {len(blob) / 2**20:.1f} MiB .ply of {n} "
            f"splats, 62 properties: parse {parse_ms:.1f} ms, native library "
            f"loaded (built with g++ if not yet) in {build_ms:.1f} ms, "
            f"swizzle native {native_ms:.1f} ms against numpy "
            f"{numpy_ms:.1f} ms (max |cov "
            f"difference| {cov_err:.3g}); POST /load returned in "
            f"{post_s:.2f} s, loaded on the card in {load_s:.2f} s (loader: "
            f"swizzle {seconds['swizzle']:.3f} s, Morton order "
            f"{seconds['order']:.3f} s, upload {seconds['upload']:.3f} s); "
            f"native calls {json.dumps(calls)}; device memory allocated "
            f"{mem_before / 2**30:.2f} GiB before (the viewer's model and "
            f"this script's 5.8M clouds), peak {mem_peak / 2**30:.2f} GiB "
            f"during the load, {mem_after / 2**30:.2f} GiB after; "
            f"{rendered} frames, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}; "
            f"{_viewer_split(state)}")
        log(f"[10 viewer /load] "
            f"{_viewer_served_vs_direct('10 viewer /load', base, state)}")
        stats = json.loads(_viewer_get(base, "/stats"))
        check(stats["last_error"] is None and state.last_error is None,
              f"10 viewer: render loop error {state.last_error}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        state.close()
        server.join(30)
    # (c) an offline orbit of the loaded model
    out = BUILD / "orbit"
    kernels.reset_launch_counts()
    summary = render_orbit(state.r, str(out), num_frames=8)
    launches = kernels.launch_counts()
    for name in FAST_PATH:
        check(launches[name] == 8, f"10 orbit: {name} launched "
              f"{launches[name]} times for 8 frames")
    pngs = [read_png(out / f"frame_{i:04d}.png") for i in range(8)]
    check(all(p.shape == (1080, 1920, 3) for p in pngs),
          "10 orbit: wrong PNG shape")
    check(len({p.tobytes() for p in pngs}) == 8,
          "10 orbit: two orbit frames are equal")
    log(f"[10 orbit] render_orbit, 8 frames of the loaded model at "
        f"1920x1080 to PNGs: {json.dumps(summary)}, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")


# --- phase 11: the sharded paths (parallel/sharded.py) -----------------------

SHARDED = BUILD / "sharded"
SHARDED_CAMERAS = 8
# (backend, world, meshes): NCCL with one rank on the card; gloo for ranks
# that share it (NCCL refuses two ranks on one GPU). A (1, 2) mesh in the
# 4-rank world leaves ranks 2 and 3 outside.
SHARDED_RUNS = (("nccl", 1, ((1, 1),)),
                ("gloo", 4, ((1, 2), (1, 4), (2, 2))))
SHARDED_FIELDS = ("means", "cov3d", "opacity", "sh", "upload_time")
# Every shard a whole number of 8,192-splat superblocks 1, 2 and 4 ways, so
# the shards cluster as the single device does (the >= 40 dB gate).
SHARDED_MULTIPLE = 8192 * 4
# The paths: the fast frame (fast_defaults()); the exact frame without the
# boundary quirk; and the same with one emission group (no tiers, no giant
# path, no per-splat cap). A slab clips a wide splat's rect, so it may emit
# its pairs in another group than the whole frame does, and pairs of equal
# (tile, depth16) keys then composite in another order (the JAX package's
# sharded path does the same); with one group the order is the splat order
# on both sides.
SHARDED_PATHS = ("fast", "exact", "exact_1group")
FAST_GATE_DB = {1: 50.0}        # world 1; every other mesh: 40 dB
EXACT_GATE = 2e-3               # tests/test_multichip.py:45
# The exact path past world 1 (see above): on an H100 the scene read 77.05
# dB, max |d| 0.0172 at 2 and at 4 ranks; the gate sits 7 dB and 2x below.
EXACT_TIES_GATE = {"psnr": 70.0, "max_abs": 0.035}


def _sharded_cfg(base, path: str):
    if path == "fast":
        return base.fast_defaults()
    cfg = base.replace(reference_boundary_quirk=False)
    if path == "exact_1group":
        gx, gy = cfg.tile_dims
        cfg = cfg.replace(exact_tiers=(), giant_splat_capacity=0,
                          max_tiles_per_splat=gx * gy)
    return cfg


def _padded(cloud, capacity: int):
    """``cloud`` (a fast_cloud_view: planar (48, P) SH) padded with inert
    slots (zeros, opacity 0) to ``capacity``, as from_arrays(capacity=...)
    pads before mortonize."""
    def pad(t):
        return torch.cat([t, t.new_zeros((capacity - t.shape[0],)
                                         + t.shape[1:])])
    return dataclasses.replace(
        cloud, means=pad(cloud.means), cov3d=pad(cloud.cov3d),
        opacity=pad(cloud.opacity), upload_time=pad(cloud.upload_time),
        sh=pad(cloud.sh.T).T.contiguous())


def _mapped_cloud():
    """The scene phase 11 wrote, as CPU tensors on memory-mapped .npy
    files: a rank reads only the pages of the shard it moves to its card."""
    def load(name):
        return torch.from_numpy(np.load(SHARDED / f"{name}.npy",
                                        mmap_mode="c"))
    meta = json.loads((SHARDED / "cloud.json").read_text())
    arrays = {f: load(f) for f in SHARDED_FIELDS}
    arrays["sh"] = arrays["sh"].view(torch.bfloat16)
    return gt.SplatCloud(**arrays, num_splats=meta["num_splats"])


def _sharded_hold(path: str, cam: int, img: torch.Tensor, pairs: int,
                  over: int) -> dict:
    """One view of a sharded frame against the single-device frame phase 11
    saved for its camera."""
    ref = torch.from_numpy(np.load(SHARDED / f"ref_{path}_{cam}.npy")).to(
        img.device)
    meta = json.loads((SHARDED / f"ref_{path}_{cam}.json").read_text())
    if path != "fast":
        img, ref = img.permute(2, 0, 1), ref.permute(2, 0, 1)
    return {"camera": cam, "psnr": psnr(img, ref),
            "max_abs": float((img - ref).abs().max()),
            "bit_equal": bool(torch.equal(img, ref)), "pairs": pairs,
            "ref_pairs": meta["pairs"], "overflow": over,
            "ref_overflow": meta["overflow"]}


def _sharded_path(mesh, shard, P: int, base, path: str,
                  tile_capacity: int, rank: int) -> dict:
    """Drive one path over the orbit on this rank (``shard``: its resident
    shard_cloud of the P-splat scene, None outside the mesh): a warm-up
    frame, then SHARDED_CAMERAS / n_view timed frames; the launch counters
    and the mesh's traffic are set to 0 just before each frame and read
    just after it (the record keeps the last frame's traffic)."""
    fast = path == "fast"
    cfg = _sharded_cfg(base, path)
    fn = (sharded.render_frame_fast_sharded if fast
          else sharded.render_frame_sharded)
    kw = {} if fast else {"tile_capacity": tile_capacity}
    expect = FAST_PATH if fast else ("projection_readable", "sort_pairs",
                                     "render_exact")
    if not fast and shard is not None:
        # the readable projection's kernel takes (P, 16, 3) SH
        shard = dataclasses.replace(shard, local=sh_rows(shard.local))
    n_view = mesh.shape["view"]
    cams = gt.orbit_trajectory(SHARDED_CAMERAS, radius=5.0,
                               target=(0, 0, 6.0))
    unis = [sharded.stack_uniforms([gt.make_uniforms(c, cfg)
                                    for c in cams[i:i + n_view]])
            for i in range(0, SHARDED_CAMERAS, n_view)]
    fn(shard, unis[0], cfg, mesh, **kw)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages, frame_ms, held = [], [], []
    launches = {name: 0 for name in kernels.COUNTERS}
    for f, uni in enumerate(unis):
        timer = gt.StageTimer(mesh.device) if mesh.member else None
        mesh.traffic.clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(shard, uni, cfg, mesh, timer=timer, **kw)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        for name in launches:
            launches[name] += counts[name]
        if not mesh.member:
            check(out is None, "11: a rank outside the mesh got a frame")
            continue
        stages.append(timer.times_ms())
        for name in expect:
            check(counts[name] == 1, f"11 rank {rank}: {name} launched "
                  f"{counts[name]} times in frame {f}")
        check(fast or counts["emit_exact"] >= 1,
              f"11 rank {rank}: emit_exact not launched in frame {f}")
        img, pairs, over = out
        check(bool(torch.isfinite(img).all()), "11: non-finite image")
        if rank == 0:
            held += [_sharded_hold(path, f * n_view + v, img[v],
                                   int(pairs[v]), int(over[v]))
                     for v in range(n_view)]
    n_tile = mesh.shape["tile"]
    b_local, k_x = sharded.exchange_shape(P, n_tile)
    rec = {"mesh": [n_view, n_tile], "path": path,
           "rank": rank, "member": mesh.member, "launches": launches,
           "traffic": {k: dict(v) for k, v in mesh.traffic.items()},
           "exchange_shape": {"b_local": b_local, "k_x": k_x},
           "frame_ms": statistics.median(frame_ms), "held": held,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if stages:
        rec["stages_ms"] = {k: statistics.median(s[k] for s in stages)
                            for k in stages[0]}
    return rec


def _sharded_rank(rank: int, world: int, port: int, backend: str,
                  meshes: tuple, base, tile_capacity: int) -> None:
    """One rank of phase 11 (a spawned process: torch and the port)."""
    from datetime import timedelta
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        cloud = _mapped_cloud()
        recs = []
        for n_view, n_tile in meshes:
            mesh = sharded.make_mesh(n_view, n_tile, backend=backend)
            shard = sharded.shard_cloud(cloud, mesh)
            for path in SHARDED_PATHS:
                recs.append(_sharded_path(mesh, shard, cloud.capacity, base,
                                          path, tile_capacity, rank))
            del shard
        (SHARDED / f"{backend}_rank{rank}.json").write_text(json.dumps(recs))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded(cloud, base, tile_capacity: int, card: str) -> None:
    """Phase 11: the sharded paths at 1920x1080 on the 5.8M scene (padded
    to whole superblocks on every shard), through spawned ranks on the
    card, each held per view to the single-device frame of its camera."""
    import torch.multiprocessing as mp
    SHARDED.mkdir(parents=True, exist_ok=True)
    P = -(-cloud.capacity // SHARDED_MULTIPLE) * SHARDED_MULTIPLE
    padded = _padded(cloud, P)
    t0 = time.perf_counter()
    for f in SHARDED_FIELDS:
        a = getattr(padded, f)
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        np.save(SHARDED / f"{f}.npy", a.cpu().numpy())
    (SHARDED / "cloud.json").write_text(json.dumps(
        {"num_splats": padded.num_splats}))
    cams = gt.orbit_trajectory(SHARDED_CAMERAS, radius=5.0,
                               target=(0, 0, 6.0))
    rows = sh_rows(padded)
    for path in SHARDED_PATHS:
        cfg = _sharded_cfg(base, path)
        for i, cam in enumerate(cams):
            uni = gt.make_uniforms(cam, cfg)
            out = (gt.render_frame_fast(padded, uni, cfg)
                   if path == "fast" else
                   gt.render_frame(rows, uni, cfg,
                                   tile_capacity=tile_capacity))
            np.save(SHARDED / f"ref_{path}_{i}.npy", out.image.cpu().numpy())
            (SHARDED / f"ref_{path}_{i}.json").write_text(json.dumps({
                "pairs": int(out.stats.num_pairs),
                "overflow": int(out.stats.num_overflow)}))
    del padded, rows
    log(f"[11 sharded] {card}: {cloud.num_splats} splats padded to "
        f"capacity {P} ({P // SHARDED_MULTIPLE} x {SHARDED_MULTIPLE}), "
        f"written to {SHARDED} with the single-device frames of "
        f"{SHARDED_CAMERAS} orbit cameras (fast_defaults; exact without "
        f"the boundary quirk, tile capacity {tile_capacity}, and so with one "
        f"emission group) in "
        f"{time.perf_counter() - t0:.1f} s")
    for backend, world, meshes in SHARDED_RUNS:
        t0 = time.perf_counter()
        mp.start_processes(_sharded_rank, nprocs=world, join=True,
                           start_method="spawn",
                           args=(world, _free_port(), backend, meshes, base,
                                 tile_capacity))
        ranks = [json.loads((SHARDED / f"{backend}_rank{rank}.json")
                            .read_text()) for rank in range(world)]
        log(f"[11 sharded {backend}] {world} rank(s) on one card, spawned "
            f"and run in {time.perf_counter() - t0:.1f} s")
        for i in range(len(ranks[0])):
            _sharded_report([recs[i] for recs in ranks], backend, world,
                            card, f"{base.width}x{base.height}")


def _sharded_report(recs: list, backend: str, world: int, card: str,
                    size: str) -> None:
    """Check every rank's record of one (mesh, path) and log it: rank 0's
    frames held per view, then each mesh rank's times and launches."""
    n_view, n_tile = recs[0]["mesh"]
    fast = recs[0]["path"] == "fast"
    tag = f"11 sharded {backend} ({n_view}, {n_tile}) {recs[0]['path']}"
    frames = SHARDED_CAMERAS // n_view
    expect = FAST_PATH if fast else ("projection_readable", "sort_pairs",
                                     "render_exact")
    members = [r for r in recs if r["member"]]
    for rec in members:
        for name in expect:
            check(rec["launches"][name] == frames,
                  f"{tag} rank {rec['rank']}: {name} launched "
                  f"{rec['launches'][name]} times for {frames} frames")
    held = recs[0]["held"]
    check(len(held) == SHARDED_CAMERAS, f"{tag}: {len(held)} views held")
    # the least PSNR (dB), the most max |d|, or both
    gate = {"fast": {"psnr": FAST_GATE_DB.get(world, 40.0)},
            "exact": ({"max_abs": EXACT_GATE} if world == 1
                      else EXACT_TIES_GATE),
            "exact_1group": {"max_abs": EXACT_GATE}}[recs[0]["path"]]
    gated, other = [], []
    for h in held:
        if fast or (h["overflow"] == 0 and h["ref_overflow"] == 0):
            gated.append(h)
            ok = (h["psnr"] >= gate.get("psnr", -math.inf)
                  and h["max_abs"] <= gate.get("max_abs", math.inf))
            check(ok and h["pairs"] == h["ref_pairs"] and h["overflow"] == 0,
                  f"{tag} camera {h['camera']}: {h}, gate {gate}")
        else:
            other.append(h)
    check(recs[0]["path"] != "exact_1group" or not other,
          f"{tag}: one emission group overflowed: {other}")
    log(f"[{tag}] {card}, {size}, {len(members)} of {world} ranks: views "
        f"held to the single-device frames at cameras "
        f"{[h['camera'] for h in gated]} ("
        + ", ".join(f"PSNR >= {v} dB" if k == "psnr" else f"max |d| <= {v}"
                    for k, v in gate.items())
        + f", pairs equal): PSNR "
        f"{[round(h['psnr'], 2) for h in gated]} dB, max |d| "
        f"{max(h['max_abs'] for h in gated):.3g}, bit-equal at "
        f"{[h['camera'] for h in gated if h['bit_equal']]}, overflow "
        f"{[h['overflow'] for h in gated]}"
        + (f"; not gated (an overflow on either side): {json.dumps(other)}"
           if other else "")
        + (f"; exchange shape {json.dumps(recs[0]['exchange_shape'])}"
           if fast else ""))
    for rec in members:
        log(f"[{tag}] {card}, rank {rec['rank']}: median frame "
            f"{rec['frame_ms']:.3f} ms (host clock), median stages "
            f"{json.dumps({k: round(v, 3) for k, v in rec['stages_ms'].items()})}"
            f", peak memory {rec['peak_gib']:.2f} GiB, launches "
            f"{json.dumps({k: v for k, v in rec['launches'].items() if v})}"
            f", bytes of its collectives in the last frame (buffer: its "
            f"input; sent / received: to and from the other ranks) "
            f"{json.dumps(rec['traffic'])}")

# --- phase 12: the fast frame as captured CUDA graphs ------------------------

GRAPH_FIELDS = ("image", "tile_t0", "tile_blocks", "tile_nblocks",
                "tile_nbig", "payload", "tile_bigpay")


def _hold_graphed(tag: str, graphed, eager, fields=GRAPH_FIELDS) -> None:
    """Every field of a graphed frame bit-equal to the eager frame's (f32
    compared as bits: the cooked payload's rank row holds NaN patterns)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for f in fields:
        a, b = getattr(graphed, f), getattr(eager, f)
        check(a.shape == b.shape and torch.equal(bits(a), bits(b)),
              f"{tag}: {f} differs from the eager frame's")
    for name, a, b in zip(graphed.stats._fields, graphed.stats, eager.stats):
        check(torch.equal(a, b), f"{tag}: stats.{name} {a} against {b}")


def _timed(fn):
    """(result, host ms, CUDA-event ms, {stage: ms}) of one frame
    ``fn(timer)``, synchronised."""
    timer = gt.StageTimer(torch.device("cuda"))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    out = fn(timer)
    b.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    return out, host, a.elapsed_time(b), timer.times_ms()


def _memory_base() -> tuple:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _memory_since(base: tuple) -> dict:
    """GiB allocated and reserved above ``base`` now, and the allocated
    peak above it."""
    torch.cuda.synchronize()
    return {"allocated": (torch.cuda.memory_allocated() - base[0]) / 2**30,
            "reserved": (torch.cuda.memory_reserved() - base[1]) / 2**30,
            "peak": (torch.cuda.max_memory_allocated() - base[0]) / 2**30}


def _orbit(cfg, frames: int) -> tuple:
    """(packed uniform vectors, FrameUniforms on the card) of ``frames``
    orbit cameras."""
    cams = gt.orbit_trajectory(frames, radius=5.0, target=(0, 0, 6.0))
    w, h = cfg.target_size
    values = [pack_uniforms(c.view_matrix(), c.projection_matrix(w, h),
                            c.camera_pos_ply(), 1.0, 1e9, 0.0) for c in cams]
    return values, [gt.make_uniforms(c, cfg) for c in cams]


def time_in_turns(tag: str, sides: dict, frames: int) -> None:
    """The frames ``fn(i, timer)`` of each side of ``sides`` (name: fn)
    timed in turns over ``frames`` orbit cameras, the order rotated each
    turn: each side's median frame (host clock, CUDA events) and stages,
    logged."""
    names = list(sides)
    runs = {name: [] for name in names}
    for i in range(frames):
        k = i % len(names)
        for name in names[k:] + names[:k]:
            runs[name].append(_timed(lambda t: sides[name](i, t))[1:])
    for side, rs in runs.items():
        stages = {k: round(statistics.median(r[2][k] for r in rs), 3)
                  for k in rs[0][2]}
        log(f"[{tag}] {side}: median frame "
            f"{statistics.median(r[0] for r in rs):.3f} ms host clock (all "
            f"{[round(r[0], 3) for r in rs]}), "
            f"{statistics.median(r[1] for r in rs):.3f} ms CUDA events, "
            f"median stages {json.dumps(stages)}")


def graph_against_eager(tag: str, card: str, what: str, eager, make_graph,
                        values, fields, frames: int, launches_ok) -> None:
    """A graphed frame (``make_graph()``, replayed by ``render(values[i],
    timer)``) against its eager frame (``eager(i, timer)``) over
    ``frames`` orbit cameras: every field of ``fields`` and the stats
    bit-equal, the launches the capture recorded accepted by
    ``launches_ok`` and those a replay counts equal to an eager frame's, a
    kept frame untouched by later replays; both timed in turns (host
    clock, CUDA events, stages), their memory, and torch.profiler over 3
    frames of each."""
    base = _memory_base()
    out = eager(0)
    mem_eager = _memory_since(base)
    del out
    base = _memory_base()
    t0 = time.perf_counter()
    graph = make_graph()
    capture_s = time.perf_counter() - t0
    kept = graph.render(values[0])
    mem_graph = _memory_since(base)
    kept_image = kept.image.clone()
    check(bool(graph.launches) and launches_ok(graph.launches),
          f"{tag}: the capture recorded {graph.launches}")
    for i in range(frames):
        kernels.reset_launch_counts()
        g = graph.render(values[i])
        torch.cuda.synchronize()
        by_graph = kernels.launch_counts()
        kernels.reset_launch_counts()
        e = eager(i)
        torch.cuda.synchronize()
        check(by_graph == kernels.launch_counts(),
              f"{tag} camera {i}: launches {by_graph} replayed against "
              f"{kernels.launch_counts()} eager")
        _hold_graphed(f"{tag} camera {i}", g, e, fields)
        check(int(g.stats.num_pairs) > 0, f"{tag}: no splat-tile pairs")
    check(torch.equal(kept.image, kept_image),
          f"{tag}: a kept frame's image changed under later replays")
    log(f"[{tag}] {card}, {what}, {frames} orbit cameras: graphed frames "
        f"bit-equal to the eager frames ({', '.join(fields)}, stats), "
        f"launches a replay "
        f"{json.dumps({k: v for k, v in graph.launches.items() if v})} as "
        f"an eager frame's, a kept frame untouched; capture "
        f"{capture_s:.2f} s (warm-up frame and four graphs)")
    time_in_turns(tag, {"eager": eager, "graph": lambda i, t: graph.render(
        values[i], t)}, frames)
    log(f"[{tag}] memory above the frame's inputs, GiB: eager "
        f"{json.dumps({k: round(v, 3) for k, v in mem_eager.items()})}, "
        f"graphed {json.dumps({k: round(v, 3) for k, v in mem_graph.items()})}"
        f" (allocated: held between frames by the outputs; reserved: the "
        f"graphs' pool and the cache; peak: during the frame or the "
        f"capture)")
    profile(f"{tag} eager", lambda i: eager(i % frames), 3)
    profile(f"{tag} graph", lambda i: graph.render(values[i % frames]), 3)


def graph_config(tag: str, cloud, cfg, frames: int, card: str) -> None:
    """One configuration: FastFrameGraph against render_frame_fast_staged
    (graph_against_eager)."""
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    values, unis = _orbit(cfg, frames)
    w, h = cfg.target_size

    def eager(i, timer=None):
        return gt.render_frame_fast_staged(cloud, unis[i], cfg, timer=timer)

    # the frame as it ran before the Blocks and the Binning stage's
    # kernels, in this run, in turns with the eager frame of the kernels
    # (the eager stages' times hold the host's launch gaps: the profile of
    # the plain Binning's eager frames gives their busy share)
    for stage, dispatch in (("Blocks", blocks_dispatch),
                            ("Binning", binning_dispatch)):
        with dispatch(plain=True):
            graph = FastFrameGraph(cloud, cfg, values[0])

        def eager_plain(i, timer=None, dispatch=dispatch):
            with dispatch(plain=True):
                return eager(i, timer)

        time_in_turns(f"{tag}, plain {stage}", {
            "eager": eager_plain,
            "graph": lambda i, t, g=graph: g.render(values[i], t),
            "eager, kernels": eager}, frames)
        del graph
        if stage == "Binning":
            profile(f"{tag}, plain Binning eager",
                    lambda i: eager_plain(i % frames), 3)
    graph_against_eager(tag, card, f"{cloud.num_splats} splats {w}x{h}",
                        eager, lambda: FastFrameGraph(cloud, cfg, values[0]),
                        values, GRAPH_FIELDS, frames,
                        lambda n: all(v == 1 for v in n.values()))


def phase_graphs(full, cloud, base, card: str, frames: int = 8) -> None:
    """Phase 12: the fast frame as captured CUDA graphs (see the module
    docstring)."""
    for tag, cfg in (("12 graphs fast_defaults", base.fast_defaults()),
                     ("12 graphs v4",
                      base.replace(kernel="v4").fast_defaults()),
                     ("12 graphs quality=fast",
                      base.replace(quality="fast"))):
        graph_config(tag, cloud, cfg, frames, card)
        with blocks_dispatch(plain=True):
            profile_stage(f"{tag}, plain Blocks", cloud, cfg, "Blocks")
        profile_stage(tag, cloud, cfg, "Blocks")
        if cfg.kernel == "v3":
            with binning_dispatch(plain=True):
                profile_stage(f"{tag}, plain Binning", cloud, cfg, "Binning")
            profile_stage(tag, cloud, cfg, "Binning")
    # the engine: one capture over the orbit and a heatmap toggle
    r = gt.Rasterizer(full, texture_size=(1920, 1080), quality="fast")
    r._now = lambda: 100.0
    kept = None
    for i, cam in enumerate(gt.orbit_trajectory(frames, radius=5.0,
                                                target=(0, 0, 6.0))):
        r.camera = cam
        r.update_camera_matrices()
        r.should_enable_heatmap = i == frames // 2
        out = r.rasterize(sync=True)
        eager = gt.render_frame_fast_staged(r._render_cloud(), r._uniforms(),
                                            r.config)
        _hold_graphed(f"12 graphs Rasterizer camera {i}", out, eager)
        if kept is None:
            kept, kept_image = out, out.image.clone()
    check(torch.equal(kept.image, kept_image),
          "12 graphs Rasterizer: a kept frame's image changed")
    captures = r.graph_captures
    r.texture_size = (1280, 720)
    r.rasterize(sync=True)
    check(captures == 1 and r.graph_captures == 2,
          f"12 graphs Rasterizer: {captures} captures over {frames} cameras "
          f"and a heatmap toggle, {r.graph_captures} after a resize")
    del r, out, eager, kept
    # a streamed model: frames race the load, then the loaded model's
    # frame against the eager frame of its own fast view
    blob = write_ply(io.BytesIO(), *synthetic_arrays(
        200_000, seed=11, extent=4.0, scale_range=(0.004, 0.03),
        surfaces=True))
    r = gt.Rasterizer(blob, texture_size=(1920, 1080), stream=True,
                      chunks=16, quality="fast")
    racing = 0
    while r.loader.is_loading:
        r.rasterize(sync=True)
        racing += 1
    r.loader.join()
    check(r.loader.error is None, f"12 graphs streamed: {r.loader.error}")
    r._now = lambda: 100.0
    out = r.rasterize(sync=True)
    view = gt.fast_cloud_view(r.cloud)
    eager = gt.render_frame_fast_staged(view, r._uniforms(), r.config)
    _hold_graphed("12 graphs streamed", out, eager)
    check(torch.equal(r._render_cloud().sh, view.sh),
          "12 graphs streamed: the fast view's SH is stale")
    log(f"[12 graphs] {card}: Rasterizer(quality=\"fast\") over {frames} "
        f"orbit cameras and a heatmap toggle: {captures} capture, frames "
        f"bit-equal to the eager frames, a kept frame untouched; a resize "
        f"captured once more. A streamed 200,000-splat model (16 chunks, "
        f"{racing} frames racing the load, {r.graph_captures} capture): its "
        f"frame after the load bit-equal to the eager frame of its own fast "
        f"view")


# --- phase 13: the exact frame as captured CUDA graphs -----------------------

EXACT_GRAPH_FIELDS = ("image", "sorted_values", "tile_start", "tile_end",
                      "tile_t0", "splat_pos")


def phase_exact_graphs(full, base, capacity: int, card: str,
                       frames: int = 8) -> None:
    """Phase 13: the exact frame as captured CUDA graphs (see the module
    docstring)."""
    cfg = base
    check(cfg.reference_boundary_quirk, "13: the boundary quirk is off")
    values, unis = _orbit(cfg, frames)
    w, h = cfg.target_size
    groups = (1 + sum(wt > cfg.max_tiles_per_splat for wt, _ in
                      cfg.exact_tiers) + bool(cfg.giant_splat_capacity))

    def eager(i, timer=None):
        return render_frame_staged(full, unis[i], cfg, tile_capacity=capacity,
                                   timer=timer)

    graph_against_eager(
        "13 exact graphs", card, f"{full.num_splats} splats {w}x{h}, tile "
        f"capacity {capacity}, boundary quirk on", eager,
        lambda: ExactFrameGraph(full, cfg, values[0], capacity), values,
        EXACT_GRAPH_FIELDS, frames,
        lambda n: n == {"projection_readable": 1, "emit_plan": 1,
                        "emit_exact": groups, "sort_pairs": 1,
                        "render_exact": 1})
    # the engine: one capture over the orbit and a heatmap toggle, at the
    # capacity phase 8 settled on; then a forced regrowth
    r = gt.Rasterizer(full, texture_size=(w, h), tile_capacity=capacity)
    r._now = lambda: 100.0
    kept = None
    for i, cam in enumerate(gt.orbit_trajectory(frames, radius=5.0,
                                                target=(0, 0, 6.0))):
        r.camera = cam
        r.update_camera_matrices()
        r.should_enable_heatmap = i == frames // 2
        out = r.rasterize(sync=True)
        ref = render_frame_staged(r.cloud, r._uniforms(), r.config,
                                  tile_capacity=r.tile_capacity)
        _hold_graphed(f"13 exact graphs Rasterizer camera {i}", out, ref,
                      EXACT_GRAPH_FIELDS)
        if kept is None:
            kept, kept_image = out, out.image.clone()
    check(torch.equal(kept.image, kept_image),
          "13 exact graphs Rasterizer: a kept frame's image changed")
    captures = r.graph_captures
    check(captures == 1 and r.tile_capacity == capacity,
          f"13 exact graphs Rasterizer: {captures} captures over {frames} "
          f"cameras and a heatmap toggle, tile capacity {r.tile_capacity}")
    densest = int(out.stats.max_tile_count)
    r.tile_capacity = densest // 2
    out = r.rasterize(sync=True)
    grown = r.tile_capacity
    check(r.graph_captures == captures + 2 and grown >= densest,
          f"13 exact graphs Rasterizer: {r.graph_captures} captures after "
          f"a regrowth from {densest // 2} to {grown} (densest {densest})")
    ref = render_frame_staged(r.cloud, r._uniforms(), r.config,
                              tile_capacity=grown)
    _hold_graphed("13 exact graphs Rasterizer regrown", out, ref,
                  EXACT_GRAPH_FIELDS)
    log(f"[13 exact graphs] {card}: Rasterizer() (exact) over {frames} "
        f"orbit cameras and a heatmap toggle at tile capacity {capacity}: "
        f"{captures} capture, frames bit-equal to the eager frames, a kept "
        f"frame untouched; tile capacity {densest // 2} below the densest "
        f"tile ({densest}): captured there, grown to {grown} and captured "
        f"again ({r.graph_captures} captures), the regrown frame bit-equal "
        f"to the eager frame at {grown}")


# --- phase 14: benchmarks/configs.py's five workloads, as the port runs them

# benchmarks/configs.py:100-113: name, splats, width, height, SH degree
WORKLOADS = (("1_demo_512_sh0", 500_000, 512, 512, 0),
             ("2_orbit_720p_sh3", 500_000, 1280, 720, 3),
             ("3_truck_2.5M_1080p", 2_500_000, 1920, 1080, 3),
             ("4_garden_5.8M_1080p_pick", 5_800_000, 1920, 1080, 3),
             ("5_stress_4K_10M", 10_000_000, 3840, 2160, 3))
QUALITY_FAST_PATH = ("projection_readable", "screen_pack", "screen_sort",
                     "block_frame_cooked", "big_lanes", "big_set",
                     "bin_blocks", "bin_bigs", "render_v3_cooked")
WORKLOAD_FRAMES = 4


def workload(name: str, full, w: int, h: int, degree: int,
             card: str) -> None:
    """One workload: RasterizerConfig(width, height, sh_degree) with its
    defaults (quality="fast": readable projection, screen clustering, tile
    16, cooked v3) through render_frame_fast_staged and FastFrameGraph over
    WORKLOAD_FRAMES orbit cameras: the graphed frames bit-equal to the
    eager ones, every kernel of the path launched by each graphed frame,
    eager and graphed frames timed in turns, the eager frame's peak memory
    above its inputs. Config 4 picks at the centre tile; config 5 also
    renders with early exit off and holds screen_pack, screen_sort and
    big_set bit-equal to their plain versions on its Blocks arguments."""
    cfg = gt.RasterizerConfig(width=w, height=h, sh_degree=degree)
    cloud = gt.fast_cloud_view(full, planar_sh=cfg.projection_kernel)
    values, unis = _orbit(cfg, WORKLOAD_FRAMES)
    tag = f"14 {name}"

    def eager(i, timer=None, early_exit=True):
        return gt.render_frame_fast_staged(cloud, unis[i], cfg,
                                           early_exit=early_exit,
                                           timer=timer)

    calls: list = []
    base = _memory_base()
    with blocks_dispatch(calls=calls):
        first = eager(0)
    mem = _memory_since(base)
    graph = FastFrameGraph(cloud, cfg, values[0])
    kernels.reset_launch_counts()
    for i in range(WORKLOAD_FRAMES):
        g = graph.render(values[i])
        e = eager(i) if i else first
        _hold_graphed(f"{tag} camera {i}", g, e)
        check(bool(torch.isfinite(g.image).all()), f"{tag}: non-finite image")
        check(int(g.stats.num_pairs) > 0, f"{tag}: no splat-tile pairs")
    launches = kernels.launch_counts()
    for k in QUALITY_FAST_PATH:
        check(launches[k] == 2 * WORKLOAD_FRAMES - 1,
              f"{tag}: {k} launched {launches[k]} times by "
              f"{WORKLOAD_FRAMES} graphed and {WORKLOAD_FRAMES - 1} eager "
              f"frames")
    sides = {"eager": eager,
             "graph": lambda i, t: graph.render(values[i], t)}
    extra = ""
    if name.startswith("4"):
        gx, gy = cfg.tile_dims
        pick = gt.pick_splat_position_fast(first, (gy // 2) * gx + gx // 2,
                                           cloud, 1.0, cfg)
        check(bool(torch.isfinite(pick).all()), f"{tag}: centre pick {pick}")
        extra = f", centre pick {pick.tolist()}"
    if name.startswith("5"):
        off = eager(0, early_exit=False)
        check(bool(torch.isfinite(off.image).all()),
              f"{tag}: non-finite image with early exit off")
        extra = (f", early exit off against on at camera 0: PSNR "
                 f"{psnr(off.image, first.image):.2f} dB (not gated)")
        sides["eager, early exit off"] = lambda i, t: eager(
            i, t, early_exit=False)
        bad = {}
        for kind, a, kw in calls:
            if kind in ("pack", "sort", "bigset"):
                _, kernel, plain = BLOCK_KINDS[kind]
                bad.update(_outputs_differ(kind, kernel(*a, **kw),
                                           plain(*a, **kw)))
        check(not any(bad.values()),
              f"{tag}: the Blocks kernels not bit-equal: {bad}")
        (key, taken, _) = next(a for kind, a, _ in calls if kind == "sort")
        extra += ("; screen_pack, screen_sort and big_set bit-equal to "
                  "their plain versions on its Blocks arguments; "
                  f"screen_sort's {tuple(key.shape)} rows, radix passes a "
                  f"row {json.dumps(passes_a_row(key, taken))}")
    log(f"[{tag}] {card}, {cloud.num_splats} splats {w}x{h}, SH degree "
        f"{degree}, tile {cfg.tile_size} cluster {cfg.cluster}, "
        f"{WORKLOAD_FRAMES} orbit cameras: graphed frames bit-equal to the "
        f"eager frames, every kernel of the path launched by each; pairs "
        f"{int(first.stats.num_pairs)}, overflow "
        f"{int(first.stats.num_overflow)}; the eager frame's memory above "
        f"its inputs, GiB "
        f"{json.dumps({k: round(v, 3) for k, v in mem.items()})}{extra}")
    time_in_turns(tag, sides, WORKLOAD_FRAMES)


def phase_workloads(full, card: str) -> None:
    """Phase 14: the five workloads of benchmarks/configs.py on bench.py's
    scene kind in load order (``frame_cloud``) at each one's splat count
    (phase 4's scene for the 5.8M one)."""
    t0 = time.perf_counter()
    scenes = {full.num_splats: full}
    for name, n, w, h, degree in WORKLOADS:
        if n not in scenes:
            scenes = {full.num_splats: full, n: frame_cloud(n)[0]}
        workload(name, scenes[n], w, h, degree, card)
        if name.startswith("5"):
            exact_sort_4k(scenes[n])
    del scenes
    log(f"[14 workloads] five workloads in {time.perf_counter() - t0:.1f} s"
        f" (scenes included)")


def binning_only(card: str) -> int:
    """``--binning``: phase 6's Binning check and the Binning stage's
    profile (kernels) on phase 4's scene, and the two kernel records."""
    full, setup_s = frame_cloud(5_800_000)
    cloud = gt.fast_cloud_view(full)
    log(f"[4 frame] scene set-up {setup_s:.1f} s")
    base = gt.RasterizerConfig(width=1920, height=1080)
    rec = phase_binning(cloud, base)
    for tag, cfg in (("6 binning fast_defaults", base.fast_defaults()),
                     ("6 binning quality=fast", base.replace(quality="fast"))):
        profile_stage(tag, cloud, cfg, "Binning")
    log(card)
    log(json.dumps({"kernels": rec}))
    return 0


def ab_plan(tag: str, other_so, valid, num_tiles, cfg, card: str) -> None:
    """The other checkout's emit_plan against this one's on the same
    inputs: every EmitPlan field bit-equal, then each timed in turns
    other, this, this, other as graph replays of 20 calls, with each
    one's device kernels and memsets a call (``kernel_split``)."""
    plans = {"other": other_so._emit_plan_cuda, "this": so._emit_plan_cuda}
    outs = {s: f(valid, num_tiles, cfg) for s, f in plans.items()}
    torch.cuda.synchronize()
    bad = plan_differ(outs["other"], outs["this"])
    check(not bad, f"{tag}: the two checkouts' plans differ {bad}")
    del outs
    order = ("other", "this", "this", "other")
    times = [round(time_graphed_ms(
        lambda f=plans[s]: f(valid, num_tiles, cfg), 20), 4) for s in order]
    split = {s: kernel_split(lambda f=plans[s]: f(valid, num_tiles, cfg))
             for s in ("other", "this")}
    log(f"[{tag}] {card}: {valid.shape[0]} splats: every field bit-equal "
        f"between the checkouts; ms in turns "
        f"{json.dumps(list(zip(order, times)))}; device kernels and memsets "
        f"a call {json.dumps(split)}")


def ab_sorts(root: str, emitted, plan_in, run, cfg, card: str):
    """``--sorts OTHER``: the other checkout's emit_plan, sort_pairs and
    screen_sort (its package imported beside this one, its kernels built
    from its own sources) on the same 1080p inputs as this one's: outputs
    bit-equal between the two, then each kernel timed in turns other,
    this, this, other (emit_plan as in ``ab_plan``, sort_pairs as in
    sort_vs_plain, screen_sort as graph replays of 20 launches). Returns
    the other checkout's sort module."""
    from godotgaussiansplatting_torch.ab_render import import_other
    _, other_kernels = import_other(Path(root).resolve())
    import importlib
    o_so = importlib.import_module("gsother.ops.sort")
    o_b2 = importlib.import_module("gsother.ops.blocks2")
    other_kernels.build("emit_plan", "sort_pairs", "screen_sort")
    ab_plan("ab emit_plan 1080p", o_so, *plan_in, cfg, card)
    keys, vals, total = emitted
    k_max = keys.shape[0] - 1
    n = min(int(total), k_max)
    end_bit = so.sort_key_bits(cfg.num_tiles)
    sorts = {"other": o_so._sort_pairs_cuda, "this": so._sort_pairs_cuda}
    outs = {s: f(keys.clone(), vals.clone(), total, k_max, end_bit)
            for s, f in sorts.items()}
    check(all(torch.equal(a, b) for a, b in zip(outs["other"],
                                                 outs["this"])),
          "ab sort_pairs: the two checkouts' outputs differ")
    del outs
    k, v = keys.clone(), vals.clone()

    def sort_ms(fn):
        def copy():
            k[:n].copy_(keys[:n])
            v[:n].copy_(vals[:n])

        def copy_and_sort():
            copy()
            fn(k, v, total, k_max, end_bit)
        return min(time_graphed_ms(copy_and_sort, 5) - time_graphed_ms(copy, 5)
                   for _ in range(2))

    order = ("other", "this", "this", "other")
    times = [round(sort_ms(sorts[s]), 4) for s in order]
    log(f"[ab sort_pairs 1080p] {card}: n {n} of k_max {k_max}, end_bit "
        f"{end_bit}: bit-equal between the checkouts; ms in turns "
        f"{json.dumps(list(zip(order, times)))}")
    a, kw, _ = run["sort"]
    rows = {"other": o_b2._screen_sort_cuda, "this": b2._screen_sort_cuda}
    outs = {s: f(*a, **kw) for s, f in rows.items()}
    check(all(torch.equal(x, y) for x, y in zip(outs["other"],
                                                 outs["this"])),
          "ab screen_sort: the two checkouts' outputs differ")
    times = [round(time_graphed_ms(lambda f=rows[s]: f(*a, **kw), 20), 4)
             for s in order]
    log(f"[ab screen_sort 1080p] {card}: {tuple(a[0].shape)} rows: "
        f"bit-equal between the checkouts; ms in turns "
        f"{json.dumps(list(zip(order, times)))}")
    return o_so


def sorts_only(card: str, other: str | None) -> int:
    """``--sorts [OTHER]``: phase 6's two sort records alone on phase 4's
    scene (sort_pairs on the 1080p exact emission, screen_sort on the
    1080p quality="fast" Blocks stage's rows), their distributions (pairs
    a tile, passes a row) and edge cases, the 4K exact sort at end_bit 31
    on the fifth workload's 10M scene, profile_sort and the quality="fast"
    Blocks profile; with OTHER, the other checkout's two kernels on the
    same inputs, timed in turns (``ab_sorts``). Logs the two records and
    not the result line of a full run."""
    full, setup_s = frame_cloud(5_800_000)
    cloud = gt.fast_cloud_view(full)
    log(f"[4 frame] scene set-up {setup_s:.1f} s")
    base = gt.RasterizerConfig(width=1920, height=1080)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), base)
    prj = project_splats(full.means, full.cov3d, full.opacity, full.sh,
                         full.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, base)
    plan = plan_vs_plain("6 emit_plan 1080p", prj, base)
    plan_in = (prj.valid, prj.num_tiles)
    keys, vals, total, _ = so.emit_pairs(prj.valid, prj.rect, prj.num_tiles,
                                         prj.depth16, base)
    del prj
    k_max = keys.shape[0] - 1
    emitted = (keys, vals, total)
    dist = pairs_a_tile(keys, min(int(total), k_max),
                        so.sort_key_bits(base.num_tiles))
    log(f"[6 sort_pairs 1080p] pairs a tile: {json.dumps(dist)}")
    srt = sort_vs_plain("6 sort_pairs 1080p", emitted, base)
    r = record("sort_pairs", 0.0, srt["ms"], srt["plain_ms"], srt["bnd"])
    r.update(library_ms=srt["library_ms"],
             library_ms_live=srt["library_ms_live"],
             pass_bytes=srt["pass_bytes"])
    rec = [plan, r]
    sort_edge_cases()
    fast = base.replace(quality="fast")
    run = blocks_vs_plain("6 blocks quality=fast 1080p", cloud, fast)
    (key, taken, _), _, _ = run["sort"]
    log(f"[6 screen_sort 1080p] {tuple(key.shape)} rows, radix passes a "
        f"row: {json.dumps(passes_a_row(key, taken))}")
    rec.append(screen_sort_record(run))
    sort_ties_vs_plain(run)
    screen_sort_edge_cases()
    other_so = (ab_sorts(other, emitted, plan_in, run, base, card)
                if other else None)
    del emitted, keys, vals, run, plan_in
    for plain_plan in (True, False):    # Sort ignores the capacity
        profile_sort("6 exact 1080p", full, base, 2048,
                     plain_plan=plain_plan)
    profile_stage("6 blocks quality=fast", cloud, fast, "Blocks")
    del cloud, full
    gc.collect()
    big, setup_s = frame_cloud(10_000_000)
    log(f"[14 5_stress_4K_10M] scene set-up {setup_s:.1f} s")
    exact_sort_4k(big, other_so, card)
    cfg5 = gt.RasterizerConfig(width=3840, height=2160)
    run5 = blocks_vs_plain("14 blocks quality=fast 4K", big,
                           cfg5.replace(quality="fast"))
    (key, taken, _), _, _ = run5["sort"]
    log(f"[14 screen_sort 4K] {tuple(key.shape)} rows, radix passes a row:"
        f" {json.dumps(passes_a_row(key, taken))}")
    log(card)
    log(json.dumps({"kernels": rec}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was measured")
    args = sys.argv[1:]
    if not (args in ([], ["--binning"])
            or (args[:1] == ["--sorts"] and len(args) <= 2)):
        raise SystemExit(f"chip_smoke: unknown arguments {args}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_device()
    if args == ["--binning"]:
        return binning_only(card)
    if args:
        return sorts_only(card, args[1] if len(args) == 2 else None)
    probe, probe_launches = phase_sfu_probe()   # sets SFU before any bound
    worst = phase_projection(1_000_000, 1920, 1080)
    cloud = render_cloud(200_000)
    worst["render_v3"] = phase_render(cloud, 512)
    worst["render_v3_cooked"] = phase_render_cooked(cloud, 512)
    worst["render_v4"] = phase_render_v4(cloud, (512, 480))
    worst["render_exact"] = phase_exact(cloud, 512)
    del cloud
    full, setup_s = frame_cloud(5_800_000)
    cloud = gt.fast_cloud_view(full)
    log(f"[4 frame] scene set-up {setup_s:.1f} s")
    base = gt.RasterizerConfig(width=1920, height=1080)
    launches = {}
    binning = ("bin_blocks", "bin_bigs")
    screen = ("screen_pack", "screen_sort")
    frames = (("4 frame fast_defaults", base.fast_defaults(), FAST_PATH),
              ("5 frame v4", base.replace(kernel="v4").fast_defaults(),
               ("projection", "block_frame_cooked", "big_lanes", "big_set",
                *binning, "render_v4")),
              ("5 frame quality=fast", base.replace(quality="fast"),
               ("projection_readable", *screen, "block_frame_cooked",
                "big_lanes", "big_set", *binning, "render_v3_cooked")),
              ("5 frame quality=fast v4",
               base.replace(quality="fast", kernel="v4"),
               ("projection_readable", *screen, "block_frame_cooked",
                "big_lanes", "big_set", *binning, "render_v4")))
    for tag, cfg, expect in frames:
        counts = phase_frame(tag, cloud, cfg, 8, expect)
        for name in expect:
            launches.setdefault(name, counts[name])
    # profiled after every timed frame, so no timed frame follows a trace
    for tag, cfg, _ in frames:
        profile_frames(tag, cloud, cfg)
    exact_launches, capacity = phase_engine(full, 8)
    for name in EXACT_PATH:
        launches[name] = exact_launches[name]
    rec = phase_kernels_1080p(cloud, base, worst)
    rec += phase_blocks(cloud, base)
    rec += phase_binning(cloud, base)
    rec += exact_stages_1080p(full, base, worst)
    rec.append(exact_1080p(full, base, capacity, worst["render_exact"]))
    for plain_plan in (True, False):
        profile_sort("6 exact 1080p", full, base, capacity,
                     plain_plan=plain_plan)
    rec.append(probe)
    launches["sfu_probe"] = probe_launches
    BUILD.mkdir(parents=True, exist_ok=True)
    phase_viewer(full, card)
    phase_sharded(cloud, base, capacity, card)
    phase_graphs(full, cloud, base, card)
    phase_exact_graphs(full, base, capacity, card)
    phase_workloads(full, card)
    for r in rec:
        r["launches"] = launches[r["name"]]
    log(card)
    log(json.dumps({"kernels": rec}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
