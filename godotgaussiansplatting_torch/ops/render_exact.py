"""Exact path, stage 4: per-tile front-to-back compositing of each tile's
sorted splat list.

Counterpart of ``godotgaussiansplatting_tpu/ops/render.py``
(``render_tiles``, plain XLA there, no Pallas). ``render_tiles`` sends CUDA
tensors to the hand-written kernel ``csrc/render_exact.cu`` (or raises) and
CPU tensors to ``render_tiles_reference``, the JAX formulation in torch:
tiles in batches, each batch walking its tiles' lists in chunks of
``CH = min(512, C)`` slots with a carried transmittance, stopping once every
pixel of the batch is saturated or no tile has slots left. Per chunk, with
q the transmittance before it and ``P_j`` the inclusive prefix product of
``1 - alpha``, slot j is processed while ``q * P_{j-1} > 1/255`` and adds
``rgb_j * alpha_j * q * P_{j-1}``. The transmittance is monotone, so the
processed slots are a prefix (render.py:6-10), and q after the chunk is the
inclusive prefix at its last processed slot: the product the kernel
carries, slot by slot, in the same order.

Kept from the JAX function: the per-tile cap is ``ceil(C / CH) * CH``
slots (C = ``tile_capacity``), not exactly C; alpha is ``a * exp(power)``
with no clamps (gsplat_render.glsl:85-87); the heatmap lerp uses the
untruncated tile counts; ``tile_t0`` is each tile's pixel (0, 0) final
transmittance.

The kernel, one block of 256 threads a tile, is bound by issuing
evaluations: a tile's pixels saturate after about 80 of its 2,300 slots,
each at its own slot. It walks the list in pieces of 32 slots that never
straddle a chunk end, votes at each piece boundary and leaves once every
pixel is saturated; a warp whose pixels are all saturated skips a piece's
evaluations; and the next pieces' splat data is gathered into shared
memory with ``cp.async`` while one is evaluated. The evaluation's
arithmetic is the plain version's, so ``tile_t0`` is bit-equal to it.
``walk_shape`` reads the piece and the block size from the built library.
``schedule_evaluations`` models the (pixel, slot) evaluations that walk
makes, from the plain version's per-pixel processed counts;
``count_evaluations`` has the kernel count them on the card, and
``sass_per_evaluation`` reads the instructions each takes from the built
kernel.
"""

from __future__ import annotations

import ctypes
import re
from typing import NamedTuple

import torch

from .. import kernels
from ..config import MIN_FACTOR, RasterizerConfig

CHUNK = 512  # slots a chunk of the carried transmittance


class RenderOutput(NamedTuple):
    image: torch.Tensor        # (H, W, 4) f32, alpha = 1
    tile_t0: torch.Tensor      # (T,) f32 pixel (0, 0) final transmittance
    tile_counts: torch.Tensor  # (T,) i32 end - start (untruncated)


def effective_capacity(tile_capacity: int) -> int:
    """Slots a tile composites at most: whole chunks of min(512, C)."""
    ch = min(CHUNK, tile_capacity)
    return -(-tile_capacity // ch) * ch


def _heatmap(counts: torch.Tensor, t_final: torch.Tensor,
             heatmap_factor) -> torch.Tensor:
    """The heatmap overlay (gsplat_render.glsl:100-101): an unclamped
    blue-to-red lerp by count * 5e-4, scaled by the covered share and the
    factor. (B,) counts, (B, NPX) t_final -> (B, NPX, 3)."""
    dev = counts.device
    blue = torch.tensor([0.0, 0.0, 1.0], device=dev)
    red = torch.tensor([1.0, 0.2, 0.2], device=dev)
    mixf = counts.to(torch.float32)[:, None] * 5e-4
    hm = blue[None, None] + (red - blue)[None, None] * mixf[:, :, None]
    return hm * ((1.0 - t_final) * heatmap_factor)[:, :, None]


def _blend_chunk(ids, slot_valid, px, py, q_in, image_pos, conic, color):
    """One chunk of slots for a batch of tiles (render.py:37-76). ids, slot
    valid (B, CH); px, py (B, NPX); q_in (B, NPX) the transmittance before
    the chunk. Returns the chunk's (B, NPX, 3) colour, q after it and the
    (B, NPX) count of processed valid slots."""
    ipos = image_pos[ids]                       # (B, CH, 2)
    con = conic[ids]                            # (B, CH, 3)
    col = color[ids]                            # (B, CH, 4)
    dx = ipos[:, :, 0:1] - px[:, None, :]       # (B, CH, NPX)
    dy = ipos[:, :, 1:2] - py[:, None, :]
    power = (-0.5 * (con[:, :, 0:1] * dx * dx + con[:, :, 2:3] * dy * dy)
             - con[:, :, 1:2] * dx * dy)
    alpha = col[:, :, 3:4] * torch.exp(power)   # no clamps (the quirk)
    alpha = torch.where(slot_valid[:, :, None], alpha, 0.0)
    prod = torch.cumprod(1.0 - alpha, dim=1)
    p_incl = q_in[:, None, :] * prod
    p_excl = torch.cat([q_in[:, None, :], p_incl[:, :-1]], dim=1)
    processed = p_excl > (1.0 / MIN_FACTOR)
    w = alpha * p_excl * processed
    blended = torch.einsum("bcp,bck->bpk", w, col[:, :, :3])
    # q after the chunk: the inclusive prefix at the last processed slot
    n_proc = processed.sum(dim=1)               # (B, NPX), a prefix length
    last = torch.clamp(n_proc - 1, min=0)[:, None, :]
    q_out = torch.where(n_proc > 0, p_incl.gather(1, last)[:, 0], q_in)
    return blended, q_out, (processed & slot_valid[:, :, None]).sum(dim=1)


def _composite(sorted_values, tile_start, tile_end, image_pos, conic, color,
               heatmap_factor, cfg: RasterizerConfig, tile_capacity: int,
               tile_batch: int, pixel_offset):
    """``render_tiles_reference``'s output and the (T, ts * ts) count of
    slots each tile pixel processed."""
    dev = sorted_values.device
    gx, gy = cfg.tile_dims
    T = gx * gy
    K = sorted_values.shape[0]
    ts = cfg.tile_size
    C = tile_capacity
    CH = min(CHUNK, C)
    n_ch = -(-C // CH)
    hf = torch.as_tensor(heatmap_factor, dtype=torch.float32, device=dev)
    start = tile_start.to(torch.int64)
    end = tile_end.to(torch.int64)
    counts = (tile_end - tile_start).to(torch.int32)
    tids = torch.arange(T, device=dev)
    tpx = (tids % gx) * ts + int(pixel_offset[0])
    tpy = (tids // gx) * ts + int(pixel_offset[1])
    lx = torch.arange(ts, dtype=torch.float32, device=dev)
    lxs = lx.repeat(ts)                          # pixel p: (p % ts, p // ts)
    lys = lx.repeat_interleave(ts)
    slot = torch.arange(CH, device=dev)
    blended = torch.zeros((T, ts * ts, 3), device=dev)
    t_final = torch.ones((T, ts * ts), device=dev)
    n_proc = torch.zeros((T, ts * ts), dtype=torch.int64, device=dev)
    for b0 in range(0, T, tile_batch):
        b1 = min(T, b0 + tile_batch)
        s, e = start[b0:b1], end[b0:b1]
        px = tpx[b0:b1, None].to(torch.float32) + lxs[None]
        py = tpy[b0:b1, None].to(torch.float32) + lys[None]
        q = t_final[b0:b1]
        acc = blended[b0:b1]
        npr = n_proc[b0:b1]
        for k in range(n_ch):
            if not bool(((s + k * CH < e).any()
                         & (q > 1.0 / MIN_FACTOR).any())):
                break
            slots = s[:, None] + k * CH + slot[None, :]
            valid = slots < e[:, None]
            ids = sorted_values[torch.clamp(slots, 0, K - 1)].to(torch.int64)
            contrib, q, n = _blend_chunk(ids, valid, px, py, q, image_pos,
                                         conic, color)
            acc += contrib
            npr += n
        t_final[b0:b1] = q
        blended[b0:b1] = acc + _heatmap(counts[b0:b1], q, hf)
    wpx, hpx = cfg.target_size
    img = blended.reshape(gy, gx, ts, ts, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(gy * ts, gx * ts, 3)[:hpx, :wpx]
    rgba = torch.cat([img, torch.ones_like(img[:, :, :1])], dim=-1)
    return RenderOutput(image=rgba, tile_t0=t_final[:, 0].contiguous(),
                        tile_counts=counts), n_proc


def render_tiles_reference(sorted_values, tile_start, tile_end, image_pos,
                           conic, color, heatmap_factor,
                           cfg: RasterizerConfig, tile_capacity: int = 2048,
                           tile_batch: int = 16, pixel_offset=(0, 0)
                           ) -> RenderOutput:
    """The plain version (see the module docstring). ``tile_batch`` tiles
    composite together; it changes no pixel."""
    return _composite(sorted_values, tile_start, tile_end, image_pos, conic,
                      color, heatmap_factor, cfg, tile_capacity, tile_batch,
                      pixel_offset)[0]


def walk_shape() -> tuple:
    """The built kernel's (slots a piece, threads a block)."""
    lib = kernels.library("render_exact")
    return lib.gs_render_exact_piece(), lib.gs_render_exact_threads()


def pixels_per_thread(tile_size: int, threads: int) -> int:
    """The kernel instance a tile size runs: 1, 2 or 4 pixels a thread of
    a block of ``threads``."""
    ppt = 1
    while threads * ppt < tile_size * tile_size:
        ppt *= 2
    return ppt


def schedule_evaluations(n_proc: torch.Tensor, cfg: RasterizerConfig,
                         piece: int, threads: int, tile_counts: torch.Tensor,
                         tile_capacity: int) -> int:
    """The (pixel, slot) evaluations the kernel's walk (pieces of ``piece``
    slots, blocks of ``threads``: ``walk_shape()``) makes, from the plain
    version's (T, ts * ts) per-pixel processed counts (``_composite``'s
    second output) and the (T,) tile counts.

    A tile's list (its first ``effective_capacity`` slots) is walked in
    pieces of ``piece`` slots from each chunk's base, and every piece is
    evaluated whole (the slots past a chunk's or the list's end are zero
    records). Before each piece the block votes: a pixel is live at slot e
    while it processes slot e (its count is above e), and the block leaves
    once no pixel is. Warp w evaluates a piece for its 32 * PPT pixels
    (pixels (w * PPT + k) * 32 + lane) when one of its pixels inside the
    tile is live; every in-tile pixel is live at slot 0. Since the
    processed slots are a prefix, warp w evaluates the pieces that start
    below its largest count, and at least the first."""
    T, npx = n_proc.shape
    ppt = pixels_per_thread(cfg.tile_size, threads)
    lanes = threads * ppt
    chunk = min(CHUNK, tile_capacity)
    n_eff = tile_counts.to(torch.int64).clamp(0, effective_capacity(
        tile_capacity))
    pad = torch.full((T, lanes - npx), -1, dtype=torch.int64,
                     device=n_proc.device)
    warp = torch.cat([n_proc.to(torch.int64), pad], dim=1).reshape(
        T, threads // 32, 32 * ppt).amax(dim=2)            # (T, warps)
    inside = warp >= 0
    x = torch.minimum(warp.clamp(min=1), n_eff[:, None])
    base = (x - 1).clamp(min=0) // chunk * chunk
    pieces = (base // chunk * -(-chunk // piece)
              + (x - base + piece - 1) // piece)
    pieces = torch.where(inside & (x > 0), pieces, 0)
    return int(pieces.sum()) * piece * 32 * ppt


_SASS_FUNC = re.compile(r"Function : \S*render_exact_kernelILi(\d+)E")


def sass_per_evaluation(listing: str) -> dict:
    """{PPT: {opcode: instructions per (pixel, slot) evaluation}} from
    ``cuobjdump -sass`` of the render_exact library: per kernel instance,
    of its innermost loops that hold the alpha's exp (MUFU.EX2, one an
    evaluation) the one with the most, its instructions (counted as
    ``kernels.op_counts`` counts them, and under "all" every instruction
    once) over its MUFU.EX2. The loop's own
    instructions and its shared-memory loads are shared out among its
    evaluations."""
    out = {}
    for ppt, insns in kernels.sass_functions(listing, _SASS_FUNC).items():
        spans = kernels.loops(insns)
        inner = [(lo, hi) for lo, hi in spans
                 if not any(lo <= a <= b <= hi and (a, b) != (lo, hi)
                            for a, b in spans)]
        best = max(((kernels.op_counts(insns, lo, hi).get("MUFU.EX2", 0),
                     lo, hi) for lo, hi in inner), default=(0, 0, 0))
        if best[0] == 0:
            raise RuntimeError(f"render_exact<{ppt}>: no loop holds an exp")
        counts = kernels.op_counts(insns, best[1], best[2])
        counts["all"] = sum(best[1] <= a <= best[2] for a, _, _ in insns)
        out[int(ppt)] = {k: v / best[0] for k, v in sorted(counts.items())}
    return out


def _render_exact_cuda(sorted_values, tile_start, tile_end, image_pos, conic,
                       color, heatmap_factor, cfg: RasterizerConfig,
                       tile_capacity: int, pixel_offset=(0, 0),
                       evals: torch.Tensor | None = None) -> RenderOutput:
    """The kernel (csrc/render_exact.cu): one thread block a tile. With
    ``evals``, a zeroed (1,) int64 tensor on the card, the kernel adds to
    it the (pixel, slot) evaluations its walk makes."""
    ts = cfg.tile_size
    gx, gy = cfg.tile_dims
    T = gx * gy
    P = image_pos.shape[0]
    if (sorted_values.dtype != torch.int32 or tile_start.dtype != torch.int32
            or tile_end.dtype != torch.int32 or tile_start.shape != (T,)
            or tile_end.shape != (T,) or image_pos.shape != (P, 2)
            or conic.shape != (P, 3) or color.shape != (P, 4)
            or not all(t.dtype == torch.float32
                       for t in (image_pos, conic, color))):
        raise ValueError("render_exact: unexpected input shapes/dtypes")
    kernels.require_cuda("render_exact", sorted_values, tile_start, tile_end,
                         image_pos, conic, color)
    lib = kernels.library("render_exact")
    if ts * ts > 4 * lib.gs_render_exact_threads():
        raise ValueError("the render_exact kernel supports tile_size <= 32")
    if image_pos.data_ptr() % 8 or color.data_ptr() % 16:
        # the kernel copies their rows whole, 8 and 16 bytes at a time
        raise ValueError("render_exact: image_pos must be 8-byte and color "
                         "16-byte aligned")
    dev = sorted_values.device
    hf = torch.as_tensor(heatmap_factor, dtype=torch.float32,
                         device=dev).reshape(1).contiguous()
    w, h = cfg.target_size
    image = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    tile_t0 = torch.empty((T,), dtype=torch.float32, device=dev)
    counts = torch.empty((T,), dtype=torch.int32, device=dev)
    err = lib.gs_render_exact(
        sorted_values.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
        image_pos.data_ptr(), conic.data_ptr(), color.data_ptr(),
        hf.data_ptr(), image.data_ptr(), tile_t0.data_ptr(),
        counts.data_ptr(), gx, gy, ts, w, h, min(CHUNK, tile_capacity),
        effective_capacity(tile_capacity), int(pixel_offset[0]),
        int(pixel_offset[1]), None if evals is None else evals.data_ptr(),
        ctypes.c_void_p(kernels.stream_ptr(dev)))
    kernels.check(err, "render_exact kernel launch")
    kernels.count_launch("render_exact")
    return RenderOutput(image=image, tile_t0=tile_t0, tile_counts=counts)


def count_evaluations(sorted_values, tile_start, tile_end, image_pos, conic,
                      color, heatmap_factor, cfg: RasterizerConfig,
                      tile_capacity: int, pixel_offset=(0, 0)) -> int:
    """The (pixel, slot) evaluations the kernel's walk makes on these
    inputs, counted by the kernel on the card (one launch)."""
    evals = torch.zeros(1, dtype=torch.int64, device=sorted_values.device)
    _render_exact_cuda(sorted_values, tile_start, tile_end, image_pos, conic,
                       color, heatmap_factor, cfg, tile_capacity,
                       pixel_offset, evals)
    return int(evals.item())


def render_tiles(sorted_values, tile_start, tile_end, image_pos, conic,
                 color, heatmap_factor, cfg: RasterizerConfig,
                 tile_capacity: int = 2048, tile_batch: int = 16,
                 pixel_offset=(0, 0)) -> RenderOutput:
    """Composite every tile (see the module docstring): CUDA tensors go to
    the kernel, CPU tensors to ``render_tiles_reference``."""
    if sorted_values.device.type == "cpu":
        return render_tiles_reference(sorted_values, tile_start, tile_end,
                                      image_pos, conic, color, heatmap_factor,
                                      cfg, tile_capacity, tile_batch,
                                      pixel_offset)
    return _render_exact_cuda(sorted_values, tile_start, tile_end, image_pos,
                              conic, color, heatmap_factor, cfg,
                              tile_capacity, pixel_offset)
