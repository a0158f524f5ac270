"""Lockstep tile compositing (the v4 render) on the cooked payload.

Counterpart of ``godotgaussiansplatting_tpu/ops/render_pallas4.py``: v3's
semantics tile for tile (ops/render_v3.py), with GT = ``cfg.lockstep_gt``
tiles composited together. The tile list is padded with empty tiles to
T4 * GT, tile g of group t4 being tile t4 * GT + g of the row-major order,
and the output is (T4, GT * NPX, OUT_CH) f32, pixel-major, laid out exactly
as the JAX kernel writes it (``tile_channels_v4`` and ``assemble_image_v4``
unpack it).

The tile rows carry the big depth-bucket prefix (``TileBigs.big_prefix``),
which gates the exact chain-big exchange as in v3. The JAX v4 omits it, so
its gate always fires; the result is the same.

``render_tiles_v4`` launches the CUDA kernel (csrc/render_v4.cu: the cooked
v3 kernel's per-tile pipeline and walk, over the padded tile list and into
v4's layout, bit-identical to the cooked v3 kernel) for CUDA tensors, on
the tile rows alone (``tile_rows``: the kernel evaluates the big lanes
itself, so no ``prepass_big_la`` maps are built).
CPU tensors go to ``render_tiles_v4_reference``: the v3 plain version over
the padded tiles, in v4's layout, which reads the maps.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..config import RasterizerConfig
from .render_v3 import (OUT_CH, check_kernel_inputs, render_tiles_v3_reference,
                        resident_blocks, tile_inputs, tile_rows)


def _pad_tiles(a: torch.Tensor, n: int) -> torch.Tensor:
    """Pad the tile axis with zeros (empty tiles) to n."""
    pad = a.new_zeros((n - a.shape[0],) + tuple(a.shape[1:]))
    return torch.cat([a, pad])


def render_tiles_v4_reference(rows, payload, bigpay, bigla, cfg, U: int,
                              max_batches: int, GT: int,
                              early_exit: bool = True):
    """Plain-torch v4: each group's tiles with v3's per-tile semantics
    (``render_tiles_v3_reference`` over the padded tile list), in v4's
    (T4, GT * NPX, OUT_CH) layout."""
    T = rows.shape[0]
    T4 = -(-T // GT)
    NPX = cfg.tile_size * cfg.tile_size
    tiles = render_tiles_v3_reference(
        _pad_tiles(rows, T4 * GT), payload, _pad_tiles(bigpay, T4 * GT),
        _pad_tiles(bigla, T4 * GT), cfg, U, max_batches, early_exit)
    return tiles.transpose(1, 2).reshape(T4, GT * NPX, OUT_CH)


def _render_v4_cuda(rows, payload, bigpay, cfg, U, max_batches, GT,
                    early_exit):
    """The v4 kernel on (T, 8, 128) tile rows, the cooked payload and the
    (T, 16, OB) big payload -> (T4, GT * NPX, OUT_CH) f32."""
    T = rows.shape[0]
    NPX = cfg.tile_size * cfg.tile_size
    OB = bigpay.shape[2]
    gx, _ = cfg.tile_dims
    if not 1 <= GT <= 4:
        raise ValueError("the render_v4 kernel supports lockstep_gt 1 to 4")
    check_kernel_inputs("render_v4", rows, payload, bigpay, cfg, U,
                        words_ok=False)
    lib = kernels.library("render_v4")
    T4 = -(-T // GT)
    grid = min(T4 * GT, resident_blocks("render_v4", cfg.tile_size, U, OB))
    dev = rows.device
    out = torch.empty((T4, GT * NPX, OUT_CH), dtype=torch.float32, device=dev)
    # per resident thread block, the (pixel, big lane) difference array of
    # the chain mass; the kernel leaves it zero
    dz = torch.zeros((grid, OB, NPX), dtype=torch.float32, device=dev)
    # the kernel writes the padded slots of the last group as empty tiles
    err = lib.gs_render_v4(
        rows.data_ptr(), payload.data_ptr(), bigpay.data_ptr(),
        out.data_ptr(), dz.data_ptr(), T, GT, gx, cfg.tile_size, U,
        max_batches, OB, int(bool(early_exit)), grid,
        ctypes.c_void_p(kernels.stream_ptr(dev)))
    kernels.check(err, "render_v4 kernel launch")
    kernels.count_launch("render_v4")
    return out


def render_tiles_v4(payload, bins, tile_bigs, heatmap_factor, cfg,
                    early_exit: bool = True, lowp: bool = True,
                    pixel_offset_y=0, batch_u: int | None = None):
    """Composite every tile, GT = ``cfg.lockstep_gt`` at a time -> (T4,
    GT * NPX, OUT_CH) f32. CUDA tensors go to the CUDA kernel (or raise),
    CPU tensors to ``render_tiles_v4_reference``. ``lowp`` is accepted for
    signature parity; both compute in f32."""
    del lowp
    GT = cfg.lockstep_gt
    if payload.device.type == "cpu":
        rows, bigla, U, max_batches = tile_inputs(
            bins, tile_bigs, heatmap_factor, cfg, pixel_offset_y, batch_u)
        return render_tiles_v4_reference(rows, payload, tile_bigs.bigpay,
                                         bigla, cfg, U, max_batches, GT,
                                         early_exit)
    rows, U, max_batches = tile_rows(bins, tile_bigs, heatmap_factor, cfg,
                                     pixel_offset_y, batch_u)
    return _render_v4_cuda(rows, payload, tile_bigs.bigpay, cfg, U,
                           max_batches, GT, early_exit)


def tile_channels_v4(tiles: torch.Tensor, cfg: RasterizerConfig):
    """(T4, GT * NPX, C) -> (T, NPX, C) per true tile."""
    gx, gy = cfg.tile_dims
    NPX = cfg.tile_size * cfg.tile_size
    C = tiles.shape[-1] if tiles.ndim == 3 else 1
    return tiles.reshape(-1, NPX, C)[:gx * gy]


def assemble_image_v4(tiles: torch.Tensor, cfg: RasterizerConfig):
    """(T4, GT * NPX, OUT_CH) -> ((4, H, W) planar image, (T, NPX) t_final)."""
    gx, gy = cfg.tile_dims
    ts = cfg.tile_size
    w, h = cfg.target_size
    T = gx * gy
    NPX = ts * ts
    t_final = tile_channels_v4(tiles, cfg)[:, :, 4]
    chp = tiles.permute(2, 0, 1)[:4].reshape(4, -1, NPX)[:, :T]
    img = chp.reshape(4, gy, gx, ts, ts)
    img = img.permute(0, 1, 3, 2, 4).reshape(4, gy * ts, gx * ts)
    return img[:, :h, :w], t_final
