"""Multi-device rendering over a (view, tile) grid of torch.distributed ranks.

Counterpart of ``godotgaussiansplatting_tpu/parallel/sharded.py``, which
runs the same steps under ``shard_map`` over a ``jax.sharding.Mesh``. Here
each rank is one process with one device. The caller starts the processes
and calls ``torch.distributed.init_process_group`` (the address, the world
size and the rank are the caller's); then every rank calls the same
functions with the same arguments, as a JAX caller passes global arrays:

* axis "view": cameras are a batch axis; view row v renders camera v of the
  stacked uniforms (``stack_uniforms``);
* axis "tile": rank t of a view row takes the t-th contiguous shard of the
  splat axis (JAX's ``P("tile")``) and renders the t-th slab of tile rows.
  ``shard_cloud`` moves that slice alone to the rank's device, once, as JAX
  places a global array with its sharding: the device holds O(N/D) splats,
  and the frame functions take the shard, so no frame moves them again.

Tile-row slabs are padded to ceil(rows / n_tile), so any resolution shards
on any rank count (1080p at tile 32 has 34 rows: 9-row slabs 4 ways); the
result crops the padding. Every rank of the mesh returns what the JAX
function's global arrays hold: each view's slabs concatenated along H, the
views stacked, and the counts summed over each view row.

The exact path all-gathers the projected splats over the view row. The fast
path builds its blocks from its shard alone and sends each block, with one
fixed-capacity ``all_to_all_single``, to the slabs its rect intersects;
blocks beyond the cap are counted (``num_exchange_overflow``), not lost
silently.

Backends: ``nccl`` when each rank has its own card; ``gloo`` when the
caller asks for it: on the CPU, or for ranks that share one card (NCCL
refuses two ranks on one GPU). Over gloo, CUDA buffers are copied to the
host and back explicitly around each collective (``Mesh.staged``).

u32 words travel as int32 bit patterns (ops/blocks2.py) and are widened
with ``u32`` before a shift or a compare.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from ..config import RasterizerConfig
from ..models.splats import SplatCloud
from ..ops.bigbin import bin_bigs
from ..ops.binning2 import bin_blocks2
from ..ops.blocks2 import (BLOCK_SIZE, U32_MAX, BigSet, BlockFrame2,
                           build_block_frame2, build_block_frame2_words, i32,
                           u32)
from ..ops.pipeline import FrameUniforms
from ..ops.projection import project_splats
from ..ops.projection_kernel import project_words
from ..ops.render_exact import render_tiles
from ..ops.render_v3 import assemble_image_v3, render_tiles_v3
from ..ops.sort import emit_and_sort, tile_boundaries


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (view, tile) grid (see ``make_mesh``)."""

    shape: dict            # {"view": n_view, "tile": n_tile}
    view: int | None       # this rank's view row; None outside the mesh
    tile: int | None       # its slab within that row
    device: torch.device
    backend: str
    group: object = None       # every rank of the mesh
    tile_group: object = None  # the ranks of this rank's view row
    # bytes this rank's collectives moved, by what they carried:
    # {what: {"calls", "buffer" (its input), "sent" and "received" (to and
    # from the other ranks)}}; the caller may clear it
    traffic: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def member(self) -> bool:
        return self.view is not None

    @property
    def staged(self) -> bool:
        """gloo's collectives take host tensors: CUDA buffers go through
        the host."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(n_view: int = 1, n_tile: int | None = None, *, device="cuda",
              backend: str | None = None) -> Mesh:
    """The (n_view, n_tile) grid over the first n_view * n_tile ranks of
    the world, row-major as JAX's ``reshape(n_view, n_tile)``: rank i of
    the grid is view i // n_tile, tile i % n_tile.
    ``backend`` defaults to ``nccl``; pass ``gloo`` for CPU tensors or for
    ranks that share a card. Every process of the world must call this, in
    the same order (``new_group`` is collective); a rank outside the grid
    gets a Mesh whose ``member`` is False and takes no part in a frame."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group to have run")
    ranks = list(range(dist.get_world_size()))
    if n_tile is None:
        n_tile = len(ranks) // n_view
    if n_view < 1 or n_tile < 1 or n_view * n_tile > len(ranks):
        raise ValueError(f"a ({n_view}, {n_tile}) mesh needs "
                         f"{n_view * n_tile} ranks; the world has "
                         f"{len(ranks)}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or "nccl"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl moves CUDA tensors only: pass backend='gloo' "
                         "for a mesh on the CPU")
    grid = ranks[:n_view * n_tile]
    mesh_group = dist.new_group(grid, backend=backend)
    rows = [dist.new_group(grid[v * n_tile:(v + 1) * n_tile], backend=backend)
            for v in range(n_view)]
    shape = {"view": n_view, "tile": n_tile}
    me = dist.get_rank()
    if me not in grid:
        return Mesh(shape, None, None, device, backend)
    view, tile = divmod(grid.index(me), n_tile)
    return Mesh(shape, view, tile, device, backend, mesh_group, rows[view])


def stack_uniforms(unis) -> FrameUniforms:
    """Stack per-camera FrameUniforms into the view-batched form."""
    return FrameUniforms(*(torch.stack(fields) for fields in zip(*unis)))


# --- collectives -------------------------------------------------------------

def _wire(mesh: Mesh, t: torch.Tensor, group, what: str,
          per_peer: int) -> torch.Tensor:
    """``t`` as the collective takes it, its traffic counted: ``per_peer``
    bytes sent to and received from each other rank of ``group``."""
    t = t.contiguous()
    peers = dist.get_world_size(group) - 1
    rec = mesh.traffic.setdefault(
        what, {"calls": 0, "buffer": 0, "sent": 0, "received": 0})
    rec["calls"] += 1
    rec["buffer"] += t.numel() * t.element_size()
    rec["sent"] += per_peer * peers
    rec["received"] += per_peer * peers
    return t.cpu() if mesh.staged else t


def all_gather_cat(mesh: Mesh, t: torch.Tensor, group,
                   what: str) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along axis 0 in rank
    order (JAX's ``all_gather(..., tiled=True)``)."""
    x = _wire(mesh, t, group, what, t.numel() * t.element_size())
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(t.device)


def all_to_all(mesh: Mesh, t: torch.Tensor, group, what: str) -> torch.Tensor:
    """Chunk d of ``t``'s axis 0 goes to rank d of ``group``; chunk s of the
    result came from rank s (JAX's ``all_to_all(split_axis=0,
    concat_axis=0)``)."""
    n = dist.get_world_size(group)
    x = _wire(mesh, t, group, what, t.numel() * t.element_size() // n)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out.to(t.device)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor, group,
                   what: str) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (JAX's ``psum``)."""
    x = _wire(mesh, t, group, what, t.numel() * t.element_size()).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device)


# --- shared steps ------------------------------------------------------------

def _slab_rows(cfg: RasterizerConfig, n_tile: int) -> int:
    """Rows of tiles per slab (the tile grid split along y, padded)."""
    return -(-cfg.tile_dims[1] // n_tile)


def _slab_cfg(cfg: RasterizerConfig, rows_per: int, **kw) -> RasterizerConfig:
    return cfg.replace(height=rows_per * cfg.tile_size,
                       width=cfg.target_size[0], render_scale=1.0, **kw)


def _stage_of(timer):
    return timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())


@dataclasses.dataclass(frozen=True)
class CloudShard:
    """One rank's contiguous shard of a cloud, on its device (see
    ``shard_cloud``)."""

    local: SplatCloud   # the shard's tensors; num_splats the FULL count
    capacity: int       # the full cloud's capacity

    @property
    def num_splats(self) -> int:
        return self.local.num_splats


def shard_cloud(cloud: SplatCloud, mesh: Mesh) -> CloudShard | None:
    """This rank's shard ``[t * P / n_tile, (t + 1) * P / n_tile)`` of the
    splat axis of ``cloud`` (on any device), moved to the rank's device
    (None outside the mesh): what the frame functions take, in place of
    the JAX functions' full cloud."""
    if not mesh.member:
        return None
    n_tile = mesh.shape["tile"]
    P = cloud.capacity
    if P % n_tile:
        raise ValueError(f"capacity {P} does not split across {n_tile} "
                         "devices")
    a, b = mesh.tile * (P // n_tile), (mesh.tile + 1) * (P // n_tile)
    sh = cloud.sh[:, a:b] if cloud.sh.ndim == 2 else cloud.sh[a:b]

    def put(x):
        return x.to(mesh.device).contiguous()

    local = dataclasses.replace(
        cloud, means=put(cloud.means[a:b]), cov3d=put(cloud.cov3d[a:b]),
        opacity=put(cloud.opacity[a:b]), sh=put(sh),
        upload_time=put(cloud.upload_time[a:b]))
    return CloudShard(local=local, capacity=P)


def _shard_args(shard: CloudShard, uniforms: FrameUniforms, mesh: Mesh):
    """The shard's tensors and its view's uniforms on the rank's device:
    the projections' positional arguments, then the heatmap factor."""
    c = shard.local
    return (c.means, c.cov3d, c.opacity, c.sh, c.upload_time,
            *(f[mesh.view].to(mesh.device) for f in uniforms))


def _gather_views(mesh: Mesh, slab: torch.Tensor, counts: torch.Tensor,
                  h: int, axis: int):
    """Every mesh rank's slab and counts -> (images (n_view, ...) with each
    view row's slabs concatenated along the slab's ``axis`` and cropped to
    ``h``, then each count (n_view,) i32 summed over the view row: the psum
    over "tile" of sharded.py:122-124 and :285-287)."""
    n_view, n_tile = mesh.shape["view"], mesh.shape["tile"]
    imgs = all_gather_cat(mesh, slab[None], mesh.group, "image")
    imgs = imgs.reshape(n_view, n_tile, *slab.shape)
    imgs = torch.cat(imgs.unbind(1), dim=1 + axis).narrow(1 + axis, 0, h)
    cnt = all_gather_cat(mesh, counts[None], mesh.group, "counts")
    cnt = cnt.reshape(n_view, n_tile, -1).sum(dim=1).to(torch.int32)
    return (imgs, *cnt.unbind(1))


# --- exact path --------------------------------------------------------------

def render_frame_sharded(shard: CloudShard, uniforms: FrameUniforms,
                         cfg: RasterizerConfig, mesh: Mesh,
                         tile_capacity: int = 512,
                         pairs_per_device: int | None = None, *, timer=None):
    """One exact frame over the mesh (sharded.py:60-141): project the shard,
    all-gather the projected splats over the view row, clip their rects to
    this rank's slab, sort, find the boundaries and composite the slab.

    ``shard`` is this rank's ``shard_cloud`` (None outside the mesh);
    ``uniforms`` carries a leading view axis of size
    ``mesh.shape["view"]``. Returns (images (n_view, H, W, 4), num_pairs
    (n_view,), num_slab_overflow (n_view,)) on every mesh rank, None on a
    rank outside it; num_slab_overflow counts the pairs a slab's buffer of
    ``pairs_per_device`` (default ``sort_buffer_factor * P / n_tile``)
    dropped. The per-slab boundaries run without the reference's last-run
    quirk (it would drop one run per slab), so the image is the quirk-free
    one. ``timer.stage(name)`` (e.g. ``StageTimer``) times Projection,
    All-gather, Sort, Boundaries, Render and Gather."""
    if not mesh.member:
        return None
    n_tile = mesh.shape["tile"]
    rows_per = _slab_rows(cfg, n_tile)
    k_local = pairs_per_device or (cfg.sort_buffer_factor * shard.capacity
                                   // n_tile)
    stage = _stage_of(timer)
    y0 = mesh.tile * rows_per
    with stage("Projection"):
        args = _shard_args(shard, uniforms, mesh)
        prj = project_splats(*args[:10], cfg)
    with stage("All-gather"):
        # the fields the slab reads, in two buffers (the JAX package gathers
        # the whole tuple and XLA drops the gathers no one reads)
        f = all_gather_cat(mesh, torch.cat(
            [prj.image_pos, prj.conic, prj.color], dim=1), mesh.tile_group,
            "splats")
        m = all_gather_cat(mesh, torch.cat(
            [prj.valid[:, None].to(torch.int32), prj.depth16[:, None],
             prj.rect], dim=1), mesh.tile_group, "splats")
        image_pos, conic, color = (f[:, :2].contiguous(),
                                   f[:, 2:5].contiguous(),
                                   f[:, 5:9].contiguous())
        valid, depth16, rect = m[:, 0] != 0, m[:, 1], m[:, 2:6]
    with stage("Sort"):
        ry0 = rect[:, 1].clamp(y0, y0 + rows_per)
        ry1 = rect[:, 3].clamp(y0, y0 + rows_per)
        srect = torch.stack([rect[:, 0], ry0 - y0, rect[:, 2], ry1 - y0],
                            dim=-1)
        snt = ((srect[:, 2] - srect[:, 0]).clamp(min=0)
               * (srect[:, 3] - srect[:, 1]).clamp(min=0))
        svalid = valid & (snt > 0)
        snt = torch.where(svalid, snt, 0)
        slab_cfg = _slab_cfg(cfg, rows_per, reference_boundary_quirk=False)
        pairs = emit_and_sort(svalid, srect, snt, depth16, slab_cfg,
                              capacity=k_local)
    with stage("Boundaries"):
        start, end = tile_boundaries(pairs.keys, pairs.num_pairs, slab_cfg)
    with stage("Render"):
        out = render_tiles(pairs.values, start, end, image_pos, conic, color,
                           args[10], slab_cfg, tile_capacity=tile_capacity,
                           pixel_offset=(0, y0 * cfg.tile_size))
    with stage("Gather"):
        n = pairs.num_pairs.to(torch.int64)
        return _gather_views(mesh, out.image,
                             torch.stack([n, (n - k_local).clamp(min=0)]),
                             cfg.target_size[1], axis=0)


# --- fast path ---------------------------------------------------------------

def exchange_shape(capacity: int, n_tile: int,
                   exchange_cap: int | None = None) -> tuple:
    """(b_local, k_x): the blocks of one shard, and the exchange's block
    budget per (source, destination) pair: by default 4 * b_local / n_tile,
    at least 16, clamped to b_local (a lossless exchange whenever a shard's
    blocks fit), as sharded.py:179-184."""
    if capacity % (BLOCK_SIZE * n_tile):
        raise ValueError(f"capacity {capacity} must split into whole blocks "
                         f"across {n_tile} devices")
    b_local = capacity // BLOCK_SIZE // n_tile
    k_x = exchange_cap or min(b_local, max(-(-4 * b_local // n_tile), 16))
    return b_local, min(k_x, b_local)


def exchange_blocks(bf: BlockFrame2, mesh: Mesh, rows_per: int, k_x: int):
    """This rank's blocks -> (the pool of blocks whose rects intersect its
    slab, from every rank of its view row in rank order, n_tile * k_x
    blocks; the blocks this rank dropped at the k_x cap) (sharded.py:
    216-254). Each destination takes the first k_x intersecting non-empty
    blocks in block order; an unused slot carries block 0's payload, an
    empty rect, bitmap 0, depths 0xFFFF and no valid splat."""
    n_tile = mesh.shape["tile"]
    dev = bf.rect.device
    r = bf.rect.to(torch.int64)
    nonempty = (r[:, 2] > r[:, 0]) & (r[:, 3] > r[:, 1])
    dy0 = rows_per * torch.arange(n_tile, dtype=torch.int64,
                                  device=dev)[:, None]
    inter = ((r[:, 1][None] < dy0 + rows_per) & (r[:, 3][None] > dy0)
             & nonempty[None])                       # (n_tile, B_local)
    iota = torch.arange(r.shape[0], dtype=torch.int64, device=dev)
    selkey = torch.sort(torch.where(inter, iota[None], U32_MAX),
                        dim=1).values[:, :k_x]
    sel_ok = selkey != U32_MAX
    sel = torch.where(sel_ok, selkey, 0).reshape(-1)
    over = (inter.sum(dim=1) - k_x).clamp(min=0).sum()

    def take(a):
        return a[sel].reshape(n_tile, k_x, *a.shape[1:])

    ok = sel_ok[..., None]
    minmax = (u32(bf.min_depth) << 16) | (u32(bf.max_depth) & 0xFFFF)
    meta = torch.cat([                                # (n_tile, k_x, 7) i32
        torch.where(ok, take(bf.rect), 0),
        torch.where(ok, take(bf.bitmap)[..., None], 0),
        i32(torch.where(ok, take(minmax)[..., None], U32_MAX)),
        torch.where(ok, take(bf.num_valid)[..., None], 0)], dim=2)
    payload = all_to_all(mesh, take(bf.payload), mesh.tile_group, "blocks")
    meta = all_to_all(mesh, meta, mesh.tile_group, "blocks").reshape(
        n_tile * k_x, 7)
    minmax = u32(meta[:, 5])                          # logical shifts
    pool = BlockFrame2(
        payload=payload.reshape(n_tile * k_x, *bf.payload.shape[1:]),
        rect=meta[:, :4].contiguous(), bitmap=meta[:, 4].contiguous(),
        min_depth=(minmax >> 16).to(torch.int32),
        max_depth=(minmax & 0xFFFF).to(torch.int32),
        num_valid=meta[:, 6].contiguous(),
        num_culled_pairs=bf.num_culled_pairs)
    return pool, over


def gather_bigs(bigs: BigSet, mesh: Mesh) -> BigSet:
    """Every rank's big lanes in one table re-sorted, stably, by (depth16,
    source index) (sharded.py:262-279): ops/bigbin.py's compaction takes
    table position as the front-to-back rank, and each rank's table is
    sorted only locally. The residual is summed."""
    g = mesh.tile_group
    table = all_gather_cat(mesh, bigs.table, g, "bigs")
    meta = all_gather_cat(mesh, torch.cat(
        [bigs.depth16[:, None], bigs.rect,
         bigs.valid[:, None].to(torch.int32)], dim=1), g, "bigs")
    key = (u32(meta[:, 0]) << 32) | u32(table[:, 13].view(torch.int32))
    order = torch.sort(key, stable=True).indices
    meta = meta[order]
    return BigSet(table=table[order], depth16=meta[:, 0].contiguous(),
                  rect=meta[:, 1:5].contiguous(), valid=meta[:, 5] != 0,
                  residual=all_reduce_sum(mesh, bigs.residual, g, "bigs"))


def render_frame_fast_sharded(shard: CloudShard, uniforms: FrameUniforms,
                              cfg: RasterizerConfig, mesh: Mesh,
                              supertile_cap: int = 1024, tile_cap: int = 256,
                              exchange_cap: int | None = None,
                              lowp: bool = True, *, timer=None):
    """One fast frame over the mesh (sharded.py:144-305): projection and the
    block build run on this rank's shard (superblocks never cross a shard
    boundary when the shard is a whole number of them, so the blocks are
    the single-device ones), the blocks move to the slabs their rects
    intersect (``exchange_blocks``), the big lanes are gathered
    (``gather_bigs``), and each rank bins and composites its slab with the
    v3 kernel.

    Returns (images (n_view, 4, H, W) planar, num_pairs (n_view,),
    num_exchange_overflow (n_view,)) on every mesh rank, None outside it.
    ``exchange_cap`` is the per-(source, destination) block budget
    (``exchange_shape``). ``lowp`` is accepted for signature parity; the
    port computes in f32. ``timer.stage(name)`` times Projection, Blocks,
    Exchange, Binning, Render and Gather."""
    if not mesh.member:
        return None
    n_tile = mesh.shape["tile"]
    rows_per = _slab_rows(cfg, n_tile)
    _, k_x = exchange_shape(shard.capacity, n_tile, exchange_cap)
    stage = _stage_of(timer)
    y0 = mesh.tile * rows_per
    with stage("Projection"):
        args = _shard_args(shard, uniforms, mesh)
        # num_splats stays the FULL count: it sets the screen-cell
        # granularity, which must match the single-device frame's
        if cfg.projection_kernel:
            prj = project_words(*args[:10], cfg, num_splats=shard.num_splats)
        else:
            prj = project_splats(*args[:10], cfg)
    with stage("Blocks"):
        if cfg.projection_kernel:
            # the words carry the cell shift project_words chose, so the
            # port's build_block_frame2_words takes no num_splats
            bf, bigs = build_block_frame2_words(
                prj, cfg, big_cap=cfg.big_capacity,
                words_payload=cfg.words_payload)
        else:
            bf, bigs = build_block_frame2(
                prj, cfg, num_splats=shard.num_splats,
                big_cap=cfg.big_capacity, words_payload=cfg.words_payload)
    with stage("Exchange"):
        pool, over = exchange_blocks(bf, mesh, rows_per, k_x)
        bigs_all = gather_bigs(bigs, mesh)
    with stage("Binning"):
        slab_cfg = _slab_cfg(cfg, rows_per)
        bins = bin_blocks2(pool, slab_cfg, supertile_cap=supertile_cap,
                           tile_cap=tile_cap, tile_row_offset=y0)
        # bin_bigs' default obig (128), not cfg.big_tile_capacity, as
        # sharded.py:280 calls it
        tile_bigs = bin_bigs(bigs_all, slab_cfg, tile_row_offset=y0)
    with stage("Render"):
        tiles = render_tiles_v3(pool.payload, bins, tile_bigs, args[10],
                                slab_cfg, lowp=lowp,
                                pixel_offset_y=y0 * cfg.tile_size)
        image, _ = assemble_image_v3(tiles, slab_cfg)   # (4, H_slab, W)
    with stage("Gather"):
        return _gather_views(
            mesh, image,
            torch.stack([bf.num_culled_pairs.to(torch.int64), over]),
            cfg.target_size[1], axis=1)
