"""Rank processes for tests/test_torch_sharded.py (not collected by pytest).

``Ranks(world, directory)`` spawns ``world`` processes that import torch and
the port only (no JAX), join one gloo world on the CPU (a FileStore under
``directory``) and serve jobs from a queue each. ``Ranks.run(name, **kw)``
sends the job to every rank, so collectives and ``make_mesh``'s
``new_group`` calls line up, and returns each rank's result. Inputs and
results cross as numpy arrays. A job that fails on any rank raises in the
caller, and the processes are started anew for the next job.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from godotgaussiansplatting_torch.models.splats import cloud_from_numpy
from godotgaussiansplatting_torch.ops import binning2
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.blocks2 import BigSet, BlockFrame2
from godotgaussiansplatting_torch.ops.pipeline import FrameUniforms
from godotgaussiansplatting_torch.parallel import sharded

COLLECTIVE_TIMEOUT_S = 120


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    if isinstance(t, tuple):
        return type(t)(*(_np(x) for x in t)) if hasattr(t, "_fields") else (
            tuple(_np(x) for x in t))
    return t


def _mesh(meshes: dict, n_view: int, n_tile: int):
    """One Mesh per shape and process: every rank builds it at the same
    job, so the new_group calls line up."""
    if (n_view, n_tile) not in meshes:
        meshes[n_view, n_tile] = sharded.make_mesh(
            n_view, n_tile, device="cpu", backend="gloo")
    return meshes[n_view, n_tile]


def _cloud(c: dict):
    return cloud_from_numpy(c["means"], c["cov3d"], c["opacity"], c["sh"],
                            c["upload_time"], c["num_splats"], device="cpu")


def _unis(u) -> FrameUniforms:
    return FrameUniforms(*(torch.from_numpy(np.asarray(a)) for a in u))


def job_mesh(meshes, n_view, n_tile):
    m = _mesh(meshes, n_view, n_tile)
    return {"shape": m.shape, "member": m.member, "view": m.view,
            "tile": m.tile, "device": str(m.device), "backend": m.backend,
            "row": (None if not m.member
                    else dist.get_process_group_ranks(m.tile_group))}


def job_mesh_error(meshes, n_view, n_tile, **kw):
    try:
        sharded.make_mesh(n_view, n_tile, **kw)
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def job_frame(meshes, fast, cloud, unis, cfg, n_view, n_tile, **kw):
    """A sharded frame of this rank's ``shard_cloud`` of the cloud."""
    fn = (sharded.render_frame_fast_sharded if fast
          else sharded.render_frame_sharded)
    mesh = _mesh(meshes, n_view, n_tile)
    shard = sharded.shard_cloud(_cloud(cloud), mesh)
    return _np(fn(shard, _unis(unis), cfg, mesh, **kw))


def job_traffic(meshes, n_view, n_tile, **kw):
    """A frame's collective traffic on this rank (Mesh.traffic)."""
    mesh = _mesh(meshes, n_view, n_tile)
    mesh.traffic.clear()
    job_frame(meshes, n_view=n_view, n_tile=n_tile, **kw)
    return dict(mesh.traffic)


def job_exchange(meshes, blocks, bigs, cfg, n_view, n_tile, k_x):
    """The fast path's exchange on given per-shard block frames and big
    sets (lists indexed by tile): this rank's pool, big set, tile bins and
    big bins, and its exchange overflow."""
    m = _mesh(meshes, n_view, n_tile)
    if not m.member:
        return None
    bf = BlockFrame2(*(torch.from_numpy(a) for a in blocks[m.tile]))
    bg = BigSet(*(torch.from_numpy(np.asarray(a)) for a in bigs[m.tile]))
    rows_per = sharded._slab_rows(cfg, n_tile)
    pool, over = sharded.exchange_blocks(bf, m, rows_per, k_x)
    bigs_all = sharded.gather_bigs(bg, m)
    slab_cfg = sharded._slab_cfg(cfg, rows_per)
    y0 = m.tile * rows_per
    bins = binning2.bin_blocks2(pool, slab_cfg, tile_row_offset=y0)
    tile_bigs = bin_bigs(bigs_all, slab_cfg, tile_row_offset=y0)
    return _np((pool, bigs_all, bins, tile_bigs, over))


JOBS = {"mesh": job_mesh, "mesh_error": job_mesh_error, "frame": job_frame,
        "traffic": job_traffic, "exchange": job_exchange}


def serve(rank: int, world: int, init: str, jobs, results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    meshes: dict = {}
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            name, kw = job
            try:
                results.put((rank, True, JOBS[name](meshes, **kw)))
            except Exception:   # reported to the test, which raises it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` spawned gloo ranks serving jobs (see module docstring)."""

    def __init__(self, world: int, directory):
        self.world = world
        self.directory = directory
        self.starts = 0
        self.procs: list = []
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self.starts += 1
        init = f"file://{self.directory}/store{self.starts}"
        self.jobs = [ctx.Queue() for _ in range(self.world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=serve, daemon=True,
                                  args=(r, self.world, init, self.jobs[r],
                                        self.results))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, timeout: float = 600, **kw) -> list:
        """Each rank's result of job ``name``; raises if any rank failed."""
        if not self.procs:
            self._start()
        for q in self.jobs:
            q.put((name, kw))
        out: list = [None] * self.world
        failed = []
        try:
            for _ in range(self.world):
                rank, ok, value = self.results.get(timeout=timeout)
                if ok:
                    out[rank] = value
                else:
                    failed.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            failed.append(f"no result within {timeout} s")
        if failed:
            self.close()
            raise RuntimeError(f"job {name} failed:\n" + "\n".join(failed))
        return out

    def close(self) -> None:
        for q, p in zip(self.jobs, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
        self.procs = []
