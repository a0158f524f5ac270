"""Streaming splat upload: host .ply -> device SoA, chunk by chunk.

Counterpart of ``godotgaussiansplatting_tpu/engine/loader.py``
(``PlyFile.load_gaussian_splats``, ply_file.gd:28-77): a background thread
swizzles the model and writes it, chunk by chunk, into the live cloud while
frames render, with a progress counter, a cancel flag and a completion
callback; each chunk's upload time drives the per-splat fade-in. The
swizzle is ``models/ply.splat_soa_from_ply``, as for every .ply load of the
port: the native one where it is built (the JAX loader takes the numpy
swizzle and builds each chunk's covariance in numpy; the two covariances
differ in rounding).

The device SoA is allocated once, zero-filled (inert: opacity 0). Each chunk
is an in-place ``copy_`` into a slice of it, which replaces JAX's donated
``dynamic_update_slice``. On the card the chunk goes through pinned host
memory with ``non_blocking=True`` on the loader thread's current stream,
the device's default stream, which frames are enqueued on too, so a frame
reads a chunk either wholly before or wholly after its write. A chunk's
pinned buffers are kept until an event recorded after its copies has
completed. ``write_lock`` is held around each chunk's writes; frames take
it while they snapshot the cloud and enqueue their work, as in the JAX
package.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from ..models import ply as plyio
from ..models.splats import PAD_MULTIPLE, SplatCloud


class StreamingLoader:
    """Loads a parsed PLY into a live SplatCloud from a background thread.

      num_splats_loaded  progress counter (ply_file.gd:72-74)
      cancel()           the should_terminate flag (ply_file.gd:35,70)
      on_loaded          completion callback (the ``loaded`` signal)
      cloud              the live, partially filled SplatCloud
      writes             chunks written so far: a reader holding write_lock
                         sees the cloud change only when it moves
      seconds            once loaded: the swizzle, order and upload times
      error              the worker's traceback, if it raised

    ``morton=True`` orders the splats by ``ops.blocks.morton_order`` before
    chunking, as the JAX loader does (the non-streamed fast path orders
    along a Hilbert curve instead).
    """

    def __init__(self, ply: plyio.PlyFile, chunks: int = 64,
                 on_loaded: Optional[Callable[[], None]] = None,
                 time_fn: Callable[[], float] = time.monotonic,
                 morton: bool = False, device="cuda"):
        self._ply = ply
        self._morton = morton
        self._chunks = max(1, min(chunks, ply.size))
        self._on_loaded = on_loaded
        self._time_fn = time_fn
        self._cancel = False
        self._lock = threading.Lock()
        self.write_lock = threading.RLock()
        self.num_splats_loaded = 0
        self.writes = 0            # chunks written (under write_lock)
        self._pending: list = []   # (event, pinned buffers) of chunk copies
        self.seconds: dict = {}
        self.error: Optional[str] = None   # the worker's traceback

        n = ply.size
        cap = max(PAD_MULTIPLE, -(-n // PAD_MULTIPLE) * PAD_MULTIPLE)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        self.cloud = SplatCloud(means=z(cap, 3), cov3d=z(cap, 6),
                                opacity=z(cap), sh=z(cap, 16, 3),
                                upload_time=z(cap), num_splats=n)
        self._thread: Optional[threading.Thread] = None

    # -- control -----------------------------------------------------------

    def start(self) -> "StreamingLoader":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._cancel = True

    def join(self, timeout=None) -> None:
        if self._thread:
            self._thread.join(timeout)

    @property
    def is_loading(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def progress(self) -> float:
        return self.num_splats_loaded / max(1, self._ply.size)

    # -- worker ------------------------------------------------------------

    def _write_chunk(self, lo: int, arrays) -> None:
        """Copy one chunk's host arrays into the cloud at ``lo``."""
        cl = self.cloud
        dsts = (cl.means, cl.cov3d, cl.opacity, cl.sh, cl.upload_time)
        if cl.means.device.type != "cuda":
            for dst, a in zip(dsts, arrays):
                dst[lo:lo + a.shape[0]].copy_(torch.from_numpy(a))
            return
        self._pending = [(e, b) for e, b in self._pending if not e.query()]
        bufs = [torch.from_numpy(a).pin_memory() for a in arrays]
        for dst, b in zip(dsts, bufs):
            dst[lo:lo + b.shape[0]].copy_(b, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending.append((done, bufs))

    def _run(self) -> None:
        try:
            self._load()
        except Exception:
            self.error = traceback.format_exc()
            raise

    def _load(self) -> None:
        ply = self._ply
        n = ply.size
        stride = -(-n // self._chunks)
        t0 = time.perf_counter()
        soa = plyio.splat_soa_from_ply(ply)
        t1 = time.perf_counter()
        if self._morton:
            from ..ops.blocks import morton_order
            order = morton_order(soa[0])
            soa = tuple(a[order] for a in soa)
        t2 = time.perf_counter()
        means, cov6, opac, sh = soa
        for c in range(self._chunks):
            if self._cancel:
                break
            lo = c * stride
            hi = min(n, lo + stride)
            if lo >= hi:
                break
            now = np.float32(self._time_fn())
            with self.write_lock:
                self._write_chunk(lo, (
                    np.ascontiguousarray(means[lo:hi]),
                    np.ascontiguousarray(cov6[lo:hi]),
                    np.ascontiguousarray(opac[lo:hi]),
                    np.ascontiguousarray(sh[lo:hi]),
                    np.full((hi - lo,), now, np.float32)))
                self.writes += 1
            with self._lock:
                self.num_splats_loaded += hi - lo
        for done, _ in self._pending:
            done.synchronize()
        self._pending = []
        self.seconds = {"swizzle": t1 - t0, "order": t2 - t1,
                        "upload": time.perf_counter() - t2}
        if self._cancel:
            return
        if self._on_loaded:
            self._on_loaded()
