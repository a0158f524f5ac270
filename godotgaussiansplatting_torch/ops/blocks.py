"""Clustering constants and the load-time space-filling-curve order.

Counterpart of ``godotgaussiansplatting_tpu/ops/blocks.py``. Host-side numpy
(the Morton codes from the native library where it is built), run once at
load: ordering splats along a 3D curve gives consecutive
128-splat runs ("bricks") compact world-space extents, so their projected
tile rects and depth ranges stay tight for any camera. The shipped curve is
Hilbert; the JAX package's sweep-only environment overrides are constants
here.
"""

from __future__ import annotations

import numpy as np

BLOCK_SIZE = 128    # splats per block
SUPERBLOCK = 8192   # splats per stage-1 row (the "screen" clustering sort)
BIG_RADIUS = 32.0   # px; splats at least this wide go to per-tile big lanes


def _quantize(means: np.ndarray, bits: int) -> np.ndarray:
    p = np.asarray(means, np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-9)
    return np.clip((p - lo) / span * (2**bits - 1), 0, 2**bits - 1)


def morton_order(means: np.ndarray, bits: int = 10) -> np.ndarray:
    """Argsort of splat positions along the 3D Morton (Z) curve: the codes
    of the native ``morton3`` (quantised in f32, 10 bits an axis) where it
    is available, as in the JAX package, else numpy's (quantised in f64 at
    ``bits``). The two can differ at cell boundaries."""
    from .. import native
    if native.available():
        return np.argsort(native.morton3(np.asarray(means, np.float32)),
                          kind="stable")
    q = _quantize(means, bits).astype(np.uint64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2))
    return np.argsort(code, kind="stable")


def hilbert_order(means: np.ndarray, bits: int = 10) -> np.ndarray:
    """Argsort of splat positions along the 3D Hilbert curve (Skilling's
    transpose algorithm, vectorised numpy). Unlike the Z curve it has no
    jumps, so consecutive bricks bound tighter boxes."""
    X = _quantize(means, bits).astype(np.int64)
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:                      # inverse-undo + exchange (Skilling)
        P = Q - 1
        for i in range(3):
            cond = (X[:, i] & Q) != 0
            X[:, 0] = np.where(cond, X[:, 0] ^ P, X[:, 0])
            t = np.where(cond, 0, (X[:, 0] ^ X[:, i]) & P)
            X[:, 0] ^= t
            X[:, i] ^= t
        Q >>= 1
    X[:, 1] ^= X[:, 0]                # Gray encode
    X[:, 2] ^= X[:, 1]
    t = np.zeros(len(X), dtype=np.int64)
    Q = M
    while Q > 1:
        t = np.where((X[:, 2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(3):
        X[:, i] ^= t
    key = np.zeros(len(X), dtype=np.int64)
    for j in range(bits - 1, -1, -1):  # transpose-form bit interleave
        for i in range(3):
            key = (key << 1) | ((X[:, i] >> j) & 1)
    return np.argsort(key, kind="stable")


def order_splats(means: np.ndarray, bits: int = 10) -> np.ndarray:
    """The shipped load-time ordering: the Hilbert curve."""
    return hilbert_order(means, bits)
