"""The comparison that decides ``correct``: the renderer's sample frames,
taken from the window, against the plain reference's frames of the same
scene and cameras.

Numbers (each the worst over the sample cameras; a cell compares those
that its ``limits/<cell>.json`` gives a limit, each set between the
renderer's readings and the bfloat16 control's, ``control.py``):

  image_rmse   RMS over pixels and RGB of the renderer's image less the
               reference's;
  tile_rmse    the same RMS over each 16 x 16 pixel tile, the worst tile;
  pairs_rel    |rendered_splats - reference's| / reference's: the exact
               frame's emitted pairs, the fast frame's (splat, tile) pairs
               on its own tile grid (``fast_pairs``);
  dropped_rel  |pair_overflow_dropped - reference's| / reference's pairs
               (the exact frame's caps);
  max_tile_rel |max_tile_count - reference's| / reference's (the exact
               frame's densest tile list).
"""

from __future__ import annotations

import math

import numpy as np

TILE = 16


def _rms(d: np.ndarray) -> float:
    return float(np.sqrt(np.mean(d.astype(np.float64) ** 2)))


def _tile_rms(d: np.ndarray) -> float:
    h, w, c = d.shape
    hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
    sq = np.zeros((hp, wp, c), np.float64)
    sq[:h, :w] = d.astype(np.float64) ** 2
    # each tile's mean over its in-image pixels
    n = np.zeros((hp, wp), np.float64)
    n[:h, :w] = 1.0
    s = sq.reshape(hp // TILE, TILE, wp // TILE, TILE, c).sum(axis=(1, 3, 4))
    k = n.reshape(hp // TILE, TILE, wp // TILE, TILE).sum(axis=(1, 3)) * c
    return float(np.sqrt((s / k).max()))


def numbers(program: dict, reference: dict) -> dict:
    """{number: value} of one sample frame. ``program``: ``image`` (H, W,
    3) and the renderer's ``rendered_splats``, ``pair_overflow_dropped``,
    ``max_tile_count``; ``reference``: ``reference.frame.render``'s
    output."""
    ref_img = reference["image"]
    d = np.asarray(program["image"], np.float32) - np.asarray(ref_img,
                                                             np.float32)
    if d.shape != tuple(ref_img.shape) or not np.isfinite(d).all():
        return {"image_rmse": math.inf, "tile_rmse": math.inf}
    pairs = reference.get("fast_pairs", reference["rendered_splats"])
    denom = max(reference["rendered_splats"], 1)
    return {
        "image_rmse": _rms(d),
        "tile_rmse": _tile_rms(d),
        "pairs_rel": abs(program["rendered_splats"] - pairs) / max(pairs, 1),
        "dropped_rel": abs(program["pair_overflow_dropped"]
                           - reference["pair_overflow_dropped"]) / denom,
        "max_tile_rel": abs(program["max_tile_count"]
                            - reference["max_tile_count"])
        / max(reference["max_tile_count"], 1),
    }


def judge(per_sample: list, limits: dict):
    """(checks, failed): checks {number: {"value", "limit"}} with the worst
    value over the samples of each number ``limits`` names; failed, the
    sample frames with a number over its limit (NaN fails)."""
    checks, failed = {}, 0
    for nums in per_sample:
        bad = False
        for name, limit in limits.items():
            v = nums.get(name, math.inf)
            if not v <= limit:
                bad = True
            prev = checks.get(name)
            if prev is None or not v <= prev["value"]:
                checks[name] = {"value": v, "limit": limit}
        failed += bad
    return checks, failed


def worst(per_sample: list) -> dict:
    """{number: its worst (largest) value over the samples}."""
    keys = dict.fromkeys(k for n in per_sample for k in n)
    return {k: max(n.get(k, math.inf) for n in per_sample) for k in keys}
