"""The host's part of the window's frames, as the renderer records it: one
row a frame of its host-phase ring (``godotgaussiansplatting_torch.utils.
telemetry.HOST_PHASES``: each phase's seconds, the frame's host waits and
graph launches). Read by the ``engine.*`` metrics."""

from __future__ import annotations

import statistics
from typing import Optional


def window_rows(run):
    """(rows, columns) of the window's frames: the ring's last
    ``len(run.frame_ms)`` rows not marked profiled (the traced stretch
    follows the window) and its column names; None where the renderer has
    no ring or it holds fewer rows than the window had frames."""
    try:
        from godotgaussiansplatting_torch.utils import telemetry
    except ImportError:
        return None
    ring = getattr(telemetry, "HOST_PHASES", None)
    n = len(run.frame_ms)
    if ring is None or n == 0:
        return None
    rows = ring.last_frames(n)
    if len(rows) < n:
        return None
    return rows, telemetry.HOST_COLUMNS


def column_mean(run, names, scale: float = 1.0) -> Optional[float]:
    """Mean over the window's frames of the sum of the columns ``names``,
    times ``scale``; None where there is nothing to read."""
    found = window_rows(run)
    if found is None:
        return None
    rows, columns = found
    cols = [columns.index(name) for name in names]
    return float(rows[:, cols].sum(axis=1).mean()) * scale


def phases_ms(run, names) -> Optional[float]:
    """Mean over the window's frames of the phases ``names``' summed time
    (ms)."""
    return column_mean(run, names, 1e3)


def unspanned_ms(run) -> Optional[float]:
    """Mean over the window's frames of the benchmark's host frame time
    less the sum of the frame's phases (ms): host time in the frame that no
    phase names."""
    found = window_rows(run)
    if found is None:
        return None
    rows, columns = found
    spanned = rows[:, :columns.index("syncs")].sum(axis=1) * 1e3
    return statistics.fmean(ms - float(s)
                            for ms, s in zip(run.frame_ms, spanned))
