"""What a run hands the per-layer metric readers (``metrics/*.py``), and
the readings they share."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Optional

from . import peaks


@dataclasses.dataclass
class RunRecord:
    """One run's measurements.

    ``frame_ms``, ``stage_ms`` and ``slot``: each window frame's host time
    (camera set to ``rasterize(sync=True)`` returning), its stages' CUDA
    event times as the renderer reports them ({stage: ms}) and the path's
    revolution frame it showed. ``samples``: {slot: the reference's counts
    of that sample camera's frame} (``reference.frame.render``'s numbers).
    ``trace``: the profiled stretch (``trace.summarize``), or None.
    """

    config: dict
    capacity: int
    frame_ms: list
    stage_ms: list
    slot: list
    samples: dict = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None


def stage_mean(run: RunRecord, stage: str,
               slot: Optional[int] = None) -> Optional[float]:
    """Mean of ``stage``'s event ms over the window's frames (those of
    revolution frame ``slot`` only, where given); None if it never ran."""
    xs = [s[stage] for s, k in zip(run.stage_ms, run.slot)
          if stage in s and (slot is None or k == slot)]
    return statistics.fmean(xs) if xs else None


def frame_mean(run: RunRecord, slot: Optional[int] = None) -> Optional[float]:
    xs = [ms for ms, k in zip(run.frame_ms, run.slot)
          if slot is None or k == slot]
    return statistics.fmean(xs) if xs else None


def least_ms(flops: float, nbytes: float) -> float:
    """The least time the work needs on the card: the larger of its f32
    operations over the f32 peak and its bytes over the HBM bandwidth."""
    return max(flops / peaks.F32_FLOPS_PER_S,
               nbytes / peaks.HBM_BYTES_PER_S) * 1e3


def sampled_share(run: RunRecord, stage: str, work) -> Optional[float]:
    """A stage's roofline share over the sample cameras, %: the sum of
    ``least_ms(*work(run, counts))`` over the samples divided by the sum
    of the stage's mean event time on each sample's frames."""
    least = spent = 0.0
    for slot, counts in sorted(run.samples.items()):
        t = stage_mean(run, stage, slot)
        if t is None:
            return None
        least += least_ms(*work(run, counts))
        spent += t
    return 100.0 * least / spent if spent > 0 else None


def engine_overhead(run: RunRecord) -> Optional[float]:
    """Mean over frames of the host time less the sum of the stages'
    event times."""
    xs = [ms - sum(s.values()) for ms, s in zip(run.frame_ms, run.stage_ms)
          if s]
    return statistics.fmean(xs) if xs else None


def frame_share(run: RunRecord, stages) -> Optional[float]:
    """The frame's roofline share, %: over the sample cameras, the sum of
    the counted stages' least times (``stages``: (stage, work) pairs) over
    the sum of the mean host frame time of each sample's frames."""
    least = spent = 0.0
    for slot, counts in sorted(run.samples.items()):
        t = frame_mean(run, slot)
        if t is None:
            return None
        least += sum(least_ms(*work(run, counts)) for _, work in stages)
        spent += t
    return 100.0 * least / spent if spent > 0 else None
