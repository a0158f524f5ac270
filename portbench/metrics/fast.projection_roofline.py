"""The fast frame's projection against its roofline (%): the least time its
input bytes need (``work/projection.py``) over the mean ``Projection``
event time."""

from portbench.readers import least_ms, stage_mean
from portbench.work import projection


def read(run):
    t = stage_mean(run, "Projection")
    return None if not t else 100.0 * least_ms(*projection.work(run)) / t
