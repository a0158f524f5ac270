"""The exact frame's Sort stage against its roofline (%) over the sample
cameras (``work/sort.py``), timed by the ``Sort`` events of the same
cameras' frames."""

from portbench.readers import sampled_share
from portbench.work import sort


def read(run):
    return sampled_share(run, "Sort", sort.work)
