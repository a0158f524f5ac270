"""The fast frame's composite against its roofline (%) over the sample
cameras (``work/render.py``), timed by the ``Render`` events of the same
cameras' frames."""

from portbench.readers import sampled_share
from portbench.work import render


def read(run):
    return sampled_share(run, "Render", render.work)
