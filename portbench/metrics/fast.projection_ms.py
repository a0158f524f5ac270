"""The fast frame's projection: the mean over the window's frames of the
renderer's ``Projection`` stage events (ms)."""

from portbench.readers import stage_mean


def read(run):
    return stage_mean(run, "Projection")
