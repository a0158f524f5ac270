"""The fast frame's composite: the mean over the window's frames of the
renderer's ``Render`` stage events (ms)."""

from portbench.readers import stage_mean


def read(run):
    return stage_mean(run, "Render")
