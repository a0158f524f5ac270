"""The exact frame's tile boundaries: the mean over the window's frames of
the renderer's ``Boundaries`` stage events (ms)."""

from portbench.readers import stage_mean


def read(run):
    return stage_mean(run, "Boundaries")
