"""The exact frame's emission and sort: the mean over the window's frames of
the renderer's ``Sort`` stage events (ms)."""

from portbench.readers import stage_mean


def read(run):
    return stage_mean(run, "Sort")
