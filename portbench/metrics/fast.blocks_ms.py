"""The fast frame's block build: the mean over the window's frames of the
renderer's ``Blocks`` stage events (ms)."""

from portbench.readers import stage_mean


def read(run):
    return stage_mean(run, "Blocks")
