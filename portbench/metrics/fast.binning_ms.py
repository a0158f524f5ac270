"""The fast frame's tile binning: the mean over the window's frames of the
renderer's ``Binning`` stage events (ms)."""

from portbench.readers import stage_mean


def read(run):
    return stage_mean(run, "Binning")
