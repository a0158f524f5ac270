"""The host's launch of a frame, mean over the window's frames (ms): the
renderer's ``launch`` (the four graph replays with their stage events) and
``outputs`` (the output clones) phases."""

from portbench.host import phases_ms


def read(run):
    return phases_ms(run, ("launch", "outputs"))
