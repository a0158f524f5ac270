"""The host's work after the card has finished a frame, mean over the
window's frames (ms): the renderer's ``timings`` (the stage events read and
recorded) and ``overflow`` (the exact path's densest-tile check) phases."""

from portbench.host import phases_ms


def read(run):
    return phases_ms(run, ("timings", "overflow"))
