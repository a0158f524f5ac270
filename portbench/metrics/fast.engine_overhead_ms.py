"""The fast frame's engine overhead: each frame's host time less the sum of
its stage events, mean over the window's frames (ms): the uniform upload,
the replay calls, the wait for the frame, the output copies."""

from portbench.readers import engine_overhead


def read(run):
    return engine_overhead(run)
