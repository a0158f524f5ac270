"""The host's wait for a frame, mean over the window's frames (ms): the
renderer's ``wait`` phase (``torch.cuda.synchronize`` after the launch)."""

from portbench.host import phases_ms


def read(run):
    return phases_ms(run, ("wait",))
