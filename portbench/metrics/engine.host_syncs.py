"""The host's waits on the card a frame, mean over the window's frames:
the renderer's ``syncs`` counter (the upload's event, the frame's
synchronise, the stage events' synchronise, the exact path's read of its
densest tile)."""

from portbench.host import column_mean


def read(run):
    return column_mean(run, ("syncs",))
