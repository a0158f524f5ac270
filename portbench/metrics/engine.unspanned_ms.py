"""Host time in a frame that no phase of the renderer names, mean over the
window's frames (ms): each frame's host time less its row's phases; the
check that the phases cover the frame."""

from portbench.host import unspanned_ms


def read(run):
    return unspanned_ms(run)
