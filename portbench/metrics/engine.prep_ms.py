"""The host's work before a frame's first launch, mean over the window's
frames (ms): the renderer's ``camera``, ``uniforms``, ``graph`` and
``upload`` phases, while the card has nothing of the frame queued."""

from portbench.host import phases_ms


def read(run):
    return phases_ms(run, ("camera", "uniforms", "graph", "upload"))
