"""The fast frame's share of the card's peaks (%), the whole step's
roofline share: over the sample cameras, the least time of the work
counted for its projection and composite (the stages the reference counts;
Blocks and Binning add none yet, so it reads low) over the host time of
the same cameras' frames. It bounds the kernels' roofline shares from the
frame's side: a stage taken off the path leaves its roofline silent and
this share still reads the frame."""

from portbench.readers import frame_share
from portbench.work import projection, render


def read(run):
    return frame_share(run, (("Projection", projection.work),
                             ("Render", render.work)))
