"""The exact frame's share of the card's peaks (%), the whole step's
roofline share: over the sample cameras, the least time of the work
counted for its projection, sort and composite over the host time of the
same cameras' frames."""

from portbench.readers import frame_share
from portbench.work import projection, render, sort


def read(run):
    return frame_share(run, (("Projection", projection.work),
                             ("Sort", sort.work), ("Render", render.work)))
