"""Render (the composite): the (pixel, splat) evaluations each pixel needs
up to its early exit, at a fixed count of f32 operations an evaluation
from the plain formula; the records of the pairs a tile's walk needs (up to
its last pixel's last slot) read once, and the RGBA f32 image written
once."""

# dx, dy (2); power = -0.5 * (a dx^2 + c dy^2) - b dx dy (9); exp (1);
# alpha = opacity * e (1); 1 - alpha (1); the transmittance's product (1);
# the weight alpha * T (1); three colour multiply-adds (6); the threshold
# test (1).
FLOPS_PER_EVALUATION = 23
# a pair's splat id (int32) and its splat's record: centre (2 f32), conic
# (3 f32), rgb and opacity (4 f32)
PAIR_RECORD_BYTES = 4 + 4 * (2 + 3 + 4)
PIXEL_BYTES = 4 * 4


def work(run, counts):
    knobs = run.config["rasterizer"]
    w, h = knobs["width"], knobs["height"]
    return (float(counts["evaluations"] * FLOPS_PER_EVALUATION),
            float(counts["pair_reads"] * PAIR_RECORD_BYTES
                  + w * h * PIXEL_BYTES))
