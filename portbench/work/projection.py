"""Projection: every splat array the stage receives, each byte read once,
at the precision the configuration hands it (``scene.sh_dtype``); the
outputs are the renderer's layout and are not counted."""

SH_BYTES = {"float32": 4, "bfloat16": 2}


def work(run, counts=None):
    """(0 operations, bytes) of one frame's projection: means (3 f32),
    cov3d (6 f32), opacity and upload time (f32 each) and the 48 SH
    coefficients of every slot of the padded arrays."""
    sh = SH_BYTES[run.config["scene"]["sh_dtype"]]
    return 0.0, float(run.capacity * (4 * (3 + 6 + 1 + 1) + 48 * sh))
