"""The fast cells' scene and sample cameras as inputs of the port's render
kernel tools: ``ab_render`` (this checkout's kernels against another
checkout's, bit-equality and time) and ``split_render`` (stage and variant
copies of the v3 kernel, timed).

    python3 -m portbench.render_views ab OTHER_CHECKOUT [ENTRY ...]
    python3 -m portbench.render_views split [SECTION ...] [OTHER_CHECKOUT]

The scene is the cells' configuration's (``scene.make_scene``) for one
large seed, ``SEED``, in the renderer's load-time Hilbert order, under
``RasterizerConfig(width, height).fast_defaults()`` (the word payload into
``gs_render_v3``, as the cells' frames run it); the cameras are the sample
cameras of ``CELLS`` at ``ANGLES`` as ``traffic.CameraPath`` poses them.
The rest of the command line goes to the tool's ``main`` with these views.
Needs a CUDA device.
"""

from __future__ import annotations

import sys

CELLS = ("garden-fast.overview", "garden-fast.orbit")
ANGLES = (0, 90)
SEED = 3_141_592_653


def fast_views(seed: int = SEED) -> list:
    """[(tag, fast cloud view, cfg, camera)] of CELLS at ANGLES."""
    import godotgaussiansplatting_torch as gt

    from .run import load_cell
    from .scene import make_scene
    from .traffic import CameraPath

    config = load_cell(CELLS[0])[1]
    a = make_scene(config, seed, "cuda")
    cloud = gt.fast_cloud_view(gt.mortonize(gt.SplatCloud(
        means=a["means"], cov3d=a["cov3d"], opacity=a["opacity"],
        sh=a["sh"], upload_time=a["upload_time"],
        num_splats=a["num_splats"])))
    del a
    r = config["rasterizer"]
    cfg = gt.RasterizerConfig(width=r["width"],
                              height=r["height"]).fast_defaults()
    views = []
    for cell in CELLS:
        path = CameraPath(load_cell(cell)[2], 0)
        for deg in ANGLES:
            pos, tgt = path.pose(round(deg / path.step))
            views.append((f"{cell} {deg} deg", cloud, cfg,
                          gt.Camera(position=pos, fov_y=path.fov_y)
                          .look_at(tgt)))
    return views


def main(argv) -> int:
    tools = ("ab", "split")
    if not argv or argv[0] not in tools:
        raise SystemExit(__doc__)
    if argv[0] == "ab":
        from godotgaussiansplatting_torch import ab_render as tool
    else:
        from godotgaussiansplatting_torch import split_render as tool
    return tool.main(argv[1:], fast_views())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
