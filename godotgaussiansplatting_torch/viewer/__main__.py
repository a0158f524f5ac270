"""CLI entry: interactive viewer or offline trajectory rendering.

  python -m godotgaussiansplatting_torch.viewer model.ply            # serve
  python -m godotgaussiansplatting_torch.viewer model.ply --offline out/
  python -m godotgaussiansplatting_torch.viewer --synthetic 500000   # demo

Counterpart of ``godotgaussiansplatting_tpu/viewer/__main__.py``, with the
same flags and ``--device`` (default ``cuda``; without a card that raises
unless ``--device cpu`` is given, which runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="gaussian-splatting viewer (PyTorch/CUDA)")
    ap.add_argument("model", nargs="?", help=".ply splat model path")
    ap.add_argument("--synthetic", type=int, default=None,
                    help="render a synthetic scene of N splats instead")
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; 0.0.0.0 exposes "
                         "the mutable viewer API to the network)")
    ap.add_argument("--quality", choices=["fast", "exact"], default="fast")
    ap.add_argument("--offline", metavar="DIR", default=None,
                    help="render an orbit trajectory to PNGs and exit")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--radius", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and frames (cuda, or "
                         "cpu for the kernels' plain versions)")
    args = ap.parse_args(argv)

    from ..engine.rasterizer import Rasterizer
    from ..models.splats import synthetic_scene

    w, h = (int(v) for v in args.size.split("x"))
    if args.synthetic:
        source = synthetic_scene(args.synthetic, seed=42, extent=4.0,
                                 scale_range=(0.004, 0.03), surfaces=True,
                                 device=args.device)
    elif args.model:
        source = args.model
    else:
        ap.error("provide a .ply model or --synthetic N")

    # the server streams a .ply in; an offline orbit loads it at once
    r = Rasterizer(source, texture_size=(w, h), quality=args.quality,
                   stream=isinstance(source, str) and not args.offline,
                   device=args.device)

    if args.offline:
        from .offline import render_orbit
        summary = render_orbit(r, args.offline, num_frames=args.frames,
                               radius=args.radius)
        print(summary)
    else:
        from .server import serve
        serve(r, port=args.port, host=args.host)


if __name__ == "__main__":
    main()
