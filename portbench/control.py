"""The readings the comparison's limits are set from, for one cell:

  program   the renderer's sample frames, rendered by the cell's own loop
            (``run.run_cell`` with a window of one revolution or more),
            against the float32 reference: the lower readings;
  control   the reference computed in bfloat16, the nearest precision
            below the configuration's float32, put in the renderer's
            place: the upper readings.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] \\
        [--program] [--seconds <s>]

One JSON line a seed on standard output. The benchmark's runs do not run
this; ``test_portbench_cpu.py`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import compare
from .run import load_cell, reference_frames, run_cell
from .traffic import CameraPath


def control_numbers(config: dict, traffic: dict, seed: int,
                    device="cuda") -> list:
    """Each sample camera's numbers of the bfloat16 reference against the
    float32 one."""
    path = CameraPath(traffic, seed)
    ref = reference_frames(config, path, seed, path.samples, device)
    low = reference_frames(config, path, seed, path.samples, device,
                           torch.bfloat16)
    out = []
    for slot in path.samples:
        c = low[slot]
        prog = {"image": c["image"],
                "rendered_splats": c.get("fast_pairs", c["rendered_splats"]),
                "pair_overflow_dropped": c["pair_overflow_dropped"],
                "max_tile_count": c["max_tile_count"]}
        out.append(compare.numbers(prog, ref[slot]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    _, config, traffic, limits = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}
        if args.program:
            res = run_cell(config, traffic, limits, seed, args.seconds,
                           False, log=lambda *a: print(*a, file=sys.stderr))
            line["program"] = res["numbers"]
            line["program_failed"] = res["failed"]
        line["control"] = compare.worst(
            control_numbers(config, traffic, seed))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
