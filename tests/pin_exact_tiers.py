"""Which emission group drops pairs on the exact frame's headline orbit.

    PYTHONPATH=. python tests/pin_exact_tiers.py [--splats 5800000]

Not a pytest file: it takes about a minute on the CPU. It builds the
5.8M-splat scene that chip_smoke.py's phases 4-8 render (``synthetic_scene(5_800_000,
seed=42, extent=4.0, scale_range=(0.004, 0.03), surfaces=True)``,
mortonized), and for each of the 8 orbit cameras (``orbit_trajectory(8,
radius=5.0, target=(0, 0, 6.0))``) at 1920x1080, exact quality (tile 16,
``max_tiles_per_splat`` 32), computes every splat's valid flag and tile
count twice on the CPU: with the JAX package's ``project_splats`` and with
the port's plain ``ops/projection.project_splats``, in chunks of splats
(the projection is per splat). It reports where the two differ, then
applies ``emit_and_sort``'s grouping (godotgaussiansplatting_tpu/ops/
sort.py:71-124: base cap, each ``exact_tiers`` tier with its capacity, the
``giant_splat_capacity`` giants; taken in splat order) to each package's
counts: per group the splats eligible, taken and left over, and the pairs
dropped. ``num_overflow`` follows from the counts and the order alone:
``sum(num_tiles) - emitted``, with no sort.
"""

from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import godotgaussiansplatting_torch as gt  # noqa: E402
import godotgaussiansplatting_tpu as gj  # noqa: E402
from godotgaussiansplatting_torch.ops.projection import (  # noqa: E402
    project_splats as torch_project)
from godotgaussiansplatting_tpu.ops.projection import (  # noqa: E402
    project_splats as jax_project)


def grouping(valid: np.ndarray, nt: np.ndarray, max_t: int, tiers,
             gcap: int) -> dict:
    """emit_and_sort's groups from per-splat (valid, num_tiles): per group
    the splats eligible, taken and left over (these keep the base cap), and
    the pairs the left-over ones drop; and num_overflow, computed as the
    JAX function computes it (sum(num_tiles) - emitted)."""
    nt = nt.astype(np.int64)
    capped = np.minimum(nt, max_t)
    out = {"splats_over_base_cap": int((valid & (nt > max_t)).sum())}
    prev = max_t
    for w, cap in tiers:
        elig = valid & (nt > prev) & (nt <= w)
        rank = np.cumsum(elig) - 1
        taken = elig & (rank < cap)
        left = elig & ~taken
        capped = np.where(taken, nt, capped)
        out[f"tier {w} (cap {cap})"] = {
            "eligible": int(elig.sum()), "taken": int(taken.sum()),
            "left": int(left.sum()),
            "pairs_dropped": int((nt[left] - max_t).sum())}
        prev = w
    giant = valid & (nt > prev)
    rank = np.cumsum(giant) - 1
    taken = giant & (rank < gcap)
    left = giant & ~taken
    capped = np.where(taken, nt, capped)
    out[f"giants > {prev} (cap {gcap})"] = {
        "eligible": int(giant.sum()), "taken": int(taken.sum()),
        "left": int(left.sum()),
        "pairs_dropped": int((nt[left] - max_t).sum()),
        "widest": int(nt[giant].max()) if giant.any() else 0}
    out["num_tiles_sum"] = int(nt.sum())
    out["num_overflow"] = int(nt.sum() - capped.sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splats", type=int, default=5_800_000)
    ap.add_argument("--chunk", type=int, default=500_000)
    ap.add_argument("--cameras", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    cloud = gt.mortonize(gt.synthetic_scene(
        args.splats, seed=42, extent=4.0, scale_range=(0.004, 0.03),
        surfaces=True, device="cpu"))
    P = cloud.num_splats
    arrays = [t.numpy() for t in (cloud.means, cloud.cov3d, cloud.opacity,
                                  cloud.sh, cloud.upload_time)]
    print(f"scene: {P} splats in {time.perf_counter() - t0:.1f} s",
          flush=True)
    tcfg = gt.RasterizerConfig(width=1920, height=1080)
    jcfg = gj.RasterizerConfig(width=1920, height=1080)
    assert (tcfg.tile_size, tcfg.max_tiles_per_splat, tcfg.exact_tiers,
            tcfg.giant_splat_capacity) == (
        jcfg.tile_size, jcfg.max_tiles_per_splat, jcfg.exact_tiers,
        jcfg.giant_splat_capacity)
    cams = gt.orbit_trajectory(args.cameras, radius=5.0, target=(0, 0, 6.0))
    jcams = gj.orbit_trajectory(args.cameras, radius=5.0,
                                target=(0, 0, 6.0))
    C = args.chunk

    @jax.jit
    def jproj(m, c, o, s, u, view, proj, cpos):
        p = jax_project(m, c, o, s, u, view, proj, cpos, jnp.float32(1.0),
                        jnp.float32(1e9), jcfg)
        return p.valid, p.num_tiles

    report = []
    for ci, (cam, jcam) in enumerate(zip(cams, jcams)):
        w, h = tcfg.target_size
        view, proj = cam.view_matrix(), cam.projection_matrix(w, h)
        cpos = cam.camera_pos_ply()
        assert np.array_equal(view, jcam.view_matrix())
        assert np.array_equal(proj, jcam.projection_matrix(w, h))
        uni = gt.make_uniforms(cam, tcfg, device="cpu")
        res = {}
        t1 = time.perf_counter()
        for side in ("jax", "torch"):
            valid = np.zeros(P, bool)
            nt = np.zeros(P, np.int32)
            for a in range(0, P, C):
                b = min(a + C, P)
                if side == "jax":
                    # pad to one chunk shape: one compile
                    part = [np.concatenate([x[a:b], np.zeros(
                        (C - (b - a),) + x.shape[1:], x.dtype)])
                        for x in arrays]
                    v, n = jproj(*part, view.astype(np.float32),
                                 proj.astype(np.float32),
                                 cpos.astype(np.float32))
                    valid[a:b] = np.asarray(v)[:b - a]
                    nt[a:b] = np.asarray(n)[:b - a]
                else:
                    p = torch_project(
                        *(torch.from_numpy(x[a:b]) for x in arrays),
                        uni.view, uni.proj, uni.camera_pos, uni.model_scale,
                        uni.time, tcfg)
                    valid[a:b] = p.valid.numpy()
                    nt[a:b] = p.num_tiles.numpy()
            assert not nt[~valid].any(), f"{side}: culled splats with tiles"
            res[side] = (valid, nt)
        (vj, nj), (vt, ntt) = res["jax"], res["torch"]
        diff = (vj != vt) | (nj != ntt)
        groups = {side: grouping(v, n, tcfg.max_tiles_per_splat,
                                 tcfg.exact_tiers,
                                 tcfg.giant_splat_capacity)
                  for side, (v, n) in res.items()}
        rec = {"camera": ci, "valid": [int(vj.sum()), int(vt.sum())],
               "splats_differing": int(diff.sum()),
               "max_tiles_jax_torch": [int(nj.max()), int(ntt.max())],
               # every group's counts, the tile sum (which the 1-2 splats
               # that differ move) aside
               "groups_equal": all(groups["jax"][k] == groups["torch"][k]
                                   for k in groups["jax"]
                                   if k != "num_tiles_sum"),
               "jax": groups["jax"]}
        rec["torch"] = groups["torch"]
        if diff.any():
            i = np.nonzero(diff)[0][:5]
            rec["first_differing"] = [[int(k), bool(vj[k]), bool(vt[k]),
                                       int(nj[k]), int(ntt[k])] for k in i]
        rec["seconds"] = round(time.perf_counter() - t1, 1)
        print(json.dumps(rec), flush=True)
        report.append(rec)
    total = {s: [r[s]["num_overflow"] for r in report]
             for s in ("jax", "torch")}
    print(json.dumps({"num_overflow_per_camera": total}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
