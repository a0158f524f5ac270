"""Where emit_plan's time goes at 1080p: copies of csrc/emit_plan.cu with one
piece dropped or one constant changed, each built and timed on the exact
frame's inputs, and a copy that counts the scan kernel's waits.

    python3 -m godotgaussiansplatting_torch.split_plan [OTHER_CHECKOUT]

The inputs are those of chip_smoke.py's phase 6: the 5.8M-splat scene at
1920x1080 and the reset camera, through the readable projection (its valid
flags and num_tiles). Every copy in VARIANTS (each edit must match the
source once) and INSTRUMENTED is built with the kernels' nvcc flags into
build/split_plan/, all started together, its registers and spills
printed; each runs through ``sort._emit_plan_cuda`` and is held bit-equal
to ``emit_plan_reference`` (but for the copy without the look-back, whose
prefixes are 0), then timed as graph replays of 20 calls in turns, the
copies in order and then reversed, twice. With OTHER_CHECKOUT (a tree of
this repository, for example the parent unpacked by ``git archive``), its
csrc/emit_plan.cu is built and timed in the same turns. The instrumented
copy reads clock64 around each role's waits and prints, per tile: the
scan warp's wait for the tile's sums, its look-back (steps of 32 tiles,
re-reads of records not yet whole, the distance to the tile whose P
record it found) and its publishing of the P record; the workers' waits
for the prefix and for the bulk copy of the inputs; the sums warp's wait
for the workers. It also times a copy that widens num_tiles into int64,
a pass as heavy in writes as the plan (4 B read and 8 written a splat).
Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch.ab_render import scene_cloud
from godotgaussiansplatting_torch.ops import sort as so
from godotgaussiansplatting_torch.ops.projection import project_splats

SPLIT_DIR = Path(__file__).resolve().parent.parent / "build" / "split_plan"
SOURCE = "emit_plan.cu"

_ONE_CTA = ("constexpr int CTAS_PER_SM = 2;",
            "constexpr int CTAS_PER_SM = 1;")
_NO_LOOK_BACK = (
    "      if (tile > 0) prefix = look_back<G>(agg, inc, tile, lane);\n", "")
_TWO_A_LANE = (
    """    const long long j = last - lane;
    int f = j < 0 ? PRE : NONE;
    Wide<G> v{};
    unsigned pm, upto;
    for (;;) {
      if (f == NONE) {   // both records' loads in flight together
        Wide<G> p, a;
        const bool whole_p = load_wide<G>(inc + j * kp(G), p);
        const bool whole_a = load_run<G>(agg + j * ka(G), a);
        f = whole_p ? PRE : whole_a ? A : NONE;
        v = whole_p ? p : a;
      }
      pm = __ballot_sync(FULL, f == PRE);
      const unsigned zm = __ballot_sync(FULL, f == NONE);
      upto = pm ? (pm ^ (pm - 1)) : FULL;   // lanes up to the first P
      if ((zm & upto) == 0) break;
    }
    if (!((upto >> lane) & 1u) || j < 0) v = Wide<G>{};
    add(prefix, warp_sum(v));
    if (pm) return prefix;""",
    """    // two tiles a lane: lane k the tiles last - 2k and last - 2k - 1
    const long long jj[2] = {last - 2 * lane, last - 2 * lane - 1};
    int f[2];
    Wide<G> v[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[i] = jj[i] < 0 ? PRE : NONE;
      v[i] = Wide<G>{};
    }
    unsigned pm;
    int need;
    for (;;) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (f[i] == NONE) {
          Wide<G> p, a;
          const bool whole_p = load_wide<G>(inc + jj[i] * kp(G), p);
          const bool whole_a = load_run<G>(agg + jj[i] * ka(G), a);
          f[i] = whole_p ? PRE : whole_a ? A : NONE;
          v[i] = whole_p ? p : a;
        }
      }
      const int ip = f[0] == PRE ? 0 : f[1] == PRE ? 1 : 2;
      pm = __ballot_sync(FULL, ip < 2);
      const int first = pm ? __ffs(pm) - 1 : 32;
      need = lane < first ? 2 : lane == first ? ip + 1 : 0;
      const bool missing = (need > 0 && f[0] == NONE) ||
                           (need > 1 && f[1] == NONE);
      if (!__any_sync(FULL, missing)) break;
    }
    Wide<G> sum{};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (i < need && jj[i] >= 0) add(sum, v[i]);
    add(prefix, warp_sum(sum));
    if (pm) return prefix;""")
_TWO_A_LANE_STEP = ("  for (long long last = tile - 1;; last -= 32) {",
                    "  for (long long last = tile - 1;; last -= 64) {")

# Copies of this checkout's kernel: name -> edits.
VARIANTS = {
    "as built": [],
    "no look-back (prefixes 0: timing only)": [_NO_LOOK_BACK],
    "one CTA an SM": [_ONE_CTA],
    "512 worker threads (8192-splat tiles), one CTA an SM": [
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 512;"),
        _ONE_CTA],
    "two tiles a lane of the look-back (64 a step)": [_TWO_A_LANE,
                                                      _TWO_A_LANE_STEP],
}

# The instrumented copy: g_dbg[i] sums clock64 spans (or counts) of the
# whole call; NAMES[i] says what.
NAMES = {0: "scan warp: wait for the sums", 1: "scan warp: look-back",
         2: "scan warp: P record", 4: "look-back steps",
         5: "look-back reads", 11: "distance to the P",
         6: "workers: wait for the prefix", 7: "workers: wait for the inputs",
         9: "sums warp: wait for the workers"}
_TILES = 3                      # g_dbg[3]: the tiles the scan warp took
INSTRUMENTED = [
    ("namespace {\n\nconstexpr int THREADS",
     "namespace {\n__device__ unsigned long long g_dbg[16];\n"
     "constexpr int THREADS"),
    ("  Wide<G> prefix{};\n  for (long long last = tile - 1;; last -= 32) {",
     "  Wide<G> prefix{};\n  int nwin = 0, nread = 0;\n"
     "  for (long long last = tile - 1;; last -= 32) {\n    ++nwin;"),
    ("    for (;;) {\n      if (f == NONE) {",
     "    for (;;) {\n      ++nread;\n      if (f == NONE) {"),
    ("    add(prefix, warp_sum(v));\n    if (pm) return prefix;",
     "    add(prefix, warp_sum(v));\n    if (pm) {\n      if (lane == 0) {\n"
     "        atomicAdd(&g_dbg[4], (unsigned long long)nwin);\n"
     "        atomicAdd(&g_dbg[5], (unsigned long long)nread);\n"
     "        atomicAdd(&g_dbg[11], (unsigned long long)(tile - last"
     " + __ffs(pm) - 1));\n      }\n      return prefix;\n    }"),
    ("      const int par = m & 1;\n      bar_sync(BAR_TOTAL + par, 64);",
     "      const int par = m & 1;\n      const long long c0 = clock64();\n"
     "      bar_sync(BAR_TOTAL + par, 64);\n"
     "      const long long c1 = clock64();"),
    ("      if (lane == 0) tile_prefix[par] = prefix;\n",
     "      const long long c2 = clock64();\n"
     "      if (lane == 0) tile_prefix[par] = prefix;\n"),
    ("            head->tot.e[g] = through.e[g];\n          }\n        }\n",
     "            head->tot.e[g] = through.e[g];\n          }\n        }\n"
     "        atomicAdd(&g_dbg[0], (unsigned long long)(c1 - c0));\n"
     "        atomicAdd(&g_dbg[1], (unsigned long long)(c2 - c1));\n"
     "        atomicAdd(&g_dbg[2], (unsigned long long)(clock64() - c2));\n"
     "        atomicAdd(&g_dbg[3], 1ull);\n"),
    ("      const int par = m & 1;\n      bar_sync(BAR_SUMS + par, THREADS + 32);",
     "      const int par = m & 1;\n      const long long s0 = clock64();\n"
     "      bar_sync(BAR_SUMS + par, THREADS + 32);\n      if (lane == 0)"
     " atomicAdd(&g_dbg[9], (unsigned long long)(clock64() - s0));"),
    ("      bar_sync(BAR_PREFIX + par, THREADS + 32);\n",
     "      const long long w0 = clock64();\n"
     "      bar_sync(BAR_PREFIX + par, THREADS + 32);\n      if (t == 0)"
     " atomicAdd(&g_dbg[6], (unsigned long long)(clock64() - w0));\n"),
    ("    bar_wait(&bars[b], (k / NBUF) & 1);\n",
     "    const long long w1 = clock64();\n"
     "    bar_wait(&bars[b], (k / NBUF) & 1);\n    if (t == 0)"
     " atomicAdd(&g_dbg[7], (unsigned long long)(clock64() - w1));\n"),
]
_READ_DBG = """
extern "C" int gs_emit_plan_waits(void* out) {
  static const unsigned long long zero[16] = {};
  int e = (int)cudaMemcpyFromSymbol(out, g_dbg, sizeof(g_dbg));
  return e ? e : (int)cudaMemcpyToSymbol(g_dbg, zero, sizeof(zero));
}
"""


def edited(edits, text: str | None = None) -> str:
    """csrc/emit_plan.cu with each (old, new) replaced; each old string
    must occur once."""
    text = (kernels.CSRC / SOURCE).read_text() if text is None else text
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"split_plan: edit not found once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build(sources: dict) -> dict:
    """{name: (library, ptxas lines)} of {name: source text}, one nvcc per
    copy, all started together."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, text) in enumerate(sources.items()):
        src = SPLIT_DIR / f"copy{i}.cu"
        src.write_text(text)
        out = src.with_suffix(".so")
        jobs.append((name, out, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, out, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"split_plan: nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in kernels.SIGNATURES["emit_plan"].items():
            f = getattr(lib, fn, None)
            if f is not None:
                f.argtypes, f.restype = argtypes, ctypes.c_int
        report = [ln.split(":", 1)[-1].strip() for ln in err.splitlines()
                  if "scan_kernelILi3ELb1" in ln or "Used" in ln]
        libs[name] = (lib, report)
    return libs


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms a call over ``reps`` calls captured in a CUDA graph and
    replayed once (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def differs(a, b) -> list:
    """The EmitPlan fields in which two plans differ."""
    pairs = [(f, getattr(a, f), getattr(b, f)) for f in
             ("nt_capped", "offsets", "base_total", "total", "overflow")]
    for g, (ga, gb) in enumerate(zip(a.groups, b.groups)):
        pairs += [(f"group{g}.{f}", getattr(ga, f), getattr(gb, f))
                  for f in ("idx", "nt_c", "off_c", "pos0")]
    return [f for f, x, y in pairs if not torch.equal(x, y)]


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("split_plan: no CUDA device")
    sources = {name: edited(e) for name, e in VARIANTS.items()}
    if argv:
        sources["other checkout"] = (Path(argv[0]) / "godotgaussiansplatting_"
                                     "torch" / "csrc" / SOURCE).read_text()
    sources["instrumented"] = edited(INSTRUMENTED) + _READ_DBG
    libs = _build(sources)
    print(kernels.card_name_and_power(), flush=True)
    for name, (_, report) in libs.items():
        print(f"[split_plan ptxas] {name}: {json.dumps(report[:2])}")
    cloud, cfg = scene_cloud("5.8M 1920x1080")
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    prj = project_splats(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                         cloud.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, cfg)
    valid, nt = prj.valid, prj.num_tiles
    del cloud, prj
    ref = so.emit_plan_reference(valid, nt, cfg)
    names = [n for n in libs if n != "instrumented"]
    try:
        for name in libs:
            kernels._libs["emit_plan"] = libs[name][0]
            bad = differs(so._emit_plan_cuda(valid, nt, cfg), ref)
            print(f"[split_plan] {name}: fields differing from the plain "
                  f"plan {bad}", flush=True)
            if not name.startswith("no look-back") and bad:
                raise AssertionError(f"split_plan: {name} differs: {bad}")
        times = {n: [] for n in names}
        for order in (names, names[::-1], names, names[::-1]):
            for n in order:
                kernels._libs["emit_plan"] = libs[n][0]
                times[n].append(round(graph_ms(
                    lambda: so._emit_plan_cuda(valid, nt, cfg)), 4))
        print(f"[split_plan] {valid.shape[0]} splats, ms in turns: "
              f"{json.dumps(times)}", flush=True)
        # the rate of a pass as heavy in writes: num_tiles widened to int64
        wide = torch.empty(nt.shape[0], dtype=torch.int64, device=nt.device)
        copy_ms = [graph_ms(lambda: wide.copy_(nt)) for _ in range(2)]
        print(f"[split_plan] num_tiles widened into int64 (4 B read and 8 "
              f"written a splat): ms {json.dumps([round(m, 4) for m in copy_ms])}"
              f", {nt.shape[0] * 12 / min(copy_ms) / 1e9:.2f} TB/s",
              flush=True)
        lib = libs["instrumented"][0]
        lib.gs_emit_plan_waits.argtypes = [ctypes.c_void_p]
        lib.gs_emit_plan_waits.restype = ctypes.c_int
        kernels._libs["emit_plan"] = lib
        buf = (ctypes.c_ulonglong * 16)()
        for _ in range(3):
            so._emit_plan_cuda(valid, nt, cfg)
        torch.cuda.synchronize()
        kernels.check(lib.gs_emit_plan_waits(ctypes.addressof(buf)), "waits")
        calls = 5
        for _ in range(calls):
            so._emit_plan_cuda(valid, nt, cfg)
        torch.cuda.synchronize()
        kernels.check(lib.gs_emit_plan_waits(ctypes.addressof(buf)), "waits")
        tiles = buf[_TILES] / calls
        waits = {what: round(buf[i] / calls / tiles, 1)
                 for i, what in NAMES.items()}
        print(f"[split_plan waits] {tiles:.0f} tiles a call; a tile's SM "
              f"cycles (steps, reads and tiles for the look-back; the "
              f"workers' and the sums warp's by thread 0 of a CTA): "
              f"{json.dumps(waits)}; SM clock at most "
              f"{kernels.max_sm_clock_mhz()} MHz", flush=True)
    finally:
        kernels._libs.pop("emit_plan", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
