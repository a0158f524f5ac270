"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each kernel source has a plain C interface. At first use it is compiled
with ``nvcc`` for Hopper (sm_90a) into ``build/kernels/`` at the repository
root, under a name that carries a hash of the source and the shared
headers (csrc/*.cuh), and loaded with ``ctypes``; :func:`build` compiles
several sources at once. Nothing is compiled when this module is imported, and a missing
``nvcc`` or a failed build raises: there is no fallback.

Every wrapper that launches a kernel calls :func:`count_launch` right after
the launch, so a run can show that its main path went through the kernels.
A CUDA graph's capture records those calls instead of counting them
(:func:`recording_launches`), and each replay counts what its capture
recorded (:func:`count_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every launcher returns cudaGetLastError() as an int.
SIGNATURES = {
    "projection": {
        "gs_project_words": [_P] * 14 + [_I] * 8 + [_F] * 3 + [_P],
    },
    "projection_readable": {
        "gs_project_readable": [_P] * 19 + [_I] * 7 + [_F] * 2 + [_P],
    },
    "block_frame": {
        "gs_block_frame": [_P] * 14 + [_I] * 5 + [_P],
    },
    "big_lanes": {
        "gs_big_window": [_P] * 3 + [_I] * 3 + [_P],
    },
    "screen_pack": {
        "gs_screen_pack": [_P] * 13 + [_I] * 6 + [_P],
    },
    "screen_sort": {
        "gs_screen_sort": [_P] * 8 + [_I] * 2 + [_P],
    },
    "big_set": {
        "gs_big_set": [_P] * 11 + [_I] * 4 + [_P],
        "gs_big_set_empty": [_I, _P],
    },
    "bin_blocks": {
        "gs_bin_blocks": [_P] * 22 + [_I] * 6 + [_P],
        "gs_bin_blocks_chunk": [],
        "gs_bin_rank": [_P] * 5 + [_I, _P],
        "gs_bin_rank_prefix_words": [_I],
    },
    "bin_bigs": {
        "gs_bin_bigs": [_P] * 12 + [_I] * 6 + [_P],
        "gs_bin_bigs_chunk": [],
    },
    "emit_plan": {
        "gs_emit_plan": [_P] * 10 + [_L, _P],
        "gs_emit_plan_scratch_words": [_L],
        "gs_emit_plan_tile": [],
    },
    "emit_exact": {
        "gs_emit_base": [_P] * 7 + [_I] * 2 + [_L, _P],
        "gs_emit_dense": [_P] * 8 + [_I] * 3 + [_L, _P],
    },
    "sort_pairs": {
        "gs_sort_pairs": [_P] * 8 + [_L, _I, _P],
        "gs_sort_pairs_passes": [_I],
        "gs_sort_pairs_scratch_words": [_L, _I],
    },
    "render_v3": {
        "gs_render_v3": [_P] * 5 + [_I] * 8 + [_P],
        "gs_render_v3_cooked": [_P] * 5 + [_I] * 8 + [_P],
        "gs_render_v3_max_blocks": [_I] * 4,
    },
    "render_v4": {
        "gs_render_v4": [_P] * 5 + [_I] * 9 + [_P],
        "gs_render_v4_max_blocks": [_I] * 3,
        "gs_render_v4_smem_bytes": [_I] * 2,
    },
    "render_exact": {
        "gs_render_exact": [_P] * 10 + [_I] * 9 + [_P] * 2,
        "gs_render_exact_piece": [],
        "gs_render_exact_threads": [],
    },
    "sfu_probe": {
        "gs_sfu_probe": [_P] * 2 + [_I] * 6 + [_P],
    },
}
# One launch counter per kernel a wrapper launches (the v3 and the
# block_frame libraries hold two each: the word and the cooked payload;
# sfu_probe counts every body; emit_plan counts a plan, its two kernels;
# emit_exact counts its base and each dense group's launch; sort_pairs
# counts a sort, its histogram and passes;
# bin_blocks and bin_bigs count a binning, its six and four kernels;
# bin_rank counts bin_blocks' stable ranking launched alone, its two).
COUNTERS = ("projection", "projection_readable", "block_frame",
            "block_frame_cooked", "big_lanes", "screen_pack", "screen_sort",
            "big_set", "bin_blocks", "bin_bigs",
            "bin_rank",
            "render_v3",
            "render_v3_cooked", "render_v4", "render_exact", "emit_plan",
            "emit_exact", "sort_pairs", "sfu_probe")

_libs: dict = {}
_launches = {name: 0 for name in COUNTERS}
_capture = threading.local()   # .launches: the dict a capture records into
build_seconds: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library's path: its name and a hash of its source, the shared
    headers and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> None:
    """Build the named libraries that are not built yet: one ``nvcc`` per
    source, all started together. Every compiler process is waited for
    before a failure raises."""
    jobs = []
    for name in names:
        so = library_path(name)
        if name in _libs or so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, proc, t0 in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_text(err)
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The compiled kernel library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def count_launch(name: str) -> None:
    recording = getattr(_capture, "launches", None)
    if recording is not None:
        recording[name] = recording.get(name, 0) + 1
    else:
        _launches[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Inside the block, this thread's ``count_launch`` calls go into the
    yielded dict and leave the counters alone: a CUDA graph capture records
    launches and makes none. Each replay adds them (``count_launches``)."""
    prev = getattr(_capture, "launches", None)
    _capture.launches = {}
    try:
        yield _capture.launches
    finally:
        _capture.launches = prev


def count_launches(counts: dict) -> None:
    """Add {name: launches} to the counters (a graph replay's launches)."""
    for name, n in counts.items():
        _launches[name] += n


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return _smi("name,power.limit").strip()


def max_sm_clock_mhz() -> float:
    """nvidia-smi's maximum SM clock of the first card, in MHz."""
    return float(_smi("clocks.max.sm").split()[0])


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)(?:\s+0x([0-9a-f]+))?")


def sass(name: str, path: Path | None = None) -> str:
    """``cuobjdump -sass`` of a built library (this checkout's ``name`` by
    default)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(path or library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def sass_functions(listing: str, func: re.Pattern) -> dict:
    """{func's first group: [(address, opcode, branch target or None)]} for
    every kernel instance of a ``cuobjdump -sass`` listing whose name
    ``func`` matches."""
    funcs: dict = {}
    cur = None
    for line in listing.splitlines():
        m = func.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if "Function :" in line:
            cur = None
        m = _INSN.search(line)
        if cur is not None and m:
            target = (int(m.group(3), 16)
                      if m.group(2) == "BRA" and m.group(3) else None)
            cur.append((int(m.group(1), 16), m.group(2), target))
    return funcs


def loops(insns: list) -> list:
    """(first, last) addresses of each loop of an instance: from the
    target of a backward branch to the branch."""
    return sorted((t, a) for a, _, t in insns if t is not None and t <= a)


def op_counts(insns: list, lo: float, hi: float) -> dict:
    """Instructions at addresses lo..hi by opcode: each under its full
    name, its base name (FFMA.FTZ counts as FFMA) and, for MUFU, its
    function (MUFU.EX2)."""
    counts: dict = {}
    for a, op, _ in insns:
        if not lo <= a <= hi:
            continue
        parts = op.split(".")
        keys = {op, parts[0]}
        if parts[0] == "MUFU" and len(parts) > 1:
            keys.add(".".join(parts[:2]))
        for k in keys:
            counts[k] = counts.get(k, 0) + 1
    return counts


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Each tensor must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
