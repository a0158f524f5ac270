"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each kernel source has a plain C interface. At first use it is compiled
with ``nvcc`` for Hopper (sm_90a) into ``build/kernels/`` at the repository
root, under a name that carries a hash of the source, and loaded with
``ctypes``. Nothing is compiled when this module is imported, and a missing
``nvcc`` or a failed build raises: there is no fallback.

Every wrapper that launches a kernel calls :func:`count_launch` right after
the launch, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
# C signatures: every function returns cudaGetLastError() as an int.
SIGNATURES = {
    "projection": {
        "gs_project_words": [_P] * 14 + [_I] * 8 + [_F] * 3 + [_P],
    },
    "render_v3": {
        "gs_render_v3": [_P] * 6 + [_I] * 8 + [_P],
        "gs_render_v3_max_blocks": [_I, _I],
    },
}

_libs: dict = {}
_launches = {name: 0 for name in SIGNATURES}
build_seconds: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library(name: str) -> ctypes.CDLL:
    """The compiled kernel library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"lib{name}-{digest}.log").write_text(proc.stderr)
    lib = ctypes.CDLL(str(so))
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
    _launches[name] += 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Each tensor must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
