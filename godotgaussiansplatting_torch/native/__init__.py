"""ctypes bindings of the native (C++) splat preprocessor, ``plyio.cpp``.

Counterpart of ``godotgaussiansplatting_tpu/native/__init__.py``:

  swizzle(verts, prop_names, big_endian) -> (means, cov6, opacity, sh)
  morton3(means) -> (N,) uint64 codes

At first use the source is compiled with ``g++`` (the JAX package's
Makefile flags) into ``build/native/`` at the repository root, under a name
that carries a hash of the source, the flags and the host CPU
(``-march=native`` makes the library specific to the CPU that built it).
Nothing is built when this module is imported, and nothing is written into
the package. Where no ``g++`` is found, :func:`available` is false and the
callers (``models/ply.py``, ``ops/blocks.py``) take their numpy paths; where
it is found and the build fails, the build raises.

Each call of :func:`swizzle` and :func:`morton3` adds one to its counter
(:func:`call_counts`), so a run can show that a load went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "plyio.cpp"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "native")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared"]
COUNTERS = ("swizzle", "morton3")
THREADS = min(32, os.cpu_count() or 1)   # host threads a call splits over

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_calls = {name: 0 for name in COUNTERS}


class NonContiguousRest(ValueError):
    """The f_rest properties are not 45 consecutive columns: the native
    swizzle cannot read them (the numpy path reads any layout)."""


class _PropIdx(ctypes.Structure):
    _fields_ = [
        ("xyz", ctypes.c_int32 * 3),
        ("f_dc", ctypes.c_int32 * 3),
        ("f_rest0", ctypes.c_int32),
        ("opacity", ctypes.c_int32),
        ("scale", ctypes.c_int32 * 3),
        ("rot", ctypes.c_int32 * 4),
    ]


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def _host_cpu() -> bytes:
    """The CPU's model name and feature flags (what -march=native reads)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return b""
    keep = [ln for ln in text.splitlines()
            if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha1(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"libplyio-{h.hexdigest()[:12]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its library exists; returns the library's
    path. Raises if no compiler is found or the compiler fails. The library
    is written under a temporary name and renamed, so processes that build
    at once do not read a half-written file."""
    so = library_path(source)
    if so.exists():
        return so
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("g++ not found: the native plyio cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The library (built on first use)."""
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.plyio_swizzle.restype = ctypes.c_int32
        lib.plyio_swizzle.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(_PropIdx),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.plyio_morton3.restype = None
        lib.plyio_morton3.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
        ]
        _lib = lib
        return lib


def available() -> bool:
    """True once the library is loaded or can be built here; false only
    where no g++ is found. A failed build raises."""
    if _lib is None and _compiler() is None:
        return False
    load()
    return True


def _count(name: str) -> None:
    with _count_lock:
        _calls[name] += 1


def call_counts() -> dict:
    with _count_lock:
        return dict(_calls)


def reset_call_counts() -> None:
    with _count_lock:
        for k in _calls:
            _calls[k] = 0


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def swizzle(verts: np.ndarray, prop_names, big_endian: bool):
    """Native swizzle of a raw (N, nprops) float table (host byte order in
    memory; ``big_endian`` says the values still need a byte swap). Raises
    KeyError for a missing property and NonContiguousRest where the f_rest
    columns are not consecutive."""
    lib = load()
    verts = np.ascontiguousarray(verts, np.float32)
    n, nprops = verts.shape
    if nprops != len(prop_names):
        raise ValueError(f"{nprops} columns for {len(prop_names)} properties")
    idx = {p: i for i, p in enumerate(prop_names)}
    pi = _PropIdx()
    for k in range(3):
        pi.xyz[k] = idx[("x", "y", "z")[k]]
        pi.f_dc[k] = idx[f"f_dc_{k}"]
        pi.scale[k] = idx[f"scale_{k}"]
    rest = [idx.get(f"f_rest_{i}", -1) for i in range(45)]
    contiguous = rest[0] >= 0 and all(r == rest[0] + i
                                      for i, r in enumerate(rest))
    if not contiguous and rest[0] >= 0:
        raise NonContiguousRest("non-contiguous f_rest properties")
    pi.f_rest0 = rest[0] if contiguous else -1
    pi.opacity = idx["opacity"]
    for k in range(4):
        pi.rot[k] = idx[f"rot_{k}"]

    means = np.empty((n, 3), np.float32)
    cov6 = np.empty((n, 6), np.float32)
    opac = np.empty((n,), np.float32)
    sh = np.empty((n, 16, 3), np.float32)
    rc = lib.plyio_swizzle(_fp(verts), n, nprops, int(big_endian),
                           ctypes.byref(pi), _fp(means), _fp(cov6),
                           _fp(opac), _fp(sh), THREADS)
    if rc != 0:
        raise RuntimeError(f"plyio_swizzle returned {rc}")
    _count("swizzle")
    return means, cov6, opac, sh


def morton3(means: np.ndarray) -> np.ndarray:
    """3D Morton codes, 10 bits an axis, of (N, 3) positions quantised in
    f32 over their bounding box."""
    lib = load()
    means = np.ascontiguousarray(means, np.float32)
    if means.ndim != 2 or means.shape[1] != 3:
        raise ValueError(f"morton3 takes (N, 3) positions, not {means.shape}")
    n = means.shape[0]
    codes = np.empty((n,), np.uint64)
    lib.plyio_morton3(_fp(means), n,
                      codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                      THREADS)
    _count("morton3")
    return codes
