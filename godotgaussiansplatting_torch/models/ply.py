"""Inria-format .ply splat model loader.

Counterpart of ``godotgaussiansplatting_tpu/models/ply.py``:
``splat_soa_from_ply`` takes the port's native C++ swizzle
(``native/plyio.cpp``) where it can be built, as the JAX package's does, and
the numpy path otherwise; the other functions are numpy. Every .ply load of
the port goes through ``splat_soa_from_ply``, so a streamed model and one
loaded at once are the same cloud. (The JAX package's loads take its numpy
swizzle; its covariance differs from the native one in rounding.) Replaces the
reference's PlyFile parser (`util/ply_file.gd:10-26`)
and the swizzle in `load_gaussian_splats` (:28-77). The header grammar
follows the reference: 'format' picks endianness, 'element <name> N' sets
the count, 'property <type> <name>' appends a property; the payload is
size x props float32 (validated rather than silently misread).

Swizzle rules (ply_file.gd:40-69 / SURVEY.md §2.3):
  position   x,y,z                      (raw)
  normals    nx,ny,nz                   (ignored)
  DC color   f_dc_0..2                  → SH coeff 0 RGB
  rest SH    f_rest_0..44               planar 15R‖15G‖15B → coeff-major RGB
  opacity    logit                      → sigmoid
  scales     log                        → exp
  rotation   rot_0..3 = (w,x,y,z)       → quaternion (x,y,z,w)
The 3D covariance is R S² Rᵀ (ply_file.gd:49-59), built in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


class PlyError(ValueError):
    pass


@dataclasses.dataclass
class PlyFile:
    """Parsed PLY: flat float32 vertex table + property name index.
    Mirrors the reference PlyFile API (size / properties / get_vertex)."""

    size: int
    properties: List[str]
    vertices: np.ndarray  # (size, num_properties) float32, host order

    @classmethod
    def parse(cls, path_or_bytes) -> "PlyFile":
        if isinstance(path_or_bytes, (bytes, bytearray)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()

        # Header is ASCII lines up to 'end_header'.
        end = data.find(b"end_header")
        if end < 0:
            raise PlyError("no end_header")
        body_start = data.index(b"\n", end) + 1
        header = data[:end].decode("ascii", "replace").splitlines()

        big_endian = False
        size = 0
        props: List[str] = []
        for line in header:
            parts = line.strip().split(" ")
            if not parts:
                continue
            if parts[0] == "format":
                if parts[1] not in ("binary_little_endian", "binary_big_endian"):
                    raise PlyError(f"unsupported format {parts[1]!r} "
                                   "(ascii PLY is not a splat container)")
                big_endian = parts[1] == "binary_big_endian"
            elif parts[0] == "element":
                # The reference takes any element's count (ply_file.gd:17);
                # splat files have a single 'vertex' element.
                size = int(parts[2])
            elif parts[0] == "property":
                if parts[1] != "float":
                    raise PlyError(f"non-float property {parts[2]!r}")
                props.append(parts[2])

        if size <= 0 or not props:
            raise PlyError("empty or headerless PLY")
        dt = np.dtype(">f4" if big_endian else "<f4")
        need = size * len(props) * 4
        payload = data[body_start:body_start + need]
        if len(payload) < need:
            raise PlyError(f"truncated payload: {len(payload)} < {need} bytes")
        verts = np.frombuffer(payload, dtype=dt).astype(
            np.float32).reshape(size, len(props))
        return cls(size=size, properties=props, vertices=verts)

    def get_vertex(self, index: int) -> Dict[str, float]:
        """Property-name → value dict for one vertex (ply_file.gd:21-26)."""
        return dict(zip(self.properties, self.vertices[index].tolist()))


# The canonical Inria property layout (SURVEY.md §2.3).
_N_REST = 45
_REQUIRED = (["x", "y", "z", "opacity"] + [f"f_dc_{i}" for i in range(3)]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])


def splat_arrays_from_ply(ply: PlyFile):
    """Host-side swizzle into SoA arrays (means, scales, quats_xyzw,
    opacities post-sigmoid, sh (N,16,3) coeff-major)."""
    idx = {p: i for i, p in enumerate(ply.properties)}

    def col(name):
        if name not in idx:
            raise PlyError(f"missing property {name!r}")
        return ply.vertices[:, idx[name]]

    means = np.stack([col("x"), col("y"), col("z")], -1)
    scales = np.exp(np.stack([col("scale_0"), col("scale_1"), col("scale_2")], -1))
    # PLY stores (w, x, y, z) (ply_file.gd:50).
    quats = np.stack([col("rot_1"), col("rot_2"), col("rot_3"), col("rot_0")], -1)
    opac = 1.0 / (1.0 + np.exp(-col("opacity")))

    n = ply.size
    sh = np.zeros((n, 16, 3), np.float32)
    for c in range(3):
        sh[:, 0, c] = col(f"f_dc_{c}")
    # f_rest is planar: 15 R coeffs, then 15 G, then 15 B (ply_file.gd:66-69).
    rest_names = [f"f_rest_{i}" for i in range(_N_REST)]
    have_rest = all(r in idx for r in rest_names)
    if have_rest:
        rest = np.stack([col(r) for r in rest_names], -1)  # (n, 45)
        sh[:, 1:, 0] = rest[:, 0:15]
        sh[:, 1:, 1] = rest[:, 15:30]
        sh[:, 1:, 2] = rest[:, 30:45]
    return means.astype(np.float32), scales.astype(np.float32), \
        quats.astype(np.float32), opac.astype(np.float32), sh


def check_properties(ply: PlyFile) -> None:
    """Raise PlyError unless the model has every property a splat needs
    (the f_rest coefficients are optional)."""
    missing = [p for p in _REQUIRED if p not in set(ply.properties)]
    if missing:
        raise PlyError(f"missing property {missing[0]!r}")


def splat_soa_from_ply(ply: PlyFile):
    """(means, cov6, opacity, sh): the splat SoA with the precomputed
    covariance, through the native swizzle where it is available (g++ is
    found) and the f_rest columns are consecutive; the numpy path
    otherwise. Every .ply load of the port goes through it: load_splats,
    the Rasterizer's one-shot load and the streaming loader."""
    from .. import native
    from .splats import build_covariance
    check_properties(ply)
    if native.available():
        try:
            return native.swizzle(ply.vertices, ply.properties, False)
        except native.NonContiguousRest:
            pass  # the numpy path reads any layout
    means, scales, quats, opac, sh = splat_arrays_from_ply(ply)
    return means, build_covariance(scales, quats), opac, sh


def load_splats(path_or_bytes, upload_time: float = 0.0, capacity=None,
                device="cuda"):
    """Parse, swizzle (``splat_soa_from_ply``) and upload: .ply ->
    SplatCloud on ``device`` (the card unless the caller asks for
    another)."""
    from .splats import from_soa
    return from_soa(*splat_soa_from_ply(PlyFile.parse(path_or_bytes)),
                    upload_time=upload_time, capacity=capacity,
                    device=device)


def write_ply(path, means, scales_linear, quats_xyzw, opacities, sh,
              big_endian: bool = False):
    """Write an Inria-format splat .ply (inverse of the load swizzle) — used
    by tests and as an export path the reference lacks."""
    n = means.shape[0]
    props = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(_N_REST)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    table = np.zeros((n, len(props)), np.float32)
    table[:, 0:3] = means
    sh = np.asarray(sh, np.float32)
    table[:, 6:9] = sh[:, 0]
    table[:, 9:24] = sh[:, 1:, 0]
    table[:, 24:39] = sh[:, 1:, 1]
    table[:, 39:54] = sh[:, 1:, 2]
    op = np.clip(np.asarray(opacities, np.float64), 1e-7, 1 - 1e-7)
    table[:, 54] = np.log(op / (1 - op))
    table[:, 55:58] = np.log(np.maximum(scales_linear, 1e-20))
    q = np.asarray(quats_xyzw, np.float32)
    table[:, 58] = q[:, 3]
    table[:, 59:62] = q[:, 0:3]

    fmt = "binary_big_endian" if big_endian else "binary_little_endian"
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    header += [f"property float {p}" for p in props]
    header += ["end_header", ""]
    dt = np.dtype(">f4" if big_endian else "<f4")
    blob = "\n".join(header).encode("ascii") + table.astype(dt).tobytes()
    if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        with open(path, "wb") as f:
            f.write(blob)
    else:
        path.write(blob)
    return blob
