"""Image IO: stdlib-only PNG writer/reader and the sRGB present transform.

numpy-only copy of godotgaussiansplatting_tpu/utils/image.py; torch tensors
are accepted wherever an image is (moved to the host first).

Stands in for the reference's present shader + viewport blit
(resources/shaders/spatial/main.gdshader:7-19): the render texture is linear
RGBA32F; presentation applies the sRGB transfer curve.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _host(image) -> np.ndarray:
    """numpy view of an image given as a numpy array or a torch tensor."""
    if hasattr(image, "detach"):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def hwc(image: np.ndarray) -> np.ndarray:
    """Planar (4, H, W) fast-path render target -> (H, W, 4) channels-last.

    A free np.moveaxis VIEW on host arrays (no copy until a consumer needs
    contiguity); passes (H, W, 4) images through unchanged so callers can
    feed either pipeline's output."""
    a = _host(image)
    if a.ndim == 3 and a.shape[0] == 4 and a.shape[2] != 4:
        return np.moveaxis(a, 0, -1)
    return a


def linear_to_srgb(rgb: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 transfer (what the GPU does on an sRGB swapchain)."""
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.where(rgb <= 0.0031308, rgb * 12.92,
                    1.055 * np.power(rgb, 1 / 2.4) - 0.055)


def to_uint8(image: np.ndarray, srgb: bool = True) -> np.ndarray:
    """(H, W, 3|4) or planar (4, H, W) float → (H, W, 3) uint8."""
    rgb = hwc(image)[..., :3].astype(np.float32)
    if srgb:
        rgb = linear_to_srgb(rgb)
    return (np.clip(rgb, 0, 1) * 255.0 + 0.5).astype(np.uint8)


def png_bytes(rgb8: np.ndarray, level: int) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, filter 0 on every row,
    zlib at ``level``."""
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = tag + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(
            ">I", zlib.crc32(c))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


def write_png(path, image: np.ndarray, srgb: bool = True) -> None:
    """Write (H, W, 3|4) float (linear) or uint8 image as PNG (stdlib zlib)."""
    img = _host(image)
    rgb8 = img if img.dtype == np.uint8 else to_uint8(img, srgb=srgb)
    if rgb8.ndim == 2:
        rgb8 = np.repeat(rgb8[:, :, None], 3, axis=2)
    with open(path, "wb") as f:
        f.write(png_bytes(rgb8, 6))


def encode_jpeg_fallback_png(image: np.ndarray, srgb: bool = True) -> bytes:
    """In-memory PNG bytes of a float image (the HTTP viewer's frame
    stream): zlib level 1, the same bytes as the JAX package's."""
    return png_bytes(to_uint8(image, srgb=srgb), 1)


def read_png(path) -> np.ndarray:
    """Read a PNG written by write_png (8-bit RGB, filter 0) → (H, W, 3) u8.

    Minimal decoder for the golden-image corpus; supports exactly the subset
    this module emits (non-interlaced, color type 2, per-row filter byte 0).
    """
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, w = 8, None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            assert (depth, ctype, interlace) == (8, 2, 0), (
                "read_png supports only write_png's 8-bit RGB output")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = 1 + 3 * w
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    assert np.all(rows[:, 0] == 0), "unexpected PNG row filter"
    return rows[:, 1:].reshape(h, w, 3).copy()
