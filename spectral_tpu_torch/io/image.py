"""Image encode/save: BMP, PPM, PNG (port of spectral_tpu/io/image.py).

The reference writes BMP via CImg (io/save_image.cpp:8-20 -> CImg save_bmp)
into a ``renders/`` directory, plus a legacy stdout PPM writer
(io/io.cuh:10-23). These are the JAX package's pure-Python encoders, byte
for byte: BMP (24-bit bottom-up BGR, what CImg emits), binary PPM (P6), and
PNG (stdlib zlib, RGB8). The port has no native encoder.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np


def _as_rgb8(img: np.ndarray) -> np.ndarray:
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {arr.dtype}")
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {arr.shape}")
    return arr


def encode_bmp(img: np.ndarray) -> bytes:
    """24-bit uncompressed BMP, bottom-up rows, BGR pixel order (the layout
    CImg's save_bmp produces for the reference's output)."""
    arr = _as_rgb8(img)
    h, w, _ = arr.shape
    row = w * 3
    pad = (4 - row % 4) % 4
    image_size = (row + pad) * h
    file_size = 54 + image_size
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", file_size, 0, 0, 54,
        40, w, h, 1, 24, 0, image_size, 2835, 2835, 0, 0,
    )
    bgr = arr[::-1, :, ::-1]  # bottom-up, BGR
    if pad:
        padded = np.zeros((h, row + pad), np.uint8)
        padded[:, :row] = bgr.reshape(h, row)
        body = padded.tobytes()
    else:
        body = bgr.tobytes()
    return header + body


def decode_bmp(data: bytes) -> np.ndarray:
    """Inverse of ``encode_bmp`` for its own files: [H, W, 3] uint8 RGB."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset, _, w, h, _, bpp = struct.unpack_from("<IIiiHH", data, 10)
    if bpp != 24:
        raise ValueError(f"expected a 24-bit BMP, got {bpp}")
    row = w * 3 + (4 - (w * 3) % 4) % 4
    body = np.frombuffer(data, np.uint8, row * h, offset).reshape(h, row)
    return body[::-1, : w * 3].reshape(h, w, 3)[:, :, ::-1].copy()


def encode_ppm(img: np.ndarray) -> bytes:
    """Binary P6 PPM (the reference's io.cuh:10-23 writes ASCII P3 to
    stdout; P6 is the binary twin with identical pixel values)."""
    arr = _as_rgb8(img)
    h, w, _ = arr.shape
    return f"P6\n{w} {h}\n255\n".encode() + arr.tobytes()


def write_ppm_ascii(img: np.ndarray, stream) -> None:
    """ASCII P3 PPM to a stream — exact parity with the reference's legacy
    write_to_ppm (io/io.cuh:10-23)."""
    arr = _as_rgb8(img)
    h, w, _ = arr.shape
    stream.write(f"P3\n{w} {h}\n255\n")
    flat = arr.reshape(-1, 3)
    stream.write("\n".join(f"{r} {g} {b}" for r, g, b in flat))
    stream.write("\n")


def encode_png(img: np.ndarray) -> bytes:
    """Minimal RGB8 PNG via stdlib zlib (filter 0 per scanline)."""
    arr = _as_rgb8(img)
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


_ENCODERS = {".bmp": encode_bmp, ".ppm": encode_ppm, ".png": encode_png}


def save_image(img: np.ndarray, path: str) -> str:
    """Write an image; format chosen by extension (.bmp/.ppm/.png)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _ENCODERS:
        raise ValueError(f"unsupported image format {ext!r}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_ENCODERS[ext](img))
    return path


def save_render(img: np.ndarray, title: str, out_dir: str = "renders", ext: str = ".bmp") -> str:
    """Timestamped save under ``renders/`` mirroring the reference's
    save_img naming (io/save_image.cpp:8-20)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return save_image(img, os.path.join(out_dir, f"{stamp}_{title}{ext}"))
