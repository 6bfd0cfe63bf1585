"""Framebuffer output (a minimal dependency-free PNG writer, and binary PPM
read and write) and the SSIM image-parity metric.

The reference presents frames to a GLFW window; this framework renders offscreen
(SURVEY.md §7 "interactive layer") and presents via image files. Frames are
(H, W, 3) float in [0, 1] with GL's bottom-up row order; the writer flips to
the top-down order image files expect.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray, compress_level: int = 6) -> None:
    """img: (H, W, 3) float [0,1] or uint8, bottom-up rows. compress_level
    is zlib's (1 deflates 3-4x faster; the interactive session's live
    refresh, rewritten every frame, uses it)."""
    data = (img if img.dtype == np.uint8 else to_uint8(img))[::-1]
    h, w = data.shape[:2]
    # per-row filter byte 0, prepended as a column (vectorized scanlines)
    rows = np.ascontiguousarray(data).reshape(h, w * 3)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rows], axis=1
    ).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, compress_level))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_ppm(path: str, img: np.ndarray, flip_vertical: bool = True) -> None:
    """img: (H, W, 3) float [0,1] or uint8, as a binary PPM (P6); rows are
    flipped to top-down unless ``flip_vertical`` is False."""
    data = img if img.dtype == np.uint8 else to_uint8(img)
    if flip_vertical:
        data = data[::-1]
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(data.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (P6, maxval 255, comment lines before the size) as (H,
    W, 3) uint8 in file row order."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path}: not a binary PPM (P6)")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(x) for x in line.split())
        if int(f.readline()) != 255:
            raise ValueError(f"{path}: maxval is not 255")
        data = np.frombuffer(f.read(w * h * 3), dtype=np.uint8)
    return data.reshape(h, w, 3)


def ssim(a: np.ndarray, b: np.ndarray, window: int = 8) -> float:
    """Mean structural similarity over non-overlapping windows (grayscale).
    Acceptance metric for image parity (BASELINE.md: SSIM >= 0.98)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a = a.mean(axis=2)
        b = b.mean(axis=2)
    h = (a.shape[0] // window) * window
    w = (a.shape[1] // window) * window
    aw = a[:h, :w].reshape(h // window, window, w // window, window)
    bw = b[:h, :w].reshape(h // window, window, w // window, window)
    mu_a = aw.mean(axis=(1, 3))
    mu_b = bw.mean(axis=(1, 3))
    var_a = aw.var(axis=(1, 3))
    var_b = bw.var(axis=(1, 3))
    cov = (aw * bw).mean(axis=(1, 3)) - mu_a * mu_b
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())
