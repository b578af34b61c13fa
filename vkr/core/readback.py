"""Host readback + capture utilities.

The analog of the reference's ReadBackSystem (image_readback.{hpp,cpp}) and
main.cpp's capture callbacks (main.cpp:118-176): device array -> host bytes
-> timestamped PNG / depth CSV under captures/. A readback is just
np.asarray on a device array (SURVEY.md §3.5 mapping).
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np


def to_host(array) -> np.ndarray:
    """Blocking readback (the reference blocks frames_count+1 frames later;
    here jax dispatch overlap gives the same pipelining for free)."""
    return np.asarray(array)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filtering)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + np.ascontiguousarray(img[y]).tobytes()
                   for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_png(array, path: str, srgb_encode: bool = False) -> str:
    """(H, W[, C]) float [0,1] or uint8 -> PNG (get_rgba_cb analog)."""
    img = to_host(array)
    if img.dtype != np.uint8:
        img = np.clip(img, 0.0, 1.0)
        if srgb_encode:
            img = np.where(
                img <= 0.0031308, img * 12.92,
                1.055 * img ** (1 / 2.4) - 0.055,
            )
        img = (img * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        img = np.concatenate(
            [img, np.zeros_like(img[..., :1])], axis=-1
        )
    if img.shape[-1] == 4:
        img = img[..., :3]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def save_depth_csv(depth, path: str) -> str:
    """Depth dump in the reference's CSV shape (get_depth_cb,
    main.cpp:118-150): one row per scanline, hex-encoded D24 texels."""
    d = to_host(depth)
    q = np.clip(d, 0.0, 1.0)
    q24 = (q * float((1 << 24) - 1)).astype(np.uint32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("y, " + ",".join(str(x) for x in range(d.shape[1])) + "\n")
        for yrow in range(d.shape[0]):
            f.write(
                str(yrow) + ", "
                + ",".join(format(v, "x") for v in q24[yrow]) + "\n"
            )
    return path


def capture_path(prefix: str, ext: str, directory: str = "captures") -> str:
    """Timestamped capture filename (main.cpp:166-176)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(directory, f"{prefix}-{stamp}.{ext}")
