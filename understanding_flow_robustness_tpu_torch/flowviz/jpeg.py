"""The port's JPEG codec: ``encode_jpeg`` writes an RGB image as a baseline
JPEG file as libjpeg-turbo does at its defaults (what
``cv2.imencode(".jpg", ...)`` and PIL's ``Image.save(..., "JPEG")`` write),
through the host library's encoder (``native/src/ufr_jpeg_enc.cpp``);
``decode_jpeg`` reads one back (``native.decode_jpeg``).  No libjpeg, PIL
or cv2 is needed."""

from __future__ import annotations

import numpy as np

from .. import native
from ..native import decode_jpeg

__all__ = ["decode_jpeg", "encode_jpeg"]


def encode_jpeg(img: np.ndarray, quality: int) -> bytes:
    """A u8 (H, W, 3) RGB image -> baseline JPEG file bytes: JFIF, 4:2:0
    sampling, the standard quantisation tables scaled to ``quality``
    (1-100) with force_baseline, the standard Huffman tables, no restart
    markers."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a u8 (H, W, 3) image, got {img.dtype} "
                         f"{img.shape}")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"JPEG quality must be 1-100, got {quality}")
    h, w = img.shape[:2]
    lib = native.load()
    cap = img.size + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.reshape(-1), h, w, int(quality), out, cap)
        if n < 0:
            raise ValueError(f"cannot encode a {img.shape} image as JPEG "
                             f"(sides 1-65535)")
        if n <= cap:
            return out[:n].tobytes()
        cap = int(n)
