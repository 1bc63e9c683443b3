"""The port's PNG codec: the stdlib's ``zlib`` for inflate and deflate, the
host library's ``png_unfilter`` for the row filters, numpy for the rest.
No libpng, PIL or cv2 is needed.

Read: non-interlaced PNG of bit depth 8 or 16, grey, grey + alpha, RGB or
RGBA, samples in the file's channel order (16-bit samples are stored
big-endian and come back as native ``uint16``).  Palette, sub-byte and
interlaced files raise.  Write: the same formats with filter type 0 on
every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
# the writer's zlib level and strategy: cv2's PNG defaults (compression 1,
# IMWRITE_PNG_STRATEGY_RLE), twice as fast as level 1's default strategy
# on frames and 16-bit flow
WRITE_LEVEL, WRITE_STRATEGY = 1, zlib.Z_RLE


def _chunks(data: bytes):
    """(type, body) of each chunk up to IEND, with its CRC checked."""
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        if zlib.crc32(body, zlib.crc32(ctype)) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        if ctype == b"IEND":
            return
        yield ctype, body
        pos += 12 + length


def png_size(data: bytes) -> tuple:
    """(width, height) from a PNG file's leading IHDR chunk (its first 24
    bytes suffice), as ``Image.open(path).size`` gives it."""
    if data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return struct.unpack(">II", data[16:24])


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W) or (H, W, C) uint8 / uint16 samples."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, colour, comp, filt, interlace = header
    if colour not in CHANNELS:
        raise ValueError(f"PNG colour type {colour} (palette) is not read")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not read")
    if interlace != 0 or comp != 0 or filt != 0:
        raise ValueError("interlaced or non-standard PNG is not read")
    channels = CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = native.png_unfilter(raw, height, width * bpp, bpp)
    px = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    px = px.reshape(height, width, channels)
    return px[..., 0] if channels == 1 else px


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8 / uint16, C in 1-4 -> PNG file bytes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples are uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"expected (H, W) or (H, W, 1-4), got {img.shape}")
    height, width, channels = img.shape
    colour = {v: k for k, v in CHANNELS.items()}[channels]
    depth = 8 * img.dtype.itemsize
    px = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(px).reshape(height, -1).view(np.uint8)
    raw = np.zeros((height, rows.shape[1] + 1), np.uint8)  # filter 0
    raw[:, 1:] = rows

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(body, zlib.crc32(ctype))
        return struct.pack(">I4s", len(body), ctype) + body + struct.pack(
            ">I", crc)

    ihdr = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    deflate = zlib.compressobj(WRITE_LEVEL, zlib.DEFLATED, 15, 8,
                               WRITE_STRATEGY)
    idat = deflate.compress(raw.tobytes()) + deflate.flush()
    return (SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat)
            + chunk(b"IEND", b""))

