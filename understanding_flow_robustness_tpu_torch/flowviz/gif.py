"""The port's GIF codec: GIF89a frames of 8-bit grey images under one
256-level grey palette, LZW-coded by the host library (``native.gif_lzw``),
with the frame delay and the loop count of PIL's ``save(save_all=True,
duration=..., loop=...)``, and a reader of such files (and of PIL's).  No
PIL is needed.

As PIL does, a frame equal to the one before it is not written again: its
duration is added to the earlier frame's.  PIL stores the delay in
hundredths of a second, ``int(duration_ms / 10)``, and so does this.
``luminance`` is PIL's ``convert("L")`` of an RGB image.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native

_GREY = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))


def luminance(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``Image.fromarray(rgb).convert("L")`` of a uint8 (H, W, 3)
    image: (R 19595 + G 38470 + B 7471 + 2^15) >> 16."""
    x = np.asarray(rgb)
    if x.dtype != np.uint8 or x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"expected a uint8 (H, W, 3) image, got {x.dtype} "
                         f"{x.shape}")
    x = x.astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _lzw(frame: np.ndarray) -> bytes:
    idx = np.ascontiguousarray(frame, np.uint8).reshape(-1)
    lib = native.load()
    cap = idx.size * 2 + 64
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.gif_lzw(idx, idx.size, out, cap)
        if n <= cap:
            return out[:n].tobytes()
        cap = int(n)


def encode_gif(frames, duration_ms: int, loop: int = 0) -> bytes:
    """A list of (H, W) uint8 frames of one size -> GIF89a file bytes that
    show each frame ``duration_ms`` milliseconds, looping ``loop`` times
    (0: for ever)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w) or not (
                0 < h < 65536 and 0 < w < 65536):
            raise ValueError(f"GIF frames are uint8 (H, W) of one size, "
                             f"got {f.dtype} {f.shape}")
    # PIL merges a repeated frame into the one before it
    kept, durations = [frames[0]], [int(duration_ms)]
    for f in frames[1:]:
        if np.array_equal(f, kept[-1]):
            durations[-1] += int(duration_ms)
        else:
            kept.append(f)
            durations.append(int(duration_ms))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _GREY,
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop)
           + b"\x00"]
    for f, dur in zip(kept, durations):
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", int(dur / 10))
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        data = _lzw(f)
        blocks = [bytes([8])]
        for i in range(0, len(data), 255):
            chunk = data[i:i + 255]
            blocks.append(bytes([len(chunk)]) + chunk)
        blocks.append(b"\x00")
        out.append(b"".join(blocks))
    out.append(b"\x3b")
    return b"".join(out)


def _sub_blocks(data: bytes, pos: int):
    parts = []
    while True:
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos:pos + n])
        pos += n


def decode_gif(data: bytes) -> dict:
    """GIF file bytes -> {"frames": list of (H, W, 3) uint8 RGB canvases,
    one per image, "durations": their delays in ms, "loop": the NETSCAPE
    loop count or None}.  Each image is drawn onto the previous canvas
    (the disposal is ignored); interlaced images raise."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    w, h, packed, _, _ = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    gct = None
    if packed & 0x80:
        n = 3 << ((packed & 7) + 1)
        gct = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n
    canvas = np.zeros((h, w, 3), np.uint8)
    frames, durations, loop, delay, transparent = [], [], None, 0, None
    lib = native.load()
    while pos < len(data):
        block = data[pos]
        pos += 1
        if block == 0x3B:
            break
        if block == 0x21:
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:
                delay = struct.unpack("<H", body[1:3])[0] * 10
                transparent = body[3] if body[0] & 1 else None
            elif label == 0xFF and body[:11] == b"NETSCAPE2.0" and \
                    len(body) >= 14:
                loop = struct.unpack("<H", body[12:14])[0]
            continue
        if block != 0x2C:
            raise ValueError(f"GIF block 0x{block:02x} is not understood")
        x0, y0, iw, ih, ip = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        if ip & 0x40:
            raise ValueError("interlaced GIF images are not read")
        pal = gct
        if ip & 0x80:
            n = 3 << ((ip & 7) + 1)
            pal = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
            pos += n
        min_code = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        idx = np.empty(iw * ih, np.uint8)
        got = lib.gif_unlzw(np.frombuffer(lzw, np.uint8).copy(), len(lzw),
                            min_code, idx, idx.size)
        if got != idx.size or pal is None:
            raise ValueError(f"GIF image data decode to {got} of "
                             f"{idx.size} pixels")
        idx = idx.reshape(ih, iw)
        region = canvas[y0:y0 + ih, x0:x0 + iw]
        keep = np.ones(idx.shape, bool) if transparent is None else (
            idx != transparent)
        region[keep] = pal[np.minimum(idx, len(pal) - 1)][keep]
        frames.append(canvas.copy())
        durations.append(delay)
        transparent = None
    return {"frames": frames, "durations": durations, "loop": loop}
