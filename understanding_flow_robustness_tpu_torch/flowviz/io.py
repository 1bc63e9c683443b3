"""Flow and image file I/O (counterpart of
``understanding_flow_robustness_tpu/flowviz/io.py``; reference:
dataset_utils/data_utils.py:22-278, flowutils/flow_io.py, flowutils/pfm.py).

Formats:
  * Middlebury .flo            -- f32 little-endian, magic 202021.25
  * KITTI 16-bit flow PNG      -- (value - 2^15) / 64, third channel = valid
  * KITTI disparity PNG        -- uint16 / 256
  * PFM                        -- FlyingThings3D disparity / flow
  * PNG, PPM, PGM images       -- the port's own codec (``png.py``) and the
                                  host library: no cv2 and no PIL
  * JPEG images                -- baseline sequential only, through the host
                                  library's decoder (``native.decode_jpeg``),
                                  bit-equal to PIL's; other kinds raise

The JAX package reads a KITTI flow PNG with cv2 (BGR) and reverses the
channels; this reads the file's own (u, v, valid) order.  ``read_image``
keeps an alpha channel, as the JAX package's native decoder does.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .. import native
from .png import decode_png, encode_png

TAG_FLOAT = 202021.25
_PNM_MAGIC = {b"P5": 1, b"P6": 3}


def _decode_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6) -> (H, W) / (H, W, 3) uint8 or uint16."""
    fields, pos = [], 0
    while len(fields) < 4:
        m = re.compile(rb"\s*(#[^\n]*\n\s*)*(\S+)").match(data, pos)
        if m is None:
            raise ValueError("malformed PPM/PGM header")
        fields.append(m.group(2))
        pos = m.end()
    magic, width, height, maxval = fields[0], *map(int, fields[1:])
    if magic not in _PNM_MAGIC or not 0 < maxval < 65536:
        raise ValueError(f"not a binary PPM/PGM file ({magic!r}, {maxval})")
    channels = _PNM_MAGIC[magic]
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    n = width * height * channels
    px = np.frombuffer(data, dtype, count=n, offset=pos + 1)
    px = px.astype(np.uint16) if dtype.itemsize == 2 else px.copy()
    return px.reshape((height, width) + ((3,) if channels == 3 else ()))


def read_samples(path: str) -> np.ndarray:
    """A PNG, PPM, PGM or JPEG file's samples in its own dtype (uint8 or
    uint16) and channel order: (H, W) or (H, W, C)."""
    ext = os.path.splitext(path)[-1].lower()
    with open(path, "rb") as f:
        data = f.read()
    if ext in (".jpg", ".jpeg"):
        try:
            return native.decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    if ext == ".png":
        return decode_png(data)
    if ext in (".ppm", ".pgm"):
        return _decode_pnm(data)
    raise ValueError(f"{path}: not a PNG, PPM, PGM or JPEG file")


def write_image(path: str, img: np.ndarray) -> None:
    """(H, W) or (H, W, C) uint8 / uint16 samples to a PNG (C in 1-4),
    PPM (C = 3) or PGM (2-D) file, by extension."""
    ext = os.path.splitext(path)[-1].lower()
    img = np.asarray(img)
    if ext == ".png":
        data = encode_png(img)
    elif ext in (".ppm", ".pgm"):
        magic = b"P6" if ext == ".ppm" else b"P5"
        if img.dtype not in (np.uint8, np.uint16) or img.shape[2:] != (
                (3,) if magic == b"P6" else ()):
            raise ValueError(f"{path}: a {ext} file takes uint8/uint16 "
                             f"{'(H, W, 3)' if magic == b'P6' else '(H, W)'}"
                             f", not {img.dtype} {img.shape}")
        maxval = 255 if img.dtype == np.uint8 else 65535
        data = (magic + f"\n{img.shape[1]} {img.shape[0]}\n{maxval}\n"
                .encode() + img.astype(img.dtype.newbyteorder(">")).tobytes())
    else:
        raise ValueError(f"{path}: the port writes PNG, PPM and PGM images")
    with open(path, "wb") as f:
        f.write(data)


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(TAG_FLOAT):
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_flow_png(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit flow PNG -> (flow (H, W, 2), valid (H, W)), float32:
    (v - 2^15) / 64, exact in f32 for every u16 (data_utils.py:259-264)."""
    raw = read_samples(path)
    if raw.dtype != np.uint16 or raw.ndim != 3 or raw.shape[2] != 3:
        raise ValueError(f"{path}: a KITTI flow PNG is 16-bit RGB, not "
                         f"{raw.dtype} {raw.shape}")
    return native.decode_kitti_flow_u16(raw)


def write_flow_png(path: str, flow: np.ndarray,
                   valid: np.ndarray | None = None) -> None:
    """data_utils.py:274-278 (writeFlowKITTI): 64 flow + 2^15 and the
    valid mask, cast to uint16 (truncating, as numpy casts)."""
    h, w = flow.shape[:2]
    uv = 64.0 * np.asarray(flow, np.float64) + 2 ** 15
    if valid is None:
        valid = np.ones((h, w), np.float64)
    out = np.concatenate([uv, np.asarray(valid, np.float64)[..., None]],
                         axis=-1).astype(np.uint16)
    write_image(path, out)


def read_disparity_png(path: str) -> np.ndarray:
    disp = read_samples(path)
    if disp.dtype != np.uint16 or disp.ndim != 2:
        raise ValueError(f"{path}: a KITTI disparity PNG is 16-bit grey, "
                         f"not {disp.dtype} {disp.shape}")
    return (disp / 256.0).astype(np.float32)


def read_pfm(path: str) -> np.ndarray:
    """flowutils/pfm.py:7-41 / data_utils.py:78-113."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        m = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not m:
            raise ValueError("malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """flowutils/pfm.py:44-71."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxWx3, HxWx1 or HxW")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def _as_pil_reads(px: np.ndarray) -> np.ndarray:
    """16-bit colour samples to their high byte, as PIL reads such a file
    (16-bit grey keeps its values)."""
    if px.dtype == np.uint16 and px.ndim == 3:
        return (px >> 8).astype(np.uint8)
    return px


def read_image(path: str) -> np.ndarray:
    """An image file's samples as float32 (data_utils.py:22-23
    load_as_float), alpha kept, 16-bit samples as PIL reads them for the
    JAX package."""
    return _as_pil_reads(read_samples(path)).astype(np.float32)


def read_gen(path: str):
    """Extension-dispatched reader (data_utils.py:116-130): images as the
    array of the PIL image the JAX package returns, .flo / .pfm flow as float32,
    .bin / .raw with np.load; [] for any other extension."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".ppm", ".jpeg", ".jpg"):
        return _as_pil_reads(read_samples(path))
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []


def read_paths(path: str) -> list[str]:
    with open(path) as f:
        return [line.rstrip() for line in f if line.rstrip()]


def write_paths(path: str, paths: list[str]) -> None:
    with open(path, "w") as f:
        for p in paths:
            f.write(p + "\n")
