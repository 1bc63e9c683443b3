"""ctypes bindings of the port's host library ``native/src/ufr_native.cpp``,
``ufr_jpeg.cpp``, ``ufr_jpeg_enc.cpp`` and ``ufr_cv.cpp``
(counterpart of ``understanding_flow_robustness_tpu/native/__init__.py``).

The library is standard C++ with OpenMP, built with ``g++`` at first use
into ``build/host_native/`` beside the package, named by a hash of the
source and the flags, so it is rebuilt only when either changes.  There is
no fallback: when the library cannot be built or loaded, the call raises.
Nothing is built at import time.  ctypes releases the GIL for each call,
so decoder threads overlap in these functions.

``png_unfilter``, ``resize_pil_bilinear_u8``, ``resize_cv2_linear_f32``,
``resize_cv2_linear_u8``, ``resize_cv2_linear_f32_by``, ``pil_color_op``
and ``decode_jpeg`` are the port's own: PNG row reconstruction, PIL's
``BILINEAR`` resize, cv2's ``INTER_LINEAR`` resize to a size and by
factors, PIL's colour enhancements and a baseline JPEG decoder, so that
the machine with the card reads, augments and resizes frames with neither
PIL nor cv2.  ``jpeg_encode`` (wrapped by ``flowviz/jpeg.py``) is
libjpeg-turbo's baseline encoder at its defaults; the OpenCV and Pillow
operations of the corruptions, the self-correlated circle patch and the
GIF codec are bound here and wrapped, shaped like the calls they replace,
in ``native/cv.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRCS = tuple(Path(__file__).resolve().parent / "src" / name
             for name in ("ufr_native.cpp", "ufr_jpeg.cpp",
                          "ufr_jpeg_enc.cpp", "ufr_cv.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_native"
# portable code (no -march=native); no contraction into FMAs, so that the
# resizes round as the libraries they match do on every host
CXX_FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in SRCS)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libufr_native_{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, *map(str, SRCS), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building the host library "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The host library, built first if needed; raises when it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f64 = ctypes.c_double
        for name, args in (
                ("batch_u8_to_float01_pad", [u8p, f32p] + [i64] * 8),
                ("batch_f32_pad", [f32p, f32p] + [i64] * 8 + [ctypes.c_int]),
                ("resize_sparse_flow", [f32p, f32p, i64, i64, i64, i64,
                                        ctypes.c_double, ctypes.c_double,
                                        f32p, i32p]),
                ("resize_bilinear_u8", [u8p, u8p] + [i64] * 5),
                ("decode_kitti_flow_u16", [u16p, i64, i64, f32p, f32p]),
                ("resize_pil_bilinear_u8", [u8p, u8p] + [i64] * 5),
                ("resize_pil_box_u8", [u8p, u8p] + [i64] * 5),
                ("resize_cv2_linear_f32", [u8p, f32p] + [i64] * 5),
                ("resize_cv2_linear_u8", [u8p, u8p] + [i64] * 5 + [f64] * 2),
                ("resize_cv2_linear_f32_by",
                 [f32p, f32p] + [i64] * 5 + [f64] * 2),
                ("resize_cv2_linear_f64_by",
                 [f64p, f64p] + [i64] * 5 + [f64] * 2),
                ("pil_color_op", [u8p, i64, ctypes.c_int, f64, ctypes.c_int]),
                ("pil_hsv_convert", [u8p, u8p, i64, ctypes.c_int])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        for name, args in (
                ("jpeg_header", [ctypes.c_char_p, i64, i64p, ctypes.c_char_p,
                                 i64]),
                ("jpeg_decode", [ctypes.c_char_p, i64, u8p, i64, i64, i64,
                                 ctypes.c_char_p, i64])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        i32 = ctypes.c_int
        for name, args, res in (
                ("cv_rgb2hsv_f32", [f32p, f32p, i64, i64], None),
                ("cv_hsv2rgb_f32", [f32p, f32p, i64, i64], None),
                ("cv_sep_filter_f32", [f32p, f32p, i64, i64, f32p, i32], i32),
                ("cv_filter2d_f64", [f64p, f64p, i64, i64, f32p, i64, i64],
                 None),
                ("cv_affine_transform", [f32p, f32p, f64p], i32),
                ("cv_warp_affine_f64", [f64p, f64p, i64, i64, i64, f64p],
                 None),
                ("cv_resize_cubic_f64", [f64p, f64p] + [i64] * 5, None),
                ("cv_resize_cubic_u8", [u8p, u8p] + [i64] * 5, None),
                ("cv_canny_u8", [u8p, u8p, i64, i64, i32, i32], None),
                ("cv_distance_l2_5", [u8p, f32p, i64, i64], None),
                ("cv_box3_f32", [f32p, f32p, i64, i64], None),
                ("cv_box3_u8", [u8p, u8p, i64, i64], None),
                ("cv_equalize_hist", [u8p, u8p, i64], None),
                ("cv_filter2d_u8_3x3", [u8p, u8p, i64, i64, i32p], None),
                ("cv_circle_mask", [u8p, i64, i64, i64, i64, i64, i32],
                 None),
                ("pil_resize_nearest_u8", [u8p, u8p] + [i64] * 5, None),
                ("gif_lzw", [u8p, i64, u8p, i64], i64),
                ("gif_unlzw", [u8p, i64, i32, u8p, i64], i64),
                ("jpeg_encode", [u8p, i64, i64, i32, u8p, i64], i64)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        lib.png_unfilter.argtypes = [u8p, u8p, i64, i64, i64]
        lib.png_unfilter.restype = i64
        lib.ufr_native_version.restype = ctypes.c_int
        _LIB = lib
        return lib


def _pad_args(shape, out_h, out_w, top, left):
    n, h, w, c = shape
    if not (0 <= top <= out_h - h and 0 <= left <= out_w - w):
        raise ValueError(f"cannot pad {h}x{w} into {out_h}x{out_w} at "
                         f"({top}, {left})")
    return n, h, w, c, out_h, out_w, top, left


def batch_u8_to_float01_pad(imgs: np.ndarray, out_h: int, out_w: int,
                            top: int, left: int) -> np.ndarray:
    """(n, h, w, c) uint8 -> (n, out_h, out_w, c) float32 / 255 with
    replicate padding."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    args = _pad_args(imgs.shape, out_h, out_w, top, left)
    out = np.empty((imgs.shape[0], out_h, out_w, imgs.shape[3]), np.float32)
    load().batch_u8_to_float01_pad(imgs, out, *args)
    return out


def batch_f32_pad(x: np.ndarray, out_h: int, out_w: int, top: int,
                  left: int, zero: bool = False) -> np.ndarray:
    """(n, h, w, c) float32 -> (n, out_h, out_w, c) with replicate
    (zero=False) or zero (zero=True) padding."""
    x = np.ascontiguousarray(x, np.float32)
    args = _pad_args(x.shape, out_h, out_w, top, left)
    out = np.empty((x.shape[0], out_h, out_w, x.shape[3]), np.float32)
    load().batch_f32_pad(x, out, *args, 1 if zero else 0)
    return out


def resize_sparse_flow(flow: np.ndarray, valid: np.ndarray,
                       fx: float, fy: float):
    """(h, w, 2) flow and (h, w) valid -> the sparse-aware resize to
    (round(h fy), round(w fx)): ((h1, w1, 2) f32, (h1, w1) int32)."""
    h, w = flow.shape[:2]
    if flow.shape != (h, w, 2) or np.shape(valid) != (h, w):
        raise ValueError(f"flow {flow.shape} and valid {np.shape(valid)}")
    h1, w1 = int(round(h * fy)), int(round(w * fx))
    fo = np.empty((h1, w1, 2), np.float32)
    vo = np.empty((h1, w1), np.int32)
    load().resize_sparse_flow(
        np.ascontiguousarray(flow, np.float32),
        np.ascontiguousarray(valid, np.float32), h, w, h1, w1, fx, fy, fo, vo)
    return fo, vo


def _hwc_u8(img: np.ndarray):
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (H, W, C), got {img.shape}")
    return img, img.reshape(img.shape[0], img.shape[1], -1)


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear u8 resize (half-pixel centres, edge clamp, f32 weights,
    rounded) of (H, W) or (H, W, C); the output keeps the input's rank."""
    img, x = _hwc_u8(img)
    out = np.empty((oh, ow, x.shape[2]), np.uint8)
    load().resize_bilinear_u8(x, out, *x.shape, oh, ow)
    return out.reshape((oh, ow) + img.shape[2:])


def resize_pil_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """PIL ``Image.fromarray(img).resize((ow, oh), Image.BILINEAR)`` of a
    u8 (H, W) or (H, W, 3) image, bit for bit.  PIL resizes RGBA
    premultiplied, which is not ported: 4 channels raise."""
    img, x = _hwc_u8(img)
    if x.shape[2] not in (1, 3) or (img.ndim == 3 and x.shape[2] == 1):
        raise ValueError(f"PIL's bilinear resize is ported for (H, W) and "
                         f"(H, W, 3) images, not {img.shape}")
    out = np.empty((oh, ow, x.shape[2]), np.uint8)
    load().resize_pil_bilinear_u8(x, out, *x.shape, oh, ow)
    return out.reshape((oh, ow) + img.shape[2:])


def resize_cv2_linear_f32(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """``cv2.resize(img.astype(np.float32), (ow, oh),
    interpolation=cv2.INTER_LINEAR)`` of a u8 (H, W) or (H, W, C) image
    (the KITTI pair datasets' resize); the output keeps the input's rank,
    as cv2 does for C > 1."""
    img, x = _hwc_u8(img)
    out = np.empty((oh, ow, x.shape[2]), np.float32)
    load().resize_cv2_linear_f32(x, out, *x.shape, oh, ow)
    return out.reshape((oh, ow) + img.shape[2:])


def decode_kitti_flow_u16(rgb16: np.ndarray):
    """(H, W, 3) uint16 KITTI flow payload -> ((H, W, 2) flow =
    (u16 - 2^15) / 64, (H, W) valid), both float32."""
    if rgb16.dtype != np.uint16 or rgb16.ndim != 3 or rgb16.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint16, got {rgb16.dtype} "
                         f"{rgb16.shape}")
    h, w = rgb16.shape[:2]
    flow = np.empty((h, w, 2), np.float32)
    valid = np.empty((h, w), np.float32)
    load().decode_kitti_flow_u16(np.ascontiguousarray(rgb16), h, w, flow,
                                 valid)
    return flow, valid


def png_unfilter(data: np.ndarray, height: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """The inflated IDAT stream of a non-interlaced PNG, ``height`` rows of
    a filter-type byte and ``row_bytes`` bytes, -> (height, row_bytes) u8
    with the row filters undone; ``bpp`` is the bytes of one pixel."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.size < height * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, fewer "
                         f"than {height} rows of 1 + {row_bytes}")
    out = np.empty((height, row_bytes), np.uint8)
    bad = load().png_unfilter(data, out, height, row_bytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type "
                         f"{data[(bad - 1) * (row_bytes + 1)]}, not 0-4")
    return out


def cv2_factor_size(h: int, w: int, fx: float, fy: float):
    """cv2.resize's output (oh, ow) for factors: each side times its factor,
    rounded half to even (saturate_cast<int> of a double)."""
    return int(np.rint(h * fy)), int(np.rint(w * fx))


def resize_cv2_linear_u8(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)``
    of a u8 (H, W) or (H, W, C) image, bit for bit; the output keeps the
    input's rank."""
    img, x = _hwc_u8(img)
    oh, ow = cv2_factor_size(x.shape[0], x.shape[1], fx, fy)
    out = np.empty((oh, ow, x.shape[2]), np.uint8)
    load().resize_cv2_linear_u8(x, out, *x.shape, oh, ow, float(fx),
                                float(fy))
    return out.reshape((oh, ow) + img.shape[2:])


def resize_cv2_linear_flow(x: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(x, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)``
    of a float32 or float64 (H, W, 2) flow (the augmentors'), bit for bit,
    in the input's type (an exact 2x reduction only for float32)."""
    x = np.asarray(x)
    if x.ndim != 3 or x.shape[2] != 2:
        raise ValueError(f"expected (H, W, 2), got {x.shape}")
    dtype = np.float64 if x.dtype == np.float64 else np.float32
    if dtype == np.float64 and fx == fy == 0.5:
        raise ValueError("cv2's 2x area reduction of float64 is not ported")
    x = np.ascontiguousarray(x, dtype)
    oh, ow = cv2_factor_size(x.shape[0], x.shape[1], fx, fy)
    out = np.empty((oh, ow, 2), dtype)
    fn = (load().resize_cv2_linear_f64_by if dtype == np.float64
          else load().resize_cv2_linear_f32_by)
    fn(x, out, *x.shape, oh, ow, float(fx), float(fy))
    return out


COLOR_OPS = {"brightness": 0, "contrast": 1, "saturation": 2, "hue": 3}


def pil_color_op(img: np.ndarray, op: str, factor: float = 0.0,
                 shift: int = 0) -> np.ndarray:
    """One of ColorJitter's PIL operations on a u8 (H, W, 3) image, bit for
    bit: ``ImageEnhance.Brightness/Contrast/Color(im).enhance(factor)``
    for "brightness" / "contrast" / "saturation", and for "hue" the HSV
    round trip with H rolled by ``shift`` (mod 256).  Returns a new array."""
    out = np.array(img, np.uint8, order="C", copy=True)
    if out.ndim != 3 or out.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {out.shape}")
    n = out.shape[0] * out.shape[1]
    if n:
        load().pil_color_op(out.reshape(-1), n, COLOR_OPS[op], float(factor),
                            int(shift))
    return out


def pil_hsv_convert(px: np.ndarray, to_hsv: bool) -> np.ndarray:
    """PIL's RGB -> HSV (``to_hsv``) or HSV -> RGB conversion of (..., 3)
    u8 pixels."""
    px = np.ascontiguousarray(px, np.uint8)
    out = np.empty_like(px)
    load().pil_hsv_convert(px, out, px.size // 3, int(to_hsv))
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG file's samples as PIL (libjpeg-turbo at its defaults)
    decodes them: (H, W) u8 for a grey file, (H, W, 3) RGB u8 for a YCbCr
    one.  Any other kind of file (progressive, arithmetic-coded, 12-bit,
    CMYK, ...) raises ValueError."""
    lib = load()
    err = ctypes.create_string_buffer(256)
    hwc = np.zeros(3, np.int64)
    if lib.jpeg_header(data, len(data), hwc, err, len(err)):
        raise ValueError(err.value.decode())
    h, w, c = map(int, hwc)
    out = np.empty((h, w, c), np.uint8)
    if lib.jpeg_decode(data, len(data), out, h, w, c, err, len(err)):
        raise ValueError(err.value.decode())
    return out[..., 0] if c == 1 else out

