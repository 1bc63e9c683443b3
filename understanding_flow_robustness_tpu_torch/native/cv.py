"""The OpenCV and Pillow calls of the port's corruptions, self-correlated
patches and image readers, on the host library (``native/src/ufr_cv.cpp``):
each function is named and shaped like the call it replaces, checks its
input's dtype and shape, and returns what that call returns, so that the
machine with the card needs neither cv2 nor PIL.

  cvtColor(x, COLOR_RGB2HSV / HSV2RGB)  -> rgb2hsv, hsv2rgb (float32)
  getGaussianKernel, GaussianBlur        -> get_gaussian_kernel,
                                            gaussian_blur (float32 plane)
  filter2D                               -> filter2d (float64 plane, float
                                            kernel), filter2d_u8_3x3
  getAffineTransform, warpAffine         -> get_affine_transform,
                                            warp_affine (float64 image)
  resize(INTER_CUBIC)                    -> resize_cubic (float64 or uint8)
  Canny, distanceTransform(DIST_L2, 5),
  threshold(THRESH_TRUNC), blur((3, 3)),
  equalizeHist                           -> canny, distance_transform_l2_5,
                                            threshold_trunc, blur3,
                                            equalize_hist
  circle(..., thickness, LINE_8)         -> circle (in place)
  imread(path) (BGR uint8)               -> imread_bgr
  PIL Image.resize(BOX / NEAREST)        -> pil_resize
"""

from __future__ import annotations

import math

import numpy as np

from . import load


def _check(x, dtype, ndim, channels=None, name="image"):
    x = np.asarray(x)
    if x.dtype != dtype or x.ndim not in ndim or (
            channels is not None and x.ndim == 3 and x.shape[2] != channels):
        want = f"{np.dtype(dtype).name} with {ndim} dimensions" + (
            f" and {channels} channels" if channels else "")
        raise ValueError(f"{name}: expected {want}, got {x.dtype} {x.shape}")
    return np.ascontiguousarray(x)


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a float32 (H, W, 3)
    image: H in degrees [0, 360), S and V as the input's scale."""
    x = _check(img, np.float32, (3,), 3)
    out = np.empty_like(x)
    load().cv_rgb2hsv_f32(x, out, x.shape[0], x.shape[1])
    return out


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a float32 (H, W, 3)."""
    x = _check(hsv, np.float32, (3,), 3)
    out = np.empty_like(x)
    load().cv_hsv2rgb_f32(x, out, x.shape[0], x.shape[1])
    return out


def get_gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(n, sigma, cv2.CV_32F)`` for odd n and
    sigma > 0, as a 1-D float32 array: exp(-x^2 / (2 sigma^2)) over the
    half-integers (x in 2x units), normalised in double, then rounded."""
    if n % 2 != 1 or sigma <= 0:
        raise ValueError(f"odd kernel size and sigma > 0 only, got {n}, "
                         f"{sigma}")
    scale2x = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    vals, total = [], 0.0
    for i, x in enumerate(range(1 - n, 0, 2)):
        t = math.exp(float(x * x) * scale2x)
        vals.append(t)
        total += t
    total = total * 2 + 1.0
    mul = 1.0 / total
    k = np.empty(n)
    for i in range(half):
        k[i] = k[n - 1 - i] = vals[i] * mul
    k[half] = 1.0 * mul
    return k.astype(np.float32)


def gaussian_blur(plane: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(plane, (ksize, ksize), sigmaX=sigma)`` of a
    float32 (H, W) plane, H > 1 (or W = 1), ksize 3 or 5,
    BORDER_REFLECT_101."""
    x = _check(plane, np.float32, (2,), name="plane")
    if ksize not in (3, 5):
        raise ValueError(f"ksize 3 or 5 only, got {ksize}")
    if x.shape[0] == 1 and x.shape[1] > 1:
        raise ValueError("a single-row plane (OpenCV's own path) is not "
                         "ported")
    k = get_gaussian_kernel(ksize, sigma)
    out = np.empty_like(x)
    load().cv_sep_filter_f32(x, out, x.shape[0], x.shape[1], k, ksize)
    return out


def filter2d(plane: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(plane, -1, kernel)`` of a float64 (H, W) plane with a
    float32 kernel of odd sides, BORDER_REFLECT_101."""
    x = _check(plane, np.float64, (2,), name="plane")
    k = _check(kernel, np.float32, (2,), name="kernel")
    if k.shape[0] % 2 != 1 or k.shape[1] % 2 != 1:
        raise ValueError(f"odd kernel sides only, got {k.shape}")
    out = np.empty_like(x)
    load().cv_filter2d_f64(x, out, x.shape[0], x.shape[1], k, *k.shape)
    return out


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getAffineTransform(src, dst)`` of two (3, 2) float32 point
    sets -> the (2, 3) float64 matrix."""
    s = _check(src, np.float32, (2,), name="src")
    d = _check(dst, np.float32, (2,), name="dst")
    if s.shape != (3, 2) or d.shape != (3, 2):
        raise ValueError(f"expected (3, 2) points, got {s.shape}, {d.shape}")
    m = np.empty(6)
    if load().cv_affine_transform(s.reshape(-1), d.reshape(-1), m):
        raise ValueError("getAffineTransform: the source points are "
                         "collinear")
    return m.reshape(2, 3)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderMode=cv2.BORDER_REFLECT_101)``
    (INTER_LINEAR) of a float64 (H, W, C) image; dsize = (W, H), the
    input's own size."""
    x = _check(img, np.float64, (3,))
    if tuple(dsize) != (x.shape[1], x.shape[0]):
        raise ValueError(f"dsize {tuple(dsize)} must be the image's "
                         f"(W, H) = {(x.shape[1], x.shape[0])}")
    mat = np.ascontiguousarray(m, np.float64).reshape(-1)
    if mat.size != 6:
        raise ValueError(f"expected a 2x3 matrix, got {np.shape(m)}")
    out = np.empty_like(x)
    load().cv_warp_affine_f64(x, out, *x.shape, mat)
    return out


def resize_cubic(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC)`` of a
    float64 (H, W) or (H, W, C) image or a uint8 (H, W, 3) one (the pip
    OpenCV's: Intel IPP's float code from 4 pixels a side); dsize =
    (W, H)."""
    x = np.asarray(img)
    if not ((x.dtype == np.float64 and x.ndim in (2, 3))
            or (x.dtype == np.uint8 and x.ndim == 3 and x.shape[2] == 3)):
        raise ValueError(f"expected a float64 (H, W[, C]) or uint8 "
                         f"(H, W, 3) image, got {x.dtype} {x.shape}")
    ow, oh = map(int, dsize)
    if ow <= 0 or oh <= 0:
        raise ValueError(f"dsize must be positive, got {tuple(dsize)}")
    x3 = np.ascontiguousarray(x).reshape(x.shape[0], x.shape[1], -1)
    out = np.empty((oh, ow, x3.shape[2]), x.dtype)
    fn = (load().cv_resize_cubic_f64 if x.dtype == np.float64
          else load().cv_resize_cubic_u8)
    fn(x3, out, *x3.shape, oh, ow)
    return out.reshape((oh, ow) + x.shape[2:])


def canny(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(img, low, high)`` (aperture 3, L1 gradient) of a uint8
    (H, W) image: 255 on edges, 0 elsewhere."""
    x = _check(img, np.uint8, (2,))
    lo, hi = sorted((low, high))
    out = np.empty_like(x)
    load().cv_canny_u8(x, out, *x.shape, math.floor(lo), math.floor(hi))
    return out


def distance_transform_l2_5(img: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(img, cv2.DIST_L2, 5)`` of a uint8 (H, W)
    image: the float32 distance to the nearest zero pixel (FLT_MAX where
    there is none)."""
    x = _check(img, np.uint8, (2,))
    out = np.empty(x.shape, np.float32)
    load().cv_distance_l2_5(x, out, *x.shape)
    return out


def threshold_trunc(img: np.ndarray, thresh: float) -> np.ndarray:
    """``cv2.threshold(img, thresh, maxval, cv2.THRESH_TRUNC)[1]`` of a
    float32 image: values above ``thresh`` become ``thresh``."""
    x = _check(img, np.float32, (2, 3))
    return np.where(x > np.float32(thresh), np.float32(thresh), x)


def blur3(img: np.ndarray) -> np.ndarray:
    """``cv2.blur(img, (3, 3))`` of a float32 or uint8 (H, W) plane,
    BORDER_REFLECT_101."""
    x = np.asarray(img)
    if x.dtype not in (np.float32, np.uint8) or x.ndim != 2:
        raise ValueError(f"expected a float32 or uint8 (H, W) plane, got "
                         f"{x.dtype} {x.shape}")
    x = np.ascontiguousarray(x)
    out = np.empty_like(x)
    fn = load().cv_box3_f32 if x.dtype == np.float32 else load().cv_box3_u8
    fn(x, out, *x.shape)
    return out


def equalize_hist(img: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist(img)`` of a uint8 (H, W) image."""
    x = _check(img, np.uint8, (2,))
    out = np.zeros_like(x)
    load().cv_equalize_hist(x.reshape(-1), out.reshape(-1), x.size)
    return out


def filter2d_u8_3x3(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, cv2.CV_8U, kernel)`` of a uint8 (H, W) image
    with an integer 3x3 kernel, BORDER_REFLECT_101, saturated."""
    x = _check(img, np.uint8, (2,))
    k = np.asarray(kernel)
    if k.shape != (3, 3) or not np.issubdtype(k.dtype, np.integer):
        raise ValueError(f"expected an integer 3x3 kernel, got {k.dtype} "
                         f"{k.shape}")
    out = np.empty_like(x)
    load().cv_filter2d_u8_3x3(x, out, *x.shape,
                              np.ascontiguousarray(k, np.int32).reshape(-1))
    return out


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness)`` (LINE_8, no
    shift, an outline: thickness >= 1) on an (H, W) or (H, W, C) array, in
    place; returns ``img``."""
    if img.ndim not in (2, 3):
        raise ValueError(f"expected (H, W[, C]), got {img.shape}")
    if radius < 0 or thickness < 1:
        raise ValueError(f"radius >= 0 and thickness >= 1, got {radius}, "
                         f"{thickness}")
    h, w = img.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    load().cv_circle_mask(mask, h, w, int(center[0]), int(center[1]),
                          int(radius), int(thickness))
    col = np.asarray(color, img.dtype)
    img[mask.astype(bool)] = col[: img.shape[2]] if img.ndim == 3 else col[0]
    return img


def imread_bgr(path: str) -> np.ndarray:
    """``cv2.imread(path)``: a PNG or baseline JPEG file as (H, W, 3) uint8
    BGR; grey is repeated into three channels, alpha dropped, 16-bit
    samples cut to their high byte.  The files ``flowviz.io.read_samples``
    refuses (palette PNG, progressive JPEG, ...) raise."""
    from ..flowviz.io import read_samples

    px = read_samples(path)
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[2] in (1, 2):
        px = px[..., :1].repeat(3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def pil_resize(img: np.ndarray, size, resample: str) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size, Image.BOX or
    Image.NEAREST))`` of a uint8 (H, W) or (H, W, 3) image; size = (W, H),
    resample "box" or "nearest"."""
    x = np.asarray(img)
    if x.dtype != np.uint8 or x.ndim not in (2, 3) or (
            x.ndim == 3 and x.shape[2] != 3):
        raise ValueError(f"expected a uint8 (H, W) or (H, W, 3) image, got "
                         f"{x.dtype} {x.shape}")
    ow, oh = map(int, size)
    if ow <= 0 or oh <= 0:
        raise ValueError(f"size must be positive, got {tuple(size)}")
    fn = {"box": load().resize_pil_box_u8,
          "nearest": load().pil_resize_nearest_u8}[resample]
    x3 = np.ascontiguousarray(x).reshape(x.shape[0], x.shape[1], -1)
    out = np.empty((oh, ow, x3.shape[2]), np.uint8)
    fn(x3, out, *x3.shape, oh, ow)
    return out.reshape((oh, ow) + x.shape[2:])
