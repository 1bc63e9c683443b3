"""Visualization helpers (counterpart of
``understanding_flow_robustness_tpu/utils/viz.py``; reference:
patch_attacks/utils.py:21-60), with no cv2.

``tensor2array`` renders 1-channel maps through cv2's COLORMAP_RAINBOW or
COLORMAP_BONE and passes 3-channel images through (with the [-1, 1] ->
[0, 1] shift); NHWC in/out instead of the reference's CHW.  The colormaps
are built as OpenCV builds them (modules/imgproc/src/colormap.cpp): 64
control points per channel (OpenCV's constants, as float32), OpenCV's
float32 ``linspace`` and ``interp1`` to 256 entries, and ``convertTo``'s
rounding to u8, which gives ``cv2.applyColorMap``'s LUTs bit for bit.
"""

from __future__ import annotations

import numpy as np

# OpenCV's Rainbow control points (colormap.cpp ``Rainbow::init``), exact
# as numerators over 189 (red), 252 (green) and 63 (blue)
_RAINBOW = (
    np.array([189] * 26 + [177, 162, 147, 132, 117, 102, 87, 72, 57, 42, 27,
                           12] + [0] * 13
             + [6, 16, 26, 36, 46, 56, 66, 76, 86, 96, 106, 116, 126]) / 189,
    np.array(list(range(0, 251, 10)) + [252] * 12
             + list(range(248, 7, -20)) + [0] * 13) / 252,
    np.array([0] * 38 + list(range(1, 62, 5)) + [63] * 13) / 63,
)

# OpenCV's Bone control points (colormap.cpp ``Bone::init``, MATLAB's
# bone(64)), as float32
_BONE = (
    (0, 0.013888889, 0.027777778, 0.041666668, 0.055555556, 0.06944445,
     0.083333336, 0.097222224, 0.11111111, 0.125, 0.1388889, 0.15277778,
     0.16666667, 0.18055555, 0.19444445, 0.20833333, 0.22222222, 0.2361111,
     0.25, 0.2638889, 0.2777778, 0.29166666, 0.30555555, 0.31944445,
     0.33333334, 0.3472222, 0.3611111, 0.375, 0.3888889, 0.4027778,
     0.41666666, 0.43055555, 0.44444445, 0.45833334, 0.4722222, 0.4861111,
     0.5, 0.5138889, 0.5277778, 0.5416667, 0.5555556, 0.5694444, 0.5833333,
     0.5972222, 0.6111111, 0.625, 0.6388889, 0.6527778, 0.67261904,
     0.6944444, 0.71626985, 0.7380952, 0.75992066, 0.78174603, 0.8035714,
     0.82539684, 0.8472222, 0.86904764, 0.890873, 0.9126984, 0.9345238,
     0.9563492, 0.9781746, 1),
    (0, 0.013888889, 0.027777778, 0.041666668, 0.055555556, 0.06944445,
     0.083333336, 0.097222224, 0.11111111, 0.125, 0.1388889, 0.15277778,
     0.16666667, 0.18055555, 0.19444445, 0.20833333, 0.22222222, 0.2361111,
     0.25, 0.2638889, 0.2777778, 0.29166666, 0.30555555, 0.31944445,
     0.33531746, 0.35449734, 0.37367725, 0.39285713, 0.41203704,
     0.43121693, 0.45039684, 0.46957672, 0.48875663, 0.50793654, 0.5271164,
     0.5462963, 0.5654762, 0.58465606, 0.603836, 0.6230159, 0.64219576,
     0.66137564, 0.6805556, 0.69973546, 0.71891534, 0.7380952, 0.7572751,
     0.77645504, 0.7916667, 0.8055556, 0.8194444, 0.8333333, 0.8472222,
     0.8611111, 0.875, 0.8888889, 0.9027778, 0.9166667, 0.9305556,
     0.9444444, 0.9583333, 0.9722222, 0.9861111, 1),
    (0, 0.019179894, 0.038359787, 0.057539683, 0.076719575, 0.09589947,
     0.115079366, 0.13425925, 0.15343915, 0.17261904, 0.19179894, 0.21097884,
     0.23015873, 0.24933863, 0.2685185, 0.28769842, 0.3068783, 0.3260582,
     0.3452381, 0.364418, 0.38359788, 0.4027778, 0.42195767, 0.44113755,
     0.45833334, 0.4722222, 0.4861111, 0.5, 0.5138889, 0.5277778, 0.5416667,
     0.5555556, 0.5694444, 0.5833333, 0.5972222, 0.6111111, 0.625,
     0.6388889, 0.6527778, 0.6666667, 0.6805556, 0.6944444, 0.7083333,
     0.7222222, 0.7361111, 0.75, 0.7638889, 0.7777778, 0.7916667, 0.8055556,
     0.8194444, 0.8333333, 0.8472222, 0.8611111, 0.875, 0.8888889,
     0.9027778, 0.9166667, 0.9305556, 0.9444444, 0.9583333, 0.9722222,
     0.9861111, 1),
)


def _linspace(n: int) -> np.ndarray:
    """OpenCV's ``linspace(0, 1, n)``: x0 + i * step in float32."""
    step = np.float32(1) / np.float32(n - 1)
    return np.arange(n, dtype=np.float32) * step


def _interp1(x: np.ndarray, y: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """OpenCV's ``interp1_<float>``: the bracketing pair of its binary
    search (the last x below xi, the first two at or below x[0]), then
    y_lo + (xi - x_lo) * (y_hi - y_lo) / (x_hi - x_lo) in float32."""
    lo = np.clip(np.searchsorted(x, xi, side="left") - 1, 0, len(x) - 2)
    hi = lo + 1
    return y[lo] + (xi - x[lo]) * (y[hi] - y[lo]) / (x[hi] - x[lo])


def colormap_lut(colormap: str) -> np.ndarray:
    """(256, 3) u8 RGB: ``cv2.applyColorMap`` of 0..255 with
    COLORMAP_RAINBOW ("rainbow") or COLORMAP_BONE (any other name, as
    ``tensor2array`` takes it), channels in RGB order."""
    planes = _RAINBOW if colormap == "rainbow" else _BONE
    x, xi = _linspace(64), _linspace(256)
    lut = np.stack([_interp1(x, np.asarray(p, np.float32), xi)
                    for p in planes], -1)
    # convertTo(CV_8U, 255.): saturate_cast rounds half to even
    return np.clip(np.rint(lut * np.float32(255)), 0, 255).astype(np.uint8)


def tensor2array(array: np.ndarray, max_value: float = 255,
                 colormap: str = "rainbow") -> np.ndarray:
    """(H, W) / (H, W, 1) heatmap -> colormapped float RGB, or
    (H, W, 3) image -> float RGB (patch_attacks/utils.py:21-56).  The JAX
    package falls back to a grey map where cv2 is missing; the port
    gives what it gives with cv2, which needs none."""
    array = np.asarray(array)
    if max_value is None:
        # guard the auto-scale: an all-zero map would divide 0/0 -> NaN
        # (undefined uint8 cast), an all-negative one would invert sign
        max_value = float(array.max())
        if not np.isfinite(max_value) or max_value <= 0:
            max_value = 1.0
    if array.ndim == 2 or (array.ndim == 3 and array.shape[-1] == 1):
        u8 = (255 * np.squeeze(array) / max_value).clip(0, 255).astype(
            np.uint8)
        return colormap_lut(colormap)[u8].astype(np.float32) / 255
    if array.ndim == 3 and array.shape[-1] == 3:
        if array.min() >= 0 and array.max() <= 1:
            return array.astype(np.float32)
        return (0.5 + array * 0.5).astype(np.float32)
    return array.astype(np.float32)


def transpose_image(array: np.ndarray) -> np.ndarray:
    """HWC -> CHW for TensorBoard add_image (patch_attacks/utils.py:59-60)."""
    return np.transpose(array, (2, 0, 1))
