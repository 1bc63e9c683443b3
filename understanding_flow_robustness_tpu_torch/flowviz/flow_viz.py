"""Log-scale flow visualization (counterpart of
``understanding_flow_robustness_tpu/flowviz/flow_viz.py``; reference:
flowutils/flow_viz.py:14-103).

A second flow-coloring convention used by parts of the reference alongside
flowlib's Middlebury renderer: a unit-valued (0..1) color wheel with a
LOG-scaled radius (``log(r+1)/scaledown``), saturation increasing with
radius inside the unit disk and a 0.75 dimming outside it.

Host-side numpy; the batch variant takes/returns NHWC float arrays (the
reference's torch/CHW wrapper exists only to feed tensorboard).
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """Unit-valued color wheel (flow_viz.py:61-103).  Differs from
    flowlib.make_color_wheel in scale (0..1 vs 0..255) and in using
    un-floored linear ramps."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 1
    wheel[0:ry, 1] = np.arange(0, 1, 1.0 / ry)
    col += ry
    wheel[col : col + yg, 0] = np.arange(1, 0, -1.0 / yg)
    wheel[col : col + yg, 1] = 1
    col += yg
    wheel[col : col + gc, 1] = 1
    wheel[col : col + gc, 2] = np.arange(0, 1, 1.0 / gc)
    col += gc
    wheel[col : col + cb, 1] = np.arange(1, 0, -1.0 / cb)
    wheel[col : col + cb, 2] = 1
    col += cb
    wheel[col : col + bm, 2] = 1
    wheel[col : col + bm, 0] = np.arange(0, 1, 1.0 / bm)
    col += bm
    wheel[col : col + mr, 2] = np.arange(1, 0, -1.0 / mr)
    wheel[col : col + mr, 0] = 1
    return wheel


_WHEEL = make_colorwheel()


def compute_flow_image(u: np.ndarray, v: np.ndarray, logscale: bool = True,
                       scaledown: float = 6) -> np.ndarray:
    """flow_viz.py:14-58: (H, W) u/v -> (H, W, 3) uint8.

    Radius is log-scaled (``log(r+1)``) then divided by ``scaledown``;
    angle indexes the unit color wheel with the reference's uint8 bin cast.
    """
    ncols = _WHEEL.shape[0]
    radius = np.sqrt(u ** 2 + v ** 2)
    if logscale:
        radius = np.log(radius + 1)
    radius = radius / scaledown
    rot = np.arctan2(-v, -u) / np.pi

    fk = (rot + 1) / 2 * (ncols - 1)
    k0 = fk.astype(np.uint8)  # the reference's (quirky) uint8 bin cast
    k1 = k0 + 1
    k1 = np.where(k1 == ncols, 0, k1)
    f = fk - k0

    img = np.zeros(u.shape + (3,))
    inside = radius <= 1
    for i in range(3):
        col0 = _WHEEL[:, i][k0]
        col1 = _WHEEL[:, i][k1]
        col = (1 - f) * col0 + f * col1
        col = np.where(inside, 1 - radius * (1 - col), col * 0.75)
        img[:, :, i] = np.floor(255 * col)
    return img.astype(np.uint8)


def batch_compute_flow_image(uv: np.ndarray, logscale: bool = True,
                             scaledown: float = 6) -> np.ndarray:
    """(B, H, W, 2) -> (B, H, W, 3) float in [0, 1]
    (flow_viz.py:6-11's batch wrapper, NHWC)."""
    out = np.zeros(uv.shape[:3] + (3,), np.float32)
    for i in range(uv.shape[0]):
        out[i] = (
            compute_flow_image(uv[i, :, :, 0], uv[i, :, :, 1],
                               logscale=logscale, scaledown=scaledown)
            / 255.0
        )
    return out
