"""Flow -> RGB rendering (reference: flowutils/flowlib.py), copied from the
JAX package's ``flowviz/flowlib.py``: the Middlebury color wheel
(flowlib.py:513-567), ``compute_color`` (:469-510) and ``flow_to_image``
(:269-307).  Host-side numpy; the attack logs render their flow PNGs with
it.
"""

from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7


def make_color_wheel() -> np.ndarray:
    """Middlebury color wheel, 55 x 3 (flowlib.py:513-567)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros([ncols, 3])
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(0, ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(0, yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(0, gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(0, cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(0, bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(0, mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


_COLORWHEEL = make_color_wheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Angle/magnitude -> Middlebury RGB (flowlib.py:469-510)."""
    h, w = u.shape
    img = np.zeros([h, w, 3])
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)

    ncols = _COLORWHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0

    for i in range(_COLORWHEEL.shape[1]):
        tmp = _COLORWHEEL[:, i]
        col0 = tmp[k0 - 1] / 255
        col1 = tmp[k1 - 1] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.uint8(np.floor(255 * col * (1 - nan_idx)))
    return img


def flow_to_image(flow: np.ndarray, maxr: float = -1) -> np.ndarray:
    """Flow (H, W, 2) -> uint8 RGB, optionally with a fixed normalization
    radius for comparable frames (flowlib.py:269-307)."""
    u = np.array(flow[:, :, 0], copy=True)
    v = np.array(flow[:, :, 1], copy=True)

    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0

    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(maxr, float(np.max(rad)) if rad.size else 0.0)

    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    img = compute_color(u, v)
    img[np.repeat(unknown[:, :, None], 3, axis=2)] = 0
    return np.uint8(img)
