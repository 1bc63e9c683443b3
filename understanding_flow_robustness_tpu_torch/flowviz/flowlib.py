"""Flow -> RGB rendering and the flow analysis helpers (reference:
flowutils/flowlib.py), copied from the JAX package's ``flowviz/flowlib.py``:
the Middlebury color wheel (flowlib.py:513-567), ``compute_color``
(:469-510) and ``flow_to_image`` (:269-307), with which the attack logs
render their flow PNGs; ``flow_error`` / ``evaluate_flow`` (mean EPE over
known, nonzero-GT pixels), ``interp_gt_flow`` (sparse GT densified by
scipy's ``griddata``), ``segment_flow`` (direction octants),
``disp_to_flowfile`` and ``scale_image``, with the float32 round trips the
JAX package keeps.  Host-side numpy and scipy.
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


def flow_error(tu, tv, u, v) -> float:
    """Mean EPE over known, nonzero-GT pixels (flowlib.py:192-245)."""
    tu = np.array(tu, copy=True)
    tv = np.array(tv, copy=True)
    u = np.array(u, copy=True)
    v = np.array(v, copy=True)
    unknown = (np.abs(tu) > UNKNOWN_FLOW_THRESH) | (np.abs(tv) > UNKNOWN_FLOW_THRESH)
    for a in (tu, tv, u, v):
        a[unknown] = 0
    keep = (np.abs(tu) > 0) | (np.abs(tv) > 0)
    epe = np.sqrt((tu - u) ** 2 + (tv - v) ** 2)
    return float(np.mean(epe[keep]))


def evaluate_flow(gt_flow: np.ndarray, pred_flow: np.ndarray) -> float:
    """flowlib.py:326-341."""
    return flow_error(
        gt_flow[:, :, 0], gt_flow[:, :, 1],
        pred_flow[:, :, 0], pred_flow[:, :, 1],
    )


def interp_gt_flow(mat: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """Sparse-GT densification via griddata (flowlib.py:247-266)."""
    from scipy import interpolate

    mat = np.array(mat, dtype=np.float64, copy=True)
    if mask is not None:
        mat[mask == 0] = np.nan
    x = np.arange(mat.shape[1])
    y = np.arange(mat.shape[0])
    xx, yy = np.meshgrid(x, y)
    valid = ~np.isnan(mat[:, :, 0])
    pts = (xx[valid], yy[valid])
    vals = mat[valid].reshape(-1, 2)
    return interpolate.griddata(pts, vals, (xx, yy), method="linear",
                                fill_value=1e8)


SMALLFLOW = 0.0
LARGEFLOW = 1e8


def segment_flow(flow: np.ndarray) -> np.ndarray:
    """Octant segmentation of a flow field (flowlib.py:155-189): label each
    pixel 0-8 by the direction octant of (u, v); 0 = zero flow.  Mutates a
    copy (the reference mutates its input's u channel in place)."""
    u = np.array(flow[:, :, 0], dtype=np.float64, copy=True)
    v = np.array(flow[:, :, 1], dtype=np.float64, copy=True)

    large = (np.abs(u) > LARGEFLOW) | (np.abs(v) > LARGEFLOW)
    zero = (v == 0) & (u == 0)
    u[np.abs(u) == SMALLFLOW] = 0.00001
    tan_value = v / u

    seg = np.zeros(u.shape)
    seg[(tan_value < 1) & (tan_value >= 0) & (u > 0) & (v >= 0)] = 1
    seg[(tan_value >= 1) & (u >= 0) & (v >= 0)] = 2
    seg[(tan_value < -1) & (u <= 0) & (v >= 0)] = 3
    seg[(tan_value < 0) & (tan_value >= -1) & (u < 0) & (v >= 0)] = 4
    seg[(tan_value >= 0) & (tan_value < 1) & (u < 0) & (v <= 0)] = 5
    seg[(tan_value >= 1) & (u <= 0) & (v <= 0)] = 6
    seg[(tan_value < -1) & (u >= 0) & (v <= 0)] = 7
    seg[(tan_value >= -1) & (tan_value < 0) & (u > 0) & (v <= 0)] = 8
    seg[zero] = 0
    seg[large] = 0
    return seg


def disp_to_flowfile(disp: np.ndarray, filename: str) -> None:
    """Write a disparity map as a .flo file with v == 0
    (flowlib.py:362-379)."""
    with open(filename, "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        h, w = disp.shape[:2]
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        np.dstack([disp, np.zeros((h, w), np.float32)]).astype(
            np.float32
        ).tofile(f)


def scale_image(image: np.ndarray, new_range) -> np.ndarray:
    """Linear rescale into [min(new_range), max(new_range)] as uint8
    (flowlib.py:452-466)."""
    # min/max round through float32 like the reference (flowlib.py:459-460)
    lo = np.min(image).astype(np.float32)
    hi = np.max(image).astype(np.float32)
    lo_n = np.array(min(new_range), np.float32)
    hi_n = np.array(max(new_range), np.float32)
    return ((image - lo) / (hi - lo) * (hi_n - lo_n) + lo_n).astype(np.uint8)
