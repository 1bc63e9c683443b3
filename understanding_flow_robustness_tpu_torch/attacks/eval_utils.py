"""Numpy eval metrics (reference: global_attacks/eval_utils.py:20-105), a
copy of the JAX package's ``attacks/eval_utils.py``."""

from __future__ import annotations

import numpy as np


def root_mean_sq_err(src, tgt) -> float:
    return float(np.sqrt(np.mean((src - tgt) ** 2)))


def mean_abs_err(src, tgt) -> float:
    return float(np.mean(np.abs(src - tgt)))


def mean_abs_rel_err(src, tgt) -> float:
    return float(np.mean(np.abs(src - tgt) / tgt))


def d1_error(src, tgt) -> float:
    """KITTI-2015 D1: error > 3px AND > 5% of |gt|, over gt > 0 pixels."""
    E = np.abs(src - tgt)
    n_err = np.count_nonzero(
        np.logical_and(tgt > 0, np.logical_and(E > 3, E / np.abs(tgt) > 0.05))
    )
    n_total = np.count_nonzero(tgt > 0)
    return n_err / max(n_total, 1)


def lp_norm(T, p: float = 1.0, axis=None) -> float:
    """L0 (max-abs), mean-abs (p!=0, axis None) or per-axis Lp mean."""
    if p != 0 and axis is None:
        return float(np.mean(np.abs(T)))
    if p != 0:
        return float(np.mean(np.sum(np.abs(T) ** p, axis=axis) ** (1.0 / p)))
    return float(np.max(np.abs(T)))
