"""Embedding analysis utilities: Gaussian-kernel MMD and exact t-SNE (the
port's own copy of ``understanding_flow_robustness_tpu/utils/embedding.py``,
which is numpy only; float64 host analyses of a few hundred points).

Reference: patch_attacks/test_patch_embeddings.py — maximum mean
discrepancy with a multi-bandwidth Gaussian kernel (:130-163) and 2-D
t-SNE scatter of per-layer feature embeddings (:417-441; the reference
uses sklearn's TSNE, which this environment lacks, so a compact exact
t-SNE with perplexity calibration is implemented here).
"""

from __future__ import annotations

import numpy as np


def _pairwise_sq_dists(a: np.ndarray) -> np.ndarray:
    """(m, m) squared euclidean distances via the gram expansion — the
    (m, m, D) broadcast intermediate costs m*m*D*8 bytes (~330 MB at 200
    samples x 1024 channels); this is O(m^2) memory."""
    n2 = (a * a).sum(-1)
    d2 = n2[:, None] + n2[None, :] - 2.0 * (a @ a.T)
    np.maximum(d2, 0.0, out=d2)   # clamp the roundoff negatives
    return d2


def gaussian_mmd(x: np.ndarray, y: np.ndarray,
                 kernel_mul: float = 2.0, kernel_num: int = 5) -> float:
    """Multi-bandwidth Gaussian-kernel MMD (test_patch_embeddings.py:130-163
    semantics): bandwidths are a geometric family around the mean pairwise
    distance of the joint sample."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    y = np.asarray(y, np.float64).reshape(len(y), -1)
    n = len(x)
    total = np.concatenate([x, y], axis=0)
    d2 = _pairwise_sq_dists(total)
    m = total.shape[0]
    bandwidth = d2.sum() / (m * m - m + 1e-12)
    bandwidth /= kernel_mul ** (kernel_num // 2)
    kernels = sum(
        np.exp(-d2 / (bandwidth * (kernel_mul ** i) + 1e-12))
        for i in range(kernel_num)
    )
    xx = kernels[:n, :n]
    yy = kernels[n:, n:]
    xy = kernels[:n, n:]
    return float(xx.mean() + yy.mean() - 2 * xy.mean())


def tsne(x: np.ndarray, n_components: int = 2, perplexity: float = 30.0,
         n_iter: int = 500, learning_rate: float = 200.0,
         seed: int = 0) -> np.ndarray:
    """Exact t-SNE (Van der Maaten & Hinton 2008): binary-search perplexity
    calibration, early exaggeration, momentum gradient descent.  Suitable
    for the few-hundred-point embedding scatters the analysis produces."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    n = x.shape[0]
    if n < 2:
        raise ValueError(
            f"t-SNE needs at least 2 points, got {n} (a single point has "
            "no pairwise structure; the result would be silent NaNs)")
    perplexity = min(perplexity, (n - 1) / 3.0)

    d2 = _pairwise_sq_dists(x)
    target_entropy = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        lo, hi = 1e-20, 1e20
        beta = 1.0
        di = np.delete(d2[i], i)
        for _ in range(50):
            p = np.exp(-di * beta)
            s = p.sum() + 1e-12
            p /= s
            h = -(p * np.log(p + 1e-12)).sum()
            if abs(h - target_entropy) < 1e-5:
                break
            if h > target_entropy:
                lo = beta
                beta = beta * 2 if hi == 1e20 else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == 1e-20 else (beta + lo) / 2
        row = np.insert(p, i, 0.0)
        P[i] = row
    P = (P + P.T) / (2 * n)
    P = np.maximum(P, 1e-12)

    rng = np.random.RandomState(seed)
    y = rng.randn(n, n_components) * 1e-4
    dy = np.zeros_like(y)
    for it in range(n_iter):
        exagg = 12.0 if it < 100 else 1.0
        momentum = 0.5 if it < 250 else 0.8
        q_num = 1.0 / (1.0 + ((y[:, None] - y[None, :]) ** 2).sum(-1))
        np.fill_diagonal(q_num, 0.0)
        Q = np.maximum(q_num / q_num.sum(), 1e-12)
        PQ = (exagg * P - Q) * q_num
        grad = 4.0 * ((np.diag(PQ.sum(1)) - PQ) @ y)
        dy = momentum * dy - learning_rate * grad
        y = y + dy
        y = y - y.mean(0)
    return y
