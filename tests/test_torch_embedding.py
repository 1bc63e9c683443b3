"""The port's embedding analyses (``utils/embedding.py``: the
multi-bandwidth Gaussian MMD and the exact t-SNE of the patch-embedding
CLI) against the JAX package's on seeded inputs.  Both are float64 numpy on
the host, so they agree to 1e-12."""

import numpy as np
import pytest

from understanding_flow_robustness_tpu.utils import embedding as jemb
from understanding_flow_robustness_tpu_torch.utils import embedding as temb
from understanding_flow_robustness_tpu_torch.utils import gaussian_mmd, tsne

TOL = 1e-12


def _points(seed, n, d, shift=0.0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) + shift).astype(dtype)


@pytest.mark.parametrize("n,m,d,shift,kw", [
    (8, 8, 4, 0.0, {}),
    (20, 12, 64, 3.0, {}),
    (5, 9, 256, 0.5, {"kernel_mul": 3.0, "kernel_num": 3}),
    (16, 16, 1, 1.0, {"kernel_num": 1}),
])
def test_gaussian_mmd_matches_jax(n, m, d, shift, kw):
    x = _points(0, n, d)
    y = _points(1, m, d, shift)
    got, ref = gaussian_mmd(x, y, **kw), jemb.gaussian_mmd(x, y, **kw)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    # a shifted sample is told apart from its own distribution
    if shift >= 3.0:
        assert got > 5 * max(gaussian_mmd(x, _points(2, m, d)), 1e-6)


def test_pairwise_sq_dists_match_jax():
    a = _points(3, 30, 17, dtype=np.float64)
    np.testing.assert_allclose(temb._pairwise_sq_dists(a),
                               jemb._pairwise_sq_dists(a), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("n,d,kw", [
    (16, 8, {"n_iter": 300, "seed": 42}),
    (30, 6, {"n_iter": 120, "perplexity": 5.0, "seed": 0}),
    (2, 3, {"n_iter": 20, "seed": 1}),
])
def test_tsne_matches_jax(n, d, kw):
    x = np.concatenate([_points(4, n // 2, d), _points(5, n - n // 2, d, 5)])
    got, ref = tsne(x, **kw), jemb.tsne(x, **kw)
    assert got.shape == (n, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_tsne_refuses_a_single_point():
    for fn in (tsne, jemb.tsne):
        with pytest.raises(ValueError, match="at least 2 points"):
            fn(np.zeros((1, 4)))
