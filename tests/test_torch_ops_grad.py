"""The gradient of the PyTorch port's correlation lookup against the JAX
package, on the CPU.

The port's ``alt_corr_features`` is differentiated by autograd: its lookup
runs through ``_AltCorrLookup``, whose backward on a CPU tensor is the
plain version of the CUDA kernel ``csrc/alt_corr_bwd.cu``
(``alt_corr_lookup_backward_reference``); scaling and pooling keep their
autograd transposes.  The JAX side gives (i) the VJP of its
``alt_corr_features`` off the TPU, which its custom_vjp takes through the
volume formulation ``_alt_corr_reference`` (correlation.py:683-689), and
(ii) the Pallas backward kernel ``_alt_corr_bwd_kernel`` in interpret
mode, as tests/test_ops_correlation.py runs it.  The kernel itself is checked
against the plain backward on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu import ops as jops
from understanding_flow_robustness_tpu.ops.correlation import (
    _alt_corr_bwd_pallas,
    _alt_corr_reference,
)
from understanding_flow_robustness_tpu_torch import ops as tops

GRAD_ATOL = 2e-4  # the JAX package's bar (test_ops_correlation.py:579)
SHAPES = [(2, 16, 24, 16), (2, 13, 21, 16)]  # the second: ragged levels


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; with
    PyTorch's default of one thread per core in each, they mostly wait on
    one another (this file took 6x its time alone with six processes on
    eight cores).  Two threads each keep the cores busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, W, C, seed):
    """fmaps, coords with out-of-volume, edge and -3.5 centres
    (tests/test_ops_correlation.py:551-560) and an asymmetric random
    cotangent (a t-major reading of g passes a symmetric one)."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    coords = np.asarray(jops.coords_grid(H, W))[None] + rng.randn(
        B, H, W, 2).astype(np.float32) * 3
    coords[0, 0, 0] = [-50, -50]
    coords[0, 0, 1] = [500, 500]
    coords[0, 0, 2] = [-3.5, -3.5]
    coords[0, 0, 3] = [W - 0.25, H - 0.25]
    coords[-1, 2, 5] = [1e30, -1e30]
    g = rng.randn(B, H, W, 324).astype(np.float32)
    return f1, f2, coords.astype(np.float32), g


def _port_grads(f1, f2, coords, g, compute_dtype=None, radius=4):
    a = torch.from_numpy(f1).requires_grad_()
    b = torch.from_numpy(f2).requires_grad_()
    out = tops.alt_corr_features(a, b, torch.from_numpy(coords), 4, radius,
                                 compute_dtype=compute_dtype)
    out.backward(torch.from_numpy(g))
    return a.grad, b.grad


@pytest.mark.parametrize("shape", SHAPES)
def test_lookup_grad_matches_jax_vjp_and_pallas_backward(shape):
    f1, f2, coords, g = _inputs(*shape, seed=0)
    da, db = _port_grads(f1, f2, coords, g)
    assert da.dtype == db.dtype == torch.float32

    j1, j2, jc, jg = map(jnp.asarray, (f1, f2, coords, g))
    _, vjp = jax.vjp(lambda a, b: _alt_corr_reference(a, b, jc, 4, 4), j1, j2)
    ref_a, ref_b = vjp(jg)
    pal_a, pal_b, _ = _alt_corr_bwd_pallas(j1, j2, jc, jg, 4, 4, None, False,
                                           interpret=True, coords_grad=False)
    for got, ref, pal in ((da, ref_a, pal_a), (db, ref_b, pal_b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=GRAD_ATOL)

    # the comparison sees the window order: g read t-major fails it
    gt = g.reshape(*g.shape[:3], 4, 9, 9).swapaxes(-1, -2).reshape(g.shape)
    _, db_t = _port_grads(f1, f2, coords, gt)
    assert np.abs(db_t.numpy() - np.asarray(ref_b)).max() > 100 * GRAD_ATOL


@pytest.mark.parametrize("radius", [1, 2, 3, 5, 7])
def test_lookup_grad_any_radius_matches_jax_vjp(radius):
    """The backward at radius r (small RAFT's 3 among them; the kernels
    take 1..7) against jax.vjp of the JAX package's lookup, with an
    asymmetric cotangent of L * (2r+1)^2 channels, on ragged levels."""
    f1, f2, coords, _ = _inputs(2, 13, 21, 16, seed=30 + radius)
    n2 = (2 * radius + 1) ** 2
    g = np.random.RandomState(radius).randn(2, 13, 21, 4 * n2).astype(
        np.float32)
    da, db = _port_grads(f1, f2, coords, g, radius=radius)
    j1, j2, jc, jg = map(jnp.asarray, (f1, f2, coords, g))
    _, vjp = jax.vjp(lambda a, b: _alt_corr_reference(a, b, jc, 4, radius),
                     j1, j2)
    for got, ref in zip((da, db), vjp(jg)):
        assert np.abs(np.asarray(ref)).max() > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=GRAD_ATOL)


def test_ragged_pooling_transpose_reaches_only_pooled_rows():
    """13x21 pools to 6x10, 3x5, 1x2: the dropped last row and column of a
    level take only that level's own gradient.  With a cotangent on level
    3 alone, fmap2's gradient is zero outside the 8x16 block that level 3
    pools, and every pixel of that block gets the same share."""
    f1, f2, coords, _ = _inputs(1, 13, 21, 16, seed=1)
    coords[:] = [0.3, 0.4]  # level 3 sees (0.0375, 0.05): its whole 1x2 level
    g = np.zeros((1, 13, 21, 324), np.float32)
    g[..., 3 * 81:] = 1.0
    _, db = _port_grads(f1, f2, coords, g)
    db = db.numpy()[0]
    assert np.abs(db[8:]).max() == 0 and np.abs(db[:, 16:]).max() == 0
    block = db[:8, :16]
    assert np.abs(block).max() > 0
    np.testing.assert_allclose(block, np.broadcast_to(block[:1, :1],
                                                      block.shape), rtol=1e-6)


def test_bf16_gradients_stay_f32():
    """compute_dtype=bf16: the kernels read bf16 copies, the gradients that
    reach the f32 fmaps are f32 sums of those bf16 values, not rounded to
    bf16 -- equal to the plain backward on the same bf16 values, chained
    through scaling and pooling by autograd."""
    f1, f2, coords, g = _inputs(2, 16, 24, 16, seed=2)
    da, db = _port_grads(f1, f2, coords, g, compute_dtype=torch.bfloat16)

    a = torch.from_numpy(f1).requires_grad_()
    b = torch.from_numpy(f2).requires_grad_()
    pf1, plv = tops.prepare_alt_corr(a, b, 4)
    kf1, klv = tops.alt_corr_kernel_inputs(pf1, plv, torch.bfloat16)
    df1, dlv = tops.alt_corr_lookup_backward_reference(
        kf1, klv, torch.from_numpy(coords).reshape(2, -1, 2),
        torch.from_numpy(g).reshape(2, -1, 324))
    ra, rb = torch.autograd.grad([pf1, *plv], [a, b], [df1, *dlv])
    np.testing.assert_allclose(da.numpy(), ra.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(db.numpy(), rb.numpy(), rtol=1e-6, atol=1e-7)
    assert bool((da.bfloat16().float() != da).any())


def test_plain_lookup_gradcheck_f64():
    torch.manual_seed(0)
    B, H, W, C = 1, 5, 4, 3
    a = torch.randn(B, H, W, C, dtype=torch.float64, requires_grad=True)
    b = torch.randn(B, H, W, C, dtype=torch.float64, requires_grad=True)
    coords = (tops.coords_grid(H, W, dtype=torch.float64)[None]
              + 0.7 * torch.randn(B, H, W, 2, dtype=torch.float64))
    assert torch.autograd.gradcheck(
        lambda x, y: tops.alt_corr_features(x, y, coords, 2, 4), (a, b),
        fast_mode=True)


def test_coordinate_gradient_raises_and_no_grad_path_skips_the_function():
    """Coords that require grad get their gradient (B3's plain version on
    the CPU; tests/test_torch_coords_grad.py holds it against JAX) and
    nothing else is computed for them; without autograd the Function is
    skipped."""
    f1, f2, coords, _ = _inputs(1, 8, 8, 16, seed=3)
    a = torch.from_numpy(f1).requires_grad_()
    b = torch.from_numpy(f2)
    c = torch.from_numpy(coords)
    cg = c.clone().requires_grad_()
    tops.alt_corr_features(a.detach(), b, cg).square().sum().backward()
    assert cg.grad.dtype == torch.float32 and cg.grad.shape == c.shape
    assert bool(torch.isfinite(cg.grad).all()) and cg.grad.abs().max() > 0
    assert cg.grad[0, 0, 0].abs().max() == 0  # the window wholly outside
    before = dict(tops.LAUNCH_COUNTS)
    out = tops.alt_corr_features(a, b, c)
    assert type(out.grad_fn).__name__ == "ViewBackward0"
    with torch.no_grad():
        assert tops.alt_corr_features(a, b, c).grad_fn is None
    # the Function keeps the coords and the kernels' inputs, never its output
    node = out.grad_fn.next_functions[0][0]
    assert type(node).__name__ == "_AltCorrLookupBackward"
    assert [tuple(t.shape) for t in node.saved_tensors] == [
        (1, 64, 2), (1, 64, 16), (1, 8, 8, 16), (1, 4, 4, 16), (1, 2, 2, 16),
        (1, 1, 1, 16)]
    assert dict(tops.LAUNCH_COUNTS) == before  # no kernel on the CPU
