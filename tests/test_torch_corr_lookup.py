"""The PyTorch port's volume lookup (``corr_lookup``, kernel B5's plain
version on the CPU) and its pyramid against the JAX package, on the CPU.

Inputs come from a numpy seed.  The JAX side gives its fused Pallas lookup
``corr_lookup_pallas`` in interpret mode (as tests/test_ops_correlation.py
runs it), its ``corr_lookup`` with ``impl="gather"`` and ``impl="mxu"``,
and the VJP of ``_corr_lookup_mxu``, which its custom_vjp uses as the
Pallas lookup's gradient.  The CUDA kernel ``csrc/corr_lookup_fwd.cu`` is
held against the same plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu import ops as jops
from understanding_flow_robustness_tpu.ops.correlation import _corr_lookup_mxu
from understanding_flow_robustness_tpu.ops.pallas.corr_lookup_fused import (
    corr_lookup_pallas,
)
from understanding_flow_robustness_tpu_torch import ops as tops

F32_ATOL = 1e-4       # the JAX package's bar (tests/test_ops_correlation.py:267-268)
GRAD_ATOL = 2e-4      # the JAX package's gradient bar (tests/test_ops_correlation.py:579)
# |port - JAX| / (|JAX| + 1) for the bf16 lookup, the JAX package's own
# on-TPU bar (tests/test_ops_correlation.py:288-291): JAX rounds the
# bilinear weights and the row blends to bf16, the port blends the same
# bf16 taps in f32
BF16_REL = 2e-2
SHAPES = [(2, 16, 24, 16), (2, 13, 21, 16)]  # the second pools to ragged levels


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another (as in the other
    test_torch_*.py files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the JAX references, jitted: one compile each instead of one per op
@jax.jit
def _jax_volume(f1, f2):
    return jops.all_pairs_correlation(f1, f2)


_jax_pyramid_of = jax.jit(lambda corr: jops.corr_pyramid(corr, 4))
_jax_pallas = jax.jit(lambda p, c: corr_lookup_pallas(p, c, 4, interpret=True))
_jax_gather = jax.jit(lambda p, c: jops.corr_lookup(p, c, 4, impl="gather"))
_jax_mxu_bf16 = jax.jit(lambda p, c: jops.corr_lookup(
    p, c, 4, impl="mxu", compute_dtype=jnp.bfloat16))


@jax.jit
def _jax_mxu_vjp(p, c, g):
    return jax.vjp(lambda p, c: _corr_lookup_mxu(list(p), c, 4), p, c)[1](g)


def _inputs(B, H, W, C, seed):
    """fmaps and coords with out-of-volume, +-1e30, edge and -3.5 centres."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    coords = np.asarray(jops.coords_grid(H, W))[None] + rng.randn(
        B, H, W, 2).astype(np.float32) * 3
    coords[0, 0, :7] = [[-50, -50], [500, 500], [1e30, 3.0], [3.0, -1e30],
                        [-1e30, 1e30], [-3.5, -3.5], [W - 0.25, H - 0.25]]
    coords[-1, 1, 0] = [W - 1.0, H - 1.0]
    return f1, f2, coords.astype(np.float32)


def _t(x, dtype=None):
    """A JAX or numpy array as a torch tensor (bf16 goes through f32,
    exactly)."""
    t = torch.from_numpy(np.array(x, np.float32))
    return t if dtype is None else t.to(dtype)


def _jax_pyramid(f1, f2, dtype=None):
    corr = _jax_volume(f1, f2)
    if dtype is not None:
        corr = corr.astype(dtype)
    return _jax_pyramid_of(corr)


@pytest.mark.parametrize("shape", SHAPES)
def test_corr_lookup_f32_matches_jax_pallas_and_gather(shape):
    """The port's lookup (CPU path: the kernel's plain version) against the
    JAX Pallas kernel in interpret mode and the gather lookup, on the same
    f32 pyramid, element by element: channel l*81 + s*9 + t must be the
    sample at (x/2^l - 4 + s, y/2^l - 4 + t)."""
    f1, f2, coords = _inputs(*shape, seed=0)
    pyr = _jax_pyramid(f1, f2)
    ref_kernel = np.asarray(_jax_pallas(pyr, coords))
    ref_gather = np.asarray(_jax_gather(pyr, coords))
    before = dict(tops.LAUNCH_COUNTS)
    got = tops.corr_lookup([_t(p) for p in pyr], _t(coords), 4)
    assert dict(tops.LAUNCH_COUNTS) == before  # no kernel on the CPU
    assert got.dtype == torch.float32 and tuple(got.shape) == (*shape[:3], 324)
    got = got.numpy()
    np.testing.assert_allclose(got, ref_kernel, atol=F32_ATOL)
    np.testing.assert_allclose(got, ref_gather, atol=F32_ATOL)
    assert np.abs(got[0, 0, :5]).max() == 0  # windows wholly outside
    # the comparison sees the window order: a t-major output fails it
    B, H, W, _ = shape
    t_major = got.reshape(B, H, W, 4, 9, 9).swapaxes(-1, -2).reshape(got.shape)
    assert np.abs(t_major - ref_gather).max() > 100 * F32_ATOL


@pytest.mark.parametrize("shape", SHAPES)
def test_corr_lookup_bf16_matches_jax_mxu(shape):
    """A bf16 pyramid: the port's lookup against JAX's
    ``impl="mxu", compute_dtype=bf16`` on the same bf16 values, at the
    stated relative bar; and against the f32 blend of those values, which
    it is exactly."""
    f1, f2, coords = _inputs(*shape, seed=1)
    pyr = _jax_pyramid(f1, f2, jnp.bfloat16)
    ref = np.asarray(_jax_mxu_bf16(pyr, coords), np.float32)
    tp = [_t(p, torch.bfloat16) for p in pyr]
    got = tops.corr_lookup(tp, _t(coords), 4)
    assert got.dtype == torch.float32
    assert (np.abs(got.numpy() - ref) / (np.abs(ref) + 1)).max() < BF16_REL
    exact = tops.corr_lookup([p.float() for p in tp], _t(coords), 4)
    torch.testing.assert_close(got, exact, rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_volume_pyramid_bf16_matches_jax(shape):
    """The mixed-precision pyramid (raft_model.py:867-874): f32 volume,
    cast once to bf16, pooled in bf16.  Pooled from the same bf16 volume,
    the port's levels equal JAX's bit for bit.  From the fmaps, the two f32
    volumes differ in the last bits (other summation orders), so a few
    values round to the neighbouring bf16: within one bf16 ulp, at most
    0.1 % of the values."""
    f1, f2, _ = _inputs(*shape, seed=2)
    jpyr = _jax_pyramid(f1, f2, jnp.bfloat16)
    same = tops.corr_pyramid(_t(jpyr[0], torch.bfloat16), 4)
    port = tops.volume_pyramid(_t(f1), _t(f2), 4, torch.bfloat16)
    for a, b, j in zip(same, port, jpyr):
        ref = _t(j)
        assert a.dtype == b.dtype == torch.bfloat16
        assert tuple(b.shape) == j.shape and b.is_contiguous()
        torch.testing.assert_close(a.float(), ref, rtol=0, atol=0)
        diff = (b.float() - ref).abs()
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool((diff <= ulp).all())
        assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("shape", SHAPES)
def test_corr_lookup_grad_matches_jax_vjp(shape):
    """The autograd Function's gradient with respect to the pyramid and the
    coords against ``jax.vjp`` of ``_corr_lookup_mxu`` in f32, with an
    asymmetric random cotangent (a t-major reading of it fails)."""
    f1, f2, coords = _inputs(*shape, seed=3)
    pyr = _jax_pyramid(f1, f2)
    g = np.random.RandomState(4).randn(*shape[:3], 324).astype(np.float32)
    ref_p, ref_c = _jax_mxu_vjp(tuple(pyr), coords, g)

    def port_grads(cot):
        tp = [_t(p).requires_grad_() for p in pyr]
        tc = _t(coords).requires_grad_()
        out = tops.corr_lookup(tp, tc, 4)
        assert type(out.grad_fn).__name__ == "_CorrLookupBackward"
        out.backward(torch.from_numpy(cot))
        return [p.grad.numpy() for p in tp], tc.grad.numpy()

    dp, dc = port_grads(g)
    for got, ref in zip(dp, ref_p):
        np.testing.assert_allclose(got, np.asarray(ref), atol=GRAD_ATOL)
    # coordinate gradients sum 324 window terms of up to ~|g| * |corr|
    np.testing.assert_allclose(dc, np.asarray(ref_c),
                               atol=GRAD_ATOL * np.abs(np.asarray(ref_c)).max())
    assert np.abs(dc[0, 0, :5]).max() == 0  # windows wholly outside
    gt = g.reshape(*shape[:3], 4, 9, 9).swapaxes(-1, -2).reshape(g.shape)
    dp_t, _ = port_grads(gt)
    assert np.abs(dp_t[0] - np.asarray(ref_p[0])).max() > 100 * GRAD_ATOL


def test_corr_lookup_dispatch_and_checks():
    """CPU tensors take the plain version; the kernel wrapper refuses them
    (it launches on CUDA tensors or raises) and any other device raises;
    without autograd the lookup skips the Function."""
    f1, f2, coords = _inputs(1, 8, 8, 16, seed=5)
    pyr = [_t(p) for p in _jax_pyramid(f1, f2)]
    c = _t(coords)
    out = tops.corr_lookup(pyr, c)
    assert out.grad_fn is None
    torch.testing.assert_close(out, tops.corr_lookup_reference(pyr, c),
                               rtol=0, atol=0)
    levels = [p.reshape(64, *p.shape[2:]) for p in pyr]
    with pytest.raises(ValueError, match="CUDA"):
        tops.corr_lookup_fwd(levels, c.reshape(64, 2))
    with pytest.raises(ValueError, match="radius"):
        tops.corr_lookup_fwd(levels, c.reshape(64, 2), radius=3)
    with pytest.raises(TypeError):
        tops.corr_lookup_fwd([lv.double() for lv in levels], c.reshape(64, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        tops.corr_lookup([p.to("meta") for p in pyr], c.to("meta"))
