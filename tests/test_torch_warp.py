"""The PyTorch port's warp, sampling, resizing and spatial correlation
against the JAX package, on the CPU.

Inputs come from a numpy seed and go to both packages.  On a CPU tensor the
port's ``warp_backward`` runs ``warp_backward_reference``, the plain version
of the CUDA kernel ``csrc/warp_fwd.cu`` (the kernel itself is checked on the
card by tests/test_torch_cuda.py and chip_smoke.py).  The JAX
``warp_backward`` runs eagerly here, op by op: under ``jit`` XLA folds
2/(W-1) into one constant and fuses the normalisation into an FMA, which
moves sample coordinates by an ulp (up to 3e-5 px at 300 px), while op by
op both packages compute the same f32 operations and the coordinates are
bit-equal.  The Pallas kernel ``warp_tile.py::_warp_kernel`` is held
against the port's sampler in interpret mode, on flows where it reports
no violation (tests/test_warp_tile.py:34-50).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu.ops import interp as jinterp
from understanding_flow_robustness_tpu.ops.correlation import (
    spatial_correlation as j_spatial_correlation,
)
from understanding_flow_robustness_tpu.ops.pallas.warp_tile import (
    warp_tiled_sample,
)
from understanding_flow_robustness_tpu_torch import ops as tops
from understanding_flow_robustness_tpu_torch.ops import interp as tinterp

WARP_ATOL = 1e-5      # f32, same coordinates on both sides
CORR_REL_TOL = 1e-5   # x max|corr|: f32 sums in other orders
GRAD_ATOL = 1e-5      # f32 gradients of the same gather formulation
MODES = ["border", "zeros_mask", "spynet"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flow(kind, b, h, w, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "smooth":
        f = rng.randn(b, h, w, 2) * 2.0 + 1.5
    elif kind == "wild":
        f = rng.randn(b, h, w, 2) * 150.0
    else:  # far-out: +-1e30 on a third of the entries, in both axes
        f = rng.randn(b, h, w, 2) * 3.0
        far = rng.rand(b, h, w, 2) < 0.3
        f[far] = np.sign(rng.randn(int(far.sum()))) * 1e30
    return f.astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _jax_warp(img, flow, mode):
    with jax.disable_jit():
        return np.asarray(jinterp.warp_backward(jnp.asarray(img),
                                                jnp.asarray(flow), mode=mode))


@pytest.mark.parametrize("shape", [(2, 13, 21, 3), (1, 24, 40, 8)])
@pytest.mark.parametrize("kind", ["smooth", "wild", "far"])
@pytest.mark.parametrize("mode", MODES)
def test_warp_matches_jax(mode, kind, shape):
    b, h, w, c = shape
    img = np.random.RandomState(1).rand(b, h, w, c).astype(np.float32)
    flow = _flow(kind, b, h, w)
    ref = _jax_warp(img, flow, mode)
    got = tops.warp_backward(_nchw(img), _nchw(flow), mode)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0, atol=WARP_ATOL)
    if kind == "far":
        far = (np.abs(flow) > 1e29).any(-1)
        if mode == "zeros_mask":
            assert (_nhwc(got)[far] == 0).all()
        else:
            # border: the edge pixel; spynet: the grid clamped to [-1, 1]
            # samples half an edge pixel
            assert (np.abs(_nhwc(got)[far]) > 0).any()


def test_zeros_mask_bits_equal_jax():
    """The analytic mask, thresholded at 1e-4, has the same bits in both
    packages, also for coordinates that put the in-bounds weight right at
    the threshold.  JAX's bits are read off a warped ones image: where its
    mask is 1 the sampled value is the (nonzero) in-bounds weight."""
    b, h, w = 2, 16, 24
    flow = _flow("wild", b, h, w, seed=3) * 0.1
    # land just outside the left edge: px in (-1, -1 + 2e-4)
    flow[0, :, :, 0] = (-np.arange(w, dtype=np.float32)[None]
                        - 1.0 + np.linspace(0, 2e-4, h, dtype=np.float32)[:, None])
    ones = np.ones((b, h, w, 1), np.float32)
    jmask = _jax_warp(ones, flow, "zeros_mask")[..., 0] != 0
    _, _, tmask = tinterp.warp_sample_coords(_nchw(flow), "zeros_mask")
    assert 0 < jmask.sum() < jmask.size
    np.testing.assert_array_equal(tmask.numpy(), jmask)


@pytest.mark.parametrize("c", [3, 32])
@pytest.mark.parametrize("mode", MODES)
def test_pallas_kernel_interpret_matches_port(mode, c):
    """The TPU kernel in interpret mode, fed the port's sample coordinates
    (the JAX wrapper's border clamp applied, interp.py:366-370), against
    the port's sampler on the same coordinates; the flow is smooth, so the
    kernel reports no violation and needs no correction."""
    b, h, w = 1, 40, 200
    img = np.random.RandomState(2).rand(b, h, w, c).astype(np.float32)
    flow = _flow("smooth", b, h, w, seed=4)
    x, y, _ = tinterp.warp_sample_coords(_nchw(flow), mode)
    pad = "border" if mode == "border" else "zeros"
    if mode == "border":
        x, y = x.clamp(0, w - 1), y.clamp(0, h - 1)
    out, viol = warp_tiled_sample(
        jnp.asarray(img), jnp.asarray(y.numpy()), jnp.asarray(x.numpy()),
        ry=8, rx=8, zeros_mode=pad == "zeros", interpret=True)
    assert int(viol) == 0
    ref = tinterp.bilinear_sample(_nchw(img), x, y, pad)
    np.testing.assert_allclose(np.asarray(out), _nhwc(ref), rtol=0,
                               atol=WARP_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_warp_gradients_match_jax(mode):
    """The autograd Function's backward (the plain version recomputed under
    autograd) against jax.vjp of the JAX warp, into img and flow."""
    b, h, w, c = 1, 9, 14, 3
    rng = np.random.RandomState(5)
    img = rng.rand(b, h, w, c).astype(np.float32)
    flow = _flow("smooth", b, h, w, seed=6)
    g = rng.randn(b, h, w, c).astype(np.float32)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda i, f: jinterp.warp_backward(i, f, mode=mode),
                         jnp.asarray(img), jnp.asarray(flow))
        jdi, jdf = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    ti = _nchw(img).requires_grad_()
    tf = _nchw(flow).requires_grad_()
    tops.warp_backward(ti, tf, mode).backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(ti.grad), jdi, rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(_nhwc(tf.grad), jdf, rtol=0, atol=GRAD_ATOL)


def test_warp_bf16_rounds_the_f32_sample_and_refuses_other_devices():
    """bf16 in, bf16 out: the f32 sample rounded once; no kernel launch on
    the CPU; a device that is neither CPU nor CUDA raises."""
    b, h, w, c = 1, 12, 20, 4
    img = torch.rand((b, c, h, w), generator=torch.Generator().manual_seed(0))
    flow = _nchw(_flow("wild", b, h, w) * 0.05)
    before = dict(tops.LAUNCH_COUNTS)
    for mode in MODES:
        got = tops.warp_backward(img.bfloat16(), flow, mode)
        ref = tops.warp_backward(img.bfloat16().float(), flow, mode)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, ref.bfloat16(), rtol=0, atol=0)
    assert dict(tops.LAUNCH_COUNTS) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tops.warp_backward(img.to("meta"), flow.to("meta"), "border")
    with pytest.raises(ValueError, match="unknown warp mode"):
        tops.warp_backward(img, flow, "reflect")


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_and_pool_match_jax(align_corners):
    x = np.random.RandomState(7).randn(2, 7, 11, 3).astype(np.float32)
    ref = np.asarray(jinterp.resize_bilinear(jnp.asarray(x), 14, 22,
                                             align_corners=align_corners))
    got = tops.resize_bilinear(_nchw(x), 14, 22, align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(tops.avg_pool2(_nchw(x))),
        np.asarray(jinterp.avg_pool2(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("patch", [9, 5])
def test_spatial_correlation_matches_jax(patch):
    """Patch 9 is PWC-Net's; the channel order is du-major (rows of the
    patch first): a dv-major reading of the same values fails."""
    rng = np.random.RandomState(8)
    f1 = rng.randn(2, 10, 13, 16).astype(np.float32)
    f2 = rng.randn(2, 10, 13, 16).astype(np.float32)
    ref = np.asarray(j_spatial_correlation(
        jnp.asarray(f1), jnp.asarray(f2), patch_size=patch))
    got = _nhwc(tops.spatial_correlation(_nchw(f1), _nchw(f2), patch))
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == (2, 10, 13, patch * patch)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CORR_REL_TOL * scale)
    swapped = got.reshape(2, 10, 13, patch, patch).swapaxes(3, 4).reshape(
        got.shape)
    assert np.abs(swapped - ref).max() > 0.1 * scale
    # bf16 in: f32 sums cast back to bf16
    got16 = tops.spatial_correlation(_nchw(f1).bfloat16(),
                                     _nchw(f2).bfloat16(), patch)
    assert got16.dtype == torch.bfloat16
