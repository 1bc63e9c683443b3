"""Parity of the PyTorch port's spatial-correlation RAFT
(``compute_spatial=True``) and of the general spatial correlation with the
JAX package, on the CPU.

``RAFT(compute_spatial=True)`` correlates the f32 fmaps with the (21, 2)
spatial correlation, pyramids the raw (B, 441, h, w) output and "looks up"
by nearest upsampling and a C-order reshape (``spatial_corr_lookup``,
raft_model.py:1045-1060).  On the CPU the correlation and its gradient run
the plain versions of ``csrc/spatial_corr_{fwd,bwd}.cu``.  JAX variables go
through the weight bridge; both run the same numpy 64x64 images for 2
iterations.  The general path (any kernel size, stride, padding) is plain
PyTorch on every device, as the JAX package's is XLA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raft_small import assert_drift_within_jax, train_step_matches_jax
from test_torch_raft_variants import (
    FLOW_ATOL_PX,
    ITERS,
    TAP_REL_ATOL,
    _nhwc,
    _port,
    _run_jax,
    _run_port,
    _variables,
)
from understanding_flow_robustness_tpu.ops.correlation import (
    spatial_correlation as j_spatial_correlation,
)
from understanding_flow_robustness_tpu_torch import ops as tops
from understanding_flow_robustness_tpu_torch.models import get_feature_map_keys
from understanding_flow_robustness_tpu_torch.models.raft_model import (
    spatial_corr_lookup,
)

SPATIAL = {"compute_spatial": True}
CORR_ATOL = 1e-4  # f32, x max(1, |ref|): the same products summed in another order


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spatial_setup():
    rng = np.random.RandomState(30)
    imgs = [(rng.rand(1, 64, 64, 3) * 255).astype(np.float32)
            for _ in range(2)]
    v = _variables(5, **SPATIAL)
    j_low, j_up, j_feats = _run_jax(v, imgs, mixed_precision=False,
                                    return_features=True, **SPATIAL)
    return v, imgs, (np.asarray(j_low), np.asarray(j_up), j_feats)


def test_spatial_f32_matches_jax(spatial_setup):
    """Flows in f32 within 1e-3 px of JAX's, with and without the taps,
    and the plain-correlation oracle (``plain_lookup``) equal on the CPU;
    the update block reads L * 441 correlation planes."""
    v, imgs, (j_low, j_up, _) = spatial_setup
    model = _port(v, **SPATIAL)
    assert model.update_block.encoder.convc1.in_channels == 4 * 441
    p_low, p_up = _run_port(model, imgs)
    assert np.abs(_nhwc(p_low) - j_low).max() < FLOW_ATOL_PX
    assert np.abs(_nhwc(p_up) - j_up).max() < FLOW_ATOL_PX
    model.plain_lookup = True
    _, q_up = _run_port(model, imgs)
    torch.testing.assert_close(q_up, p_up, rtol=0, atol=0)


def test_spatial_mixed_within_drift_bar(spatial_setup):
    """Mixed precision: the correlation stays f32 (the fmaps are cast to
    f32 first) in both packages, the convolutions bf16.  JAX's own mixed
    run is 2.6 % from its f32 run here (0.6 px flows), so the port is held
    to DRIFT_RATIO x that distance (tests/test_torch_raft_small.py)."""
    v, imgs, (_, j_f32, _) = spatial_setup
    assert_drift_within_jax(v, imgs, j_f32, SPATIAL, impls=("auto",))


def test_spatial_taps_match_jax(spatial_setup):
    """The taps: ``get_feature_map_keys("RAFT")``'s keys plus
    ``spatial_corr`` (the correlation / C, NCHW here and NHWC in JAX), each
    equal to JAX's (atol 1e-4 x its scale); ``corr_pyramid_{i}`` is the
    pyramid of the raw correlation, (B, 441, h/2^i, w/2^i)."""
    v, imgs, (_, _, j_feats) = spatial_setup
    _, _, p_feats = _run_port(_port(v, return_features=True, **SPATIAL), imgs)
    keys = get_feature_map_keys("RAFT")[:8 + 7 * ITERS]
    assert set(p_feats) == set(keys) | {"spatial_corr"}
    assert set(j_feats) == set(p_feats)
    assert tuple(p_feats["corr_pyramid_1"].shape) == (1, 441, 4, 4)
    for k, got in p_feats.items():
        ref = np.asarray(j_feats[k])
        if not k.startswith("corr_pyramid"):
            got = got.permute(0, 2, 3, 1)
        assert tuple(got.shape) == ref.shape, k
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=0,
            atol=TAP_REL_ATOL * max(1.0, np.abs(ref).max()), err_msg=k)
    np.testing.assert_allclose(
        p_feats["corr_pyramid_0"].numpy() / 256,
        p_feats["spatial_corr"].numpy(), rtol=1e-6)


def test_spatial_corr_lookup_is_a_c_order_view():
    """Level i is nearest-upsampled by 2^i, then the (B, 441, h, w) memory
    is read as (B, h, w, 441) -- a reshape, not a transpose (the
    reference's ``corr.view(batch, h1, w1, -1)``): query (y, x) of level 0
    gets the 441 consecutive values at flat offset (y * w + x) * 441 of the
    channel-major volume, and the levels follow one another."""
    B, P, h, w = 2, 441, 4, 6
    lvl0 = torch.arange(B * P * h * w, dtype=torch.float32).reshape(B, P, h, w)
    lvl1 = -torch.arange(B * P * 2 * 3, dtype=torch.float32).reshape(B, P, 2, 3)
    out = spatial_corr_lookup([lvl0, lvl1], h, w)
    assert tuple(out.shape) == (B, h, w, 2 * P)
    flat0 = lvl0.reshape(B, -1)
    for y, x in ((0, 0), (1, 4), (3, 5)):
        q = y * w + x
        torch.testing.assert_close(out[1, y, x, :P],
                                   flat0[1, q * P:(q + 1) * P])
    up1 = lvl1.repeat_interleave(2, 2).repeat_interleave(2, 3)
    torch.testing.assert_close(out[..., P:], up1.reshape(B, h, w, P))
    # not the transpose
    assert not torch.equal(out[..., :P], lvl0.permute(0, 2, 3, 1))
    # a level that does not upsample back to the grid (H/8 = 36 with 4
    # levels: 36 -> 18 -> 9 -> 4, x8 = 32) raises
    pyr = tops.corr_pyramid(torch.zeros(1, P, 36, 8), 4)
    with pytest.raises(ValueError, match="multiples of 8"):
        spatial_corr_lookup(pyr, 36, 8)


def test_spatial_train_step_matches_jax():
    """One train step's loss and gradients: the correlation's gradient
    reaches both fmaps (the plain autograd of the correlation on the CPU,
    ``spatial_corr_bwd`` on the card)."""
    train_step_matches_jax(SPATIAL, seed=31)


@pytest.mark.parametrize("patch,kernel,stride,pad,dil,dil_patch", [
    (3, 3, 1, 1, 1, 1), (5, 1, 2, 0, 1, 2), (3, 3, 2, 2, 2, 1),
    (1, 2, 1, 0, 1, 1), (7, 1, 1, 3, 1, 1)])
def test_general_spatial_correlation_matches_jax(patch, kernel, stride, pad,
                                                  dil, dil_patch):
    """The general path (kernel, stride or padding other than (1, 1, 0))
    against the JAX package's ``_spatial_correlation_general`` (through its
    ``spatial_correlation``), NCHW against NHWC, with a gradient."""
    rng = np.random.RandomState(patch * 10 + kernel)
    f1 = rng.randn(2, 13, 17, 5).astype(np.float32)
    f2 = rng.randn(2, 13, 17, 5).astype(np.float32)
    ref = np.asarray(j_spatial_correlation(
        jnp.asarray(f1), jnp.asarray(f2), patch, kernel, stride, pad, dil,
        dil_patch))
    a = torch.from_numpy(f1).permute(0, 3, 1, 2).requires_grad_()
    b = torch.from_numpy(f2).permute(0, 3, 1, 2)
    before = dict(tops.LAUNCH_COUNTS)
    got = tops.spatial_correlation(a, b, patch, kernel, stride, pad, dil,
                                   dil_patch)
    assert dict(tops.LAUNCH_COUNTS) == before
    got_nhwc = got.permute(0, 2, 3, 1).detach().numpy()
    assert got_nhwc.shape == ref.shape
    np.testing.assert_allclose(got_nhwc, ref,
                               atol=CORR_ATOL * max(1.0, np.abs(ref).max()))
    got.sum().backward()
    assert a.grad.shape == a.shape and bool(torch.isfinite(a.grad).all())


def test_general_spatial_correlation_refuses_a_kernel_that_does_not_fit():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="does not fit"):
        tops.spatial_correlation(x, x, 3, kernel_size=7)
