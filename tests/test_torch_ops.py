"""Parity of the PyTorch port's correlation ops with the JAX package.

Inputs come from a numpy seed and go to both packages; the JAX side runs on
the CPU (its Pallas lookup kernel in interpret mode, as
tests/test_ops_correlation.py runs it).  The port's ``alt_corr_features``
on a CPU tensor runs the plain version of the CUDA kernel
``csrc/alt_corr_fwd.cu``; the kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from understanding_flow_robustness_tpu import ops as jops
from understanding_flow_robustness_tpu.ops.pallas.alt_corr import (
    pool_fmap_levels as j_pool_fmap_levels,
)
from understanding_flow_robustness_tpu_torch import ops as tops

F32_ATOL = 1e-4  # the JAX package's bar for this lookup (test_ops_correlation.py:327)
SHAPES = [(2, 16, 24, 16), (2, 13, 21, 16)]  # the second pools to ragged levels


def _inputs(B, H, W, C, seed=0, spread=3.0):
    """f1, f2 (B, H, W, C) and coords with edge and out-of-volume centres
    (tests/test_ops_correlation.py:315-318)."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    coords = np.asarray(jops.coords_grid(H, W))[None] + rng.randn(
        B, H, W, 2).astype(np.float32) * spread
    coords[0, 0, 0] = [-50, -50]
    coords[0, 0, 1] = [500, 500]
    coords[0, 0, 2] = [-3.5, -3.5]
    coords[0, 0, 3] = [W - 0.25, H - 0.25]
    coords[0, 1, 0] = [W - 1.0, H - 1.0]
    return f1, f2, coords.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_coords_grid_matches_jax():
    got = tops.coords_grid(5, 7).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.coords_grid(5, 7)))
    assert got[2, 3].tolist() == [3.0, 2.0]  # (x, y) channel order


@pytest.mark.parametrize("shape", SHAPES)
def test_volume_pyramid_and_pooling_match_jax(shape):
    f1, f2, _ = _inputs(*shape)
    jcorr = jops.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    tcorr = tops.all_pairs_correlation(_t(f1), _t(f2))
    np.testing.assert_allclose(tcorr.numpy(), np.asarray(jcorr), atol=1e-5)

    # pyramid on the SAME volume: same floor semantics and association
    jpyr = jops.corr_pyramid(jcorr, 4)
    tpyr = tops.corr_pyramid(_t(jcorr), 4)
    for a, b in zip(tpyr, jpyr):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jlv = j_pool_fmap_levels(jnp.asarray(f2), 4)
    tlv = tops.pool_fmap_levels(_t(f2), 4)
    for a, b in zip(tlv, jlv):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape", SHAPES)
def test_corr_lookup_matches_jax_gather(shape):
    f1, f2, coords = _inputs(*shape, seed=1)
    pyr = jops.corr_pyramid(
        jops.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2)), 4)
    ref = np.asarray(jops.corr_lookup(pyr, jnp.asarray(coords), 4,
                                      impl="gather"))
    got = tops.corr_lookup([_t(p) for p in pyr], _t(coords), 4).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_alt_corr_features_matches_jax_f32(shape):
    """Port (CPU path: the kernel's plain version) against the JAX Pallas
    kernel in interpret mode and against the explicit volume + pyramid +
    gather lookup, element by element: channel l*81 + s*9 + t must be the
    sample at (x/2^l - 4 + s, y/2^l - 4 + t)."""
    B, H, W, C = shape
    f1, f2, coords = _inputs(*shape, seed=2)
    j1, j2, jc = jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords)
    ref_gather = np.asarray(jops.corr_lookup(
        jops.corr_pyramid(jops.all_pairs_correlation(j1, j2), 4), jc, 4,
        impl="gather"))
    ref_kernel = np.asarray(jops.alt_corr_features(j1, j2, jc, 4, 4,
                                                   interpret=True))
    got = tops.alt_corr_features(_t(f1), _t(f2), _t(coords), 4, 4)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, W, 324)
    got = got.numpy()
    np.testing.assert_allclose(got, ref_kernel, atol=F32_ATOL)
    np.testing.assert_allclose(got, ref_gather, atol=F32_ATOL)
    # the comparison above is sensitive to the window's channel order: a
    # t-major output fails it
    t_major = got.reshape(B, H, W, 4, 9, 9).swapaxes(-1, -2).reshape(got.shape)
    assert np.abs(t_major - ref_gather).max() > 100 * F32_ATOL


@pytest.mark.parametrize("shape", SHAPES)
def test_alt_corr_features_matches_jax_bf16(shape):
    """compute_dtype=bf16 against the JAX kernel's bf16 interpret run.
    Bound: 2e-2 x max|corr|.  Both round f1 and the pooled levels to bf16;
    the JAX kernel also rounds the correlation rows, the column blend and
    its output to bf16 (three more roundings of 2^-8 relative each), while
    the port keeps f32 from the bf16 inputs on."""
    f1, f2, coords = _inputs(*shape, seed=3)
    ref = np.asarray(jops.alt_corr_features(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords), 4, 4,
        compute_dtype=jnp.bfloat16, interpret=True)).astype(np.float32)
    got = tops.alt_corr_features(_t(f1), _t(f2), _t(coords), 4, 4,
                                 compute_dtype=torch.bfloat16).numpy()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


# radii other than RAFT's 4 (small RAFT's 3 among them) up to the TPU
# kernels' 7
RADII = (1, 2, 3, 5, 7)


@pytest.mark.parametrize("radius", RADII)
def test_alt_corr_features_any_radius_matches_jax(radius):
    """The plain lookup at radius r against the JAX Pallas kernel in
    interpret mode: f32 within the f32 bar, and at small RAFT's r = 3 also
    bf16 within the bf16 one (test_alt_corr_features_matches_jax_bf16)."""
    f1, f2, coords = _inputs(2, 13, 21, 16, seed=40 + radius)
    j1, j2, jc = jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords)
    ref = np.asarray(jops.alt_corr_features(j1, j2, jc, 4, radius,
                                            interpret=True))
    got = tops.alt_corr_features(_t(f1), _t(f2), _t(coords), 4, radius)
    assert tuple(got.shape) == (2, 13, 21, 4 * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_ATOL)
    if radius == 3:
        ref = np.asarray(jops.alt_corr_features(
            j1, j2, jc, 4, radius, compute_dtype=jnp.bfloat16,
            interpret=True)).astype(np.float32)
        got = tops.alt_corr_features(_t(f1), _t(f2), _t(coords), 4, radius,
                                     compute_dtype=torch.bfloat16).numpy()
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_alt_corr_lookup_plain_path_is_forward_only_and_uncounted():
    """The CPU path launches no kernel, with or without a feature or a
    coordinate gradient (tests/test_torch_ops_grad.py and
    tests/test_torch_coords_grad.py hold those gradients against JAX); a
    coordinate gradient alone routes through the autograd Function and
    leaves the features without one."""
    f1, f2, coords = _inputs(1, 8, 8, 16)
    a, levels = tops.prepare_alt_corr(_t(f1), _t(f2), 4)
    c = _t(coords).reshape(1, 64, 2)
    before = dict(tops.LAUNCH_COUNTS)
    out = tops.alt_corr_lookup(a, levels, c, 4)
    assert tuple(out.shape) == (1, 64, 324) and out.grad_fn is None
    tops.alt_corr_lookup(a.requires_grad_(), levels, c, 4).sum().backward()
    assert a.grad is not None
    cg = c.clone().requires_grad_()
    out = tops.alt_corr_lookup(a.detach(), levels, cg, 4)
    assert type(out.grad_fn).__name__ == "_AltCorrLookupBackward"
    out.sum().backward()
    assert cg.grad.shape == cg.shape and bool(torch.isfinite(cg.grad).all())
    assert dict(tops.LAUNCH_COUNTS) == before  # no kernel on the CPU


def test_backward_kernel_query_grid():
    """csrc/alt_corr_bwd.cu cuts the queries into 8x8 tiles of level 0's
    grid where f1 and fmap2 share it (every model path), else of one row."""
    from understanding_flow_robustness_tpu_torch.ops import correlation

    levels = [torch.zeros((2, 13, 21, 8)), torch.zeros((2, 6, 10, 8))]
    assert correlation._query_grid(levels, 13 * 21) == (13, 21)
    assert correlation._query_grid(levels, 100) == (1, 100)


def _fake_forward_launch(monkeypatch, rc=0):
    """Stand-ins for the CUDA side of ``_alt_corr_lookup_cuda`` on a
    machine without a card: the ctypes kernel function records its
    arguments and returns ``rc``; the device and stream calls are no-ops."""
    import types

    from understanding_flow_robustness_tpu_torch.ops import correlation

    calls = []

    def fn(*args):
        calls.append(args)
        return rc

    lib = types.SimpleNamespace(ufr_cuda_error_string=lambda err: b"refused")
    monkeypatch.setattr(correlation, "kernel_fn", lambda *a: (fn, lib))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("n,grid", [(13 * 21, (13, 21)), (100, (1, 100))])
def test_forward_kernel_query_grid_and_counter(monkeypatch, n, grid):
    """csrc/alt_corr_fwd.cu gets the (H1, W1) grid it cuts into 8x8 tiles
    (level 0's where the queries are its pixels, else one row of n; as
    _alt_corr_bwd_cuda passes it), the path counter's pointer or null, and
    a launch is counted only when the kernel's call returns 0."""
    from understanding_flow_robustness_tpu_torch.ops import correlation

    calls = _fake_forward_launch(monkeypatch)
    f1 = torch.zeros((2, n, 16))
    levels = [torch.zeros((2, 13, 21, 16)), torch.zeros((2, 6, 10, 16))]
    coords = torch.zeros((2, n, 2))
    counts = torch.zeros(4, dtype=torch.int32)
    before = tops.LAUNCH_COUNTS["alt_corr_fwd"]
    out = correlation._alt_corr_lookup_cuda(f1, levels, coords, 4, counts)
    correlation._alt_corr_lookup_cuda(f1, levels, coords, 4)
    assert tuple(out.shape) == (2, n, 2 * 81) and out.dtype == torch.float32
    assert tops.LAUNCH_COUNTS["alt_corr_fwd"] == before + 2
    # (f1, levels, hw, L, coords, out, B, H1, W1, C, radius, is_bf16,
    #  path_counts, stream)
    for call, pc in zip(calls, (counts.data_ptr(), None)):
        assert call[6:12] == (2, *grid, 16, 4, 0)
        assert list(call[2]) == [13, 21, 6, 10] and call[3] == 2
        assert call[12] == pc


@pytest.mark.parametrize("n,grid", [(13 * 21, (13, 21)), (100, (1, 100))])
def test_dcoords_kernel_query_grid_and_counter(monkeypatch, n, grid):
    """csrc/alt_corr_dcoords.cu gets the (H1, W1) grid it cuts into 8x8
    tiles, as csrc/alt_corr_fwd.cu does (so both count the same (tile,
    level) paths), a scratch of per-level partials, and the path counter's
    pointer or null; a launch is counted only when the call returns 0."""
    from understanding_flow_robustness_tpu_torch.ops import correlation

    calls = _fake_forward_launch(monkeypatch)
    f1 = torch.zeros((2, n, 16))
    levels = [torch.zeros((2, 13, 21, 16)), torch.zeros((2, 6, 10, 16))]
    coords = torch.zeros((2, n, 2))
    g = torch.zeros((2, n, 2 * 81))
    counts = torch.zeros(4, dtype=torch.int32)
    before = tops.LAUNCH_COUNTS["alt_corr_dcoords"]
    out = correlation._alt_corr_dcoords_cuda(f1, levels, coords, g, 4, counts)
    correlation._alt_corr_dcoords_cuda(f1, levels, coords, g, 4)
    assert tuple(out.shape) == (2, n, 2) and out.dtype == torch.float32
    assert tops.LAUNCH_COUNTS["alt_corr_dcoords"] == before + 2
    # (f1, levels, hw, L, coords, g, partial, dcoords, B, H1, W1, C,
    #  radius, is_bf16, path_counts, stream)
    assert calls[0][7] == out.data_ptr()
    for call, pc in zip(calls, (counts.data_ptr(), None)):
        assert call[8:14] == (2, *grid, 16, 4, 0)
        assert call[6] not in (call[5], call[7])  # the partials' own buffer
        assert list(call[2]) == [13, 21, 6, 10] and call[3] == 2
        assert call[14] == pc

@pytest.mark.parametrize("radius", [0, 1, 3, 7, 8])
def test_kernel_wrappers_take_radius_1_to_7(monkeypatch, radius):
    """csrc/alt_corr_{fwd,bwd,dcoords}.cu are instantiated for radius 1..7
    (csrc/radius.cuh): their wrappers pass such a radius to the kernel
    with outputs of L * (2r+1)^2 channels and raise before the kernel on
    0 and 8, launching and counting nothing."""
    from understanding_flow_robustness_tpu_torch.ops import correlation

    calls = _fake_forward_launch(monkeypatch)
    f1, levels = tops.prepare_alt_corr(torch.zeros(1, 8, 8, 16),
                                       torch.zeros(1, 8, 8, 16), 2)
    coords = torch.zeros(1, 64, 2)
    g = torch.zeros(1, 64, 2 * (2 * radius + 1) ** 2)
    wrappers = (
        lambda: correlation._alt_corr_lookup_cuda(f1, levels, coords, radius),
        lambda: correlation._alt_corr_bwd_cuda(f1, levels, coords, g, radius),
        lambda: correlation._alt_corr_dcoords_cuda(f1, levels, coords, g,
                                                   radius))
    before = dict(tops.LAUNCH_COUNTS)
    for launch in wrappers:
        if 1 <= radius <= 7:
            launch()
        else:
            with pytest.raises(ValueError, match="radius 1..7"):
                launch()
    if 1 <= radius <= 7:
        # the radius is the argument after C in each entry point
        assert len(calls) == 3
        assert (calls[0][10], calls[1][12], calls[2][12]) == (radius,) * 3
    else:
        assert calls == [] and dict(tops.LAUNCH_COUNTS) == before


def test_forward_kernel_failure_raises_uncounted(monkeypatch):
    from understanding_flow_robustness_tpu_torch.ops import correlation

    _fake_forward_launch(monkeypatch, rc=1)
    f1, levels = tops.prepare_alt_corr(torch.zeros(1, 8, 8, 16),
                                       torch.zeros(1, 8, 8, 16), 2)
    before = tops.LAUNCH_COUNTS["alt_corr_fwd"]
    with pytest.raises(RuntimeError, match="alt_corr_fwd launch failed: refused"):
        correlation._alt_corr_lookup_cuda(f1, levels, torch.zeros(1, 64, 2), 4)
    assert tops.LAUNCH_COUNTS["alt_corr_fwd"] == before


@pytest.mark.parametrize("bad", ["dtype", "size", "strided"])
def test_forward_path_counts_checked_before_launch(monkeypatch, bad):
    """A path counter the kernel cannot take raises before the kernel is
    built or launched."""
    from understanding_flow_robustness_tpu_torch.ops import correlation

    calls = _fake_forward_launch(monkeypatch)
    f1, levels = tops.prepare_alt_corr(torch.zeros(1, 8, 8, 16),
                                       torch.zeros(1, 8, 8, 16), 4)
    counts = {"dtype": torch.zeros(8, dtype=torch.int64),
              "size": torch.zeros(4, dtype=torch.int32),
              "strided": torch.zeros(16, dtype=torch.int32)[::2]}[bad]
    before = tops.LAUNCH_COUNTS["alt_corr_fwd"]
    with pytest.raises(ValueError, match="path_counts"):
        correlation._alt_corr_lookup_cuda(f1, levels, torch.zeros(1, 64, 2), 4,
                                          counts)
    assert calls == [] and tops.LAUNCH_COUNTS["alt_corr_fwd"] == before
