"""The coordinate gradient of the PyTorch port's correlation lookup against
the JAX package, on the CPU.

The port differentiates ``alt_corr_features`` with respect to coords that
require grad: the lookup runs through ``_AltCorrLookup``, whose backward on
a CPU tensor is ``alt_corr_coords_grad_reference``, the plain version of the
CUDA kernel ``csrc/alt_corr_dcoords.cu``.  The JAX side is the TPU kernel B3
itself (``_alt_corr_kernel`` with deriv="x"/"y") run in interpret mode
inside ``_alt_corr_bwd_pallas``, as tests/test_ops_correlation.py:541-579
runs it, and at non-integer centres also the VJP of the volume formulation
``_alt_corr_reference``.  At exactly integer centres the two JAX paths
disagree (B3's sign(0) = 0 against the floor-based sampler's forward
difference); the port computes what B3 computes.  The kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
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
from understanding_flow_robustness_tpu_torch.models import RAFT
from understanding_flow_robustness_tpu_torch.ops import correlation

GRAD_ATOL = 2e-4  # the JAX package's bar (test_ops_correlation.py:579)
# bf16 features, x max|dcoords|: both round f1 and the levels to bf16; the
# JAX kernel also rounds the correlation rows, the bilinear hats and its
# window images to bf16 (three more roundings of 2^-8 relative each), the
# port keeps f32 from the bf16 inputs on (measured 0.7 %)
BF16_REL = 2e-2
SHAPE = (1, 16, 24, 16)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, W, C, levels, kind, seed=0):
    """fmaps, (B, H, W, 2) coords and a cotangent.  kind: "random"
    (calibrated spread), "integer" (exactly ``coords_grid``, RAFT's first
    iteration) or "far" (random plus the out-of-volume, edge and +-1e30
    centres of tests/test_ops_correlation.py:557-559)."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    coords = np.repeat(np.asarray(jops.coords_grid(H, W))[None], B, 0)
    if kind != "integer":
        coords = coords + rng.randn(B, H, W, 2).astype(np.float32) * 3
    if kind == "far":
        coords[0, 0, :5] = [[-50, -50], [500, 500], [-3.5, -3.5],
                            [W - 0.25, H - 0.25], [1e30, -1e30]]
    g = rng.randn(B, H, W, levels * 81).astype(np.float32)
    return f1, f2, coords.astype(np.float32), g


def _port_dcoords(f1, f2, coords, g, levels, compute_dtype=None):
    c = torch.from_numpy(coords).requires_grad_()
    out = tops.alt_corr_features(torch.from_numpy(f1), torch.from_numpy(f2),
                                 c, levels, 4, compute_dtype=compute_dtype)
    out.backward(torch.from_numpy(g))
    return c.grad.numpy()


def _b3(f1, f2, coords, g, levels, compute_dtype=None):
    _, _, dc = _alt_corr_bwd_pallas(
        *map(jnp.asarray, (f1, f2, coords, g)), levels, 4, compute_dtype,
        False, interpret=True)
    return np.asarray(dc).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "integer", "far"])
def test_dcoords_match_b3_interpret_f32(kind):
    f1, f2, coords, g = _inputs(*SHAPE, 4, kind)
    got = _port_dcoords(f1, f2, coords, g, 4)
    ref = _b3(f1, f2, coords, g, 4)
    assert got.dtype == np.float32 and got.shape == coords.shape
    np.testing.assert_allclose(got, ref, atol=GRAD_ATOL)
    assert np.abs(ref).max() > 1.0  # a gradient, not zeros on both sides
    if kind == "far":  # windows wholly outside every level
        assert np.abs(got[0, 0, [0, 1, 4]]).max() == 0


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_dcoords_match_b3_interpret_fewer_levels(levels):
    f1, f2, coords, g = _inputs(*SHAPE, levels, "far", seed=levels)
    np.testing.assert_allclose(_port_dcoords(f1, f2, coords, g, levels),
                               _b3(f1, f2, coords, g, levels), atol=GRAD_ATOL)


def test_dcoords_match_b3_interpret_bf16():
    f1, f2, coords, g = _inputs(*SHAPE, 4, "random", seed=5)
    got = _port_dcoords(f1, f2, coords, g, 4, torch.bfloat16)
    ref = _b3(f1, f2, coords, g, 4, jnp.bfloat16)
    assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()


def test_dcoords_match_xla_reference_vjp_off_the_grid_only():
    """The volume formulation's VJP (floor-based, the forward difference)
    agrees at non-integer centres and not at integer ones, where B3 and
    the port give 0 along the axis on the grid."""
    for kind in ("random", "integer"):
        f1, f2, coords, g = _inputs(*SHAPE, 4, kind, seed=7)
        _, vjp = jax.vjp(lambda c: _alt_corr_reference(
            jnp.asarray(f1), jnp.asarray(f2), c, 4, 4), jnp.asarray(coords))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
        got = _port_dcoords(f1, f2, coords, g, 4)
        if kind == "random":
            np.testing.assert_allclose(got, ref, atol=GRAD_ATOL)
        else:
            assert np.abs(got - ref).max() > 1.0


def test_plain_coords_grad_central_differences_f64():
    """torch.autograd.gradcheck's central differences of the plain forward
    against ``alt_corr_coords_grad_reference`` (and the feature gradient),
    in f64, at centres well away from the grid's integers."""
    g = torch.Generator().manual_seed(0)
    B, H, W, C = 1, 6, 5, 3
    a = torch.randn((B, H, W, C), generator=g, dtype=torch.float64)
    b = torch.randn((B, H, W, C), generator=g, dtype=torch.float64)
    frac = 0.1 + 0.8 * torch.rand((B, H, W, 2), generator=g,
                                  dtype=torch.float64)
    coords = tops.coords_grid(H, W, dtype=torch.float64)[None] + frac + 2 * (
        torch.randint(-2, 3, (B, H, W, 2), generator=g).double())
    assert torch.autograd.gradcheck(
        lambda c, x: tops.alt_corr_features(x, b, c, 2, 4),
        (coords.requires_grad_(), a.requires_grad_()), eps=1e-6, atol=1e-6,
        fast_mode=True)


def test_sign_hat_gate_at_integer_centres():
    """The plain version's derivative along an axis whose window sits on
    the grid is 0, along the other axis it is not.  One level: at level l
    a centre is on the grid only where it is a multiple of 2^l."""
    f1, f2, coords, g = _inputs(1, 8, 8, 16, 1, "integer", seed=3)
    coords[..., 1] += 0.25  # y off the grid, x on it
    got = _port_dcoords(f1, f2, coords, g, 1)
    assert np.abs(got[..., 0]).max() == 0 and np.abs(got[..., 1]).max() > 1.0


def test_raft_requests_no_coordinate_gradient(monkeypatch):
    """RAFT detaches coords1 every iteration (JAX's coords_grad=False): an
    image gradient through the model runs the feature backward once per
    iteration and never the coordinate gradient."""
    calls = {"dcoords": 0, "dfeat": 0}
    for name, key in (("alt_corr_coords_grad_reference", "dcoords"),
                      ("alt_corr_lookup_backward_reference", "dfeat")):
        fn = getattr(correlation, name)
        monkeypatch.setattr(correlation, name, lambda *a, _f=fn, _k=key: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a))[1])
    torch.manual_seed(0)
    model = RAFT(iters=2).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    a = (255 * torch.rand(1, 3, 64, 64)).requires_grad_()
    b = (255 * torch.rand(1, 3, 64, 64)).requires_grad_()
    _, up = model(a, b)
    up.square().sum().backward()
    assert calls == {"dcoords": 0, "dfeat": 2}
    assert bool(torch.isfinite(a.grad).all()) and a.grad.abs().max() > 0


# The geometries the CUDA kernel's tile stage (csrc/alt_corr_tile.cuh) makes
# special: a ragged query grid (13x21 is no multiple of the 8x8 tile and its
# pooled levels are 6x10, 3x5 and 1x2, smaller than a tile), every radius
# class the kernel is instantiated for (r = 1, 4 and 7, whose (2r+2)^2
# dots fill the TPU kernel's 16-wide tile), f32 and bf16 features.
RAGGED = (1, 13, 21, 16)


def _ragged_inputs(radius, kind, seed):
    """Seeded fmaps, (1, 13, 21, 2) coords and a cotangent for ``radius``.
    kind: "calibrated" (the grid plus 2 px of noise), "wild" (20 px: many
    windows part or wholly outside the coarse levels), "far" (calibrated
    plus out-of-level, edge and +-1e30 centres in the first row) or
    "integer" (exactly the grid)."""
    B, H, W, C = RAGGED
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    coords = np.repeat(np.asarray(jops.coords_grid(H, W))[None], B, 0)
    noise = rng.randn(B, H, W, 2).astype(np.float32)
    if kind != "integer":
        coords = coords + noise * (20.0 if kind == "wild" else 2.0)
    if kind == "far":
        coords[0, 0, :6] = [[-1e30, 3.0], [3.0, 1e30], [1e30, -1e30],
                            [-50.0, -50.0], [500.0, 500.0], [-3.5, -3.5]]
    g = rng.randn(B, H, W, 4 * (2 * radius + 1) ** 2).astype(np.float32)
    return f1, f2, coords.astype(np.float32), g


@pytest.mark.parametrize("kind", ["calibrated", "wild", "far", "integer"])
@pytest.mark.parametrize("radius", [1, 4, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dcoords_match_b3_interpret_ragged(dtype, radius, kind):
    """``alt_corr_coords_grad_reference`` (the port's CPU path and the
    kernel's oracle) against the JAX package's B3 in interpret mode, on the
    ragged grid with levels down to 1x2, under the file's bars (f32
    GRAD_ATOL; bf16 BF16_REL x max|dcoords|, the JAX kernel rounding its
    rows, hats and window images to bf16)."""
    seed = 100 * radius + ["calibrated", "wild", "far", "integer"].index(kind)
    f1, f2, coords, g = _ragged_inputs(radius, kind, seed)
    tdt = None if dtype == "float32" else torch.bfloat16
    jdt = None if dtype == "float32" else jnp.bfloat16
    c = torch.from_numpy(coords).requires_grad_()
    out = tops.alt_corr_features(torch.from_numpy(f1), torch.from_numpy(f2),
                                 c, 4, radius, compute_dtype=tdt)
    out.backward(torch.from_numpy(g))
    got = c.grad.numpy()
    _, _, ref = _alt_corr_bwd_pallas(
        *map(jnp.asarray, (f1, f2, coords, g)), 4, radius, jdt, False,
        interpret=True)
    ref = np.asarray(ref).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == coords.shape
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=GRAD_ATOL)
    else:
        assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()
    if kind == "far":  # windows wholly outside every level: exactly 0
        assert np.abs(got[0, 0, [0, 1, 2, 4]]).max() == 0
    if kind == "integer":  # x, y multiples of 8 sit on every level's grid
        assert np.abs(got[0, :, ::8, 0]).max() == 0
        assert np.abs(got[0, ::8, :, 1]).max() == 0
