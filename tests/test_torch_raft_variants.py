"""Parity of the PyTorch port's RAFT volume path, its feature taps and
``RAFT_FlowNetCEncoder_WoContext`` with the JAX package's, on the CPU.

JAX ``RAFT`` init variables (biases, batch-norm parameters and running
statistics perturbed from a numpy seed, the FlowHead scaled by 0.05 to the
calibrated operating point) go through the weight bridge into the port; both
then run the same numpy 64x64 images for a few iterations.  The port's
lookups run the plain versions of their kernels on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu.models import convert as jconvert
from understanding_flow_robustness_tpu.models.raft_model import (
    RAFT as JRAFT,
    scale_flow_head as j_scale_flow_head,
)
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    fetch_model,
    get_feature_map_keys,
    raft_state_dict_from_jax,
)

ITERS = 2
FLOW_ATOL_PX = 1e-3    # f32 vs f32 (tests/test_model_parity.py:194)
MIXED_REL_EPE = 0.01   # mean EPE / mean |flow|, the 1 % bar (BASELINE.md)
WOCONTEXT = {"flownetc_encoder": True, "no_separate_context": True}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    """Norm scales, running variances and the all-zero biases and running
    means away from their init values, so that a wrong mapping of any of
    them cannot pass (as tests/test_torch_raft.py does)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturb(v, rng)
        elif k in ("scale", "var"):
            out[k] = np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean") and np.all(np.asarray(v) == 0):
            out[k] = (0.1 * rng.randn(*np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _variables(seed, **kw):
    rng = np.random.RandomState(seed)
    v = jax.jit(JRAFT(iters=1, **kw).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 3)))
    v = {coll: _perturb(tree, rng) for coll, tree in v.items()}
    return j_scale_flow_head(v, 0.05)


@pytest.fixture(scope="module")
def raft_setup():
    rng = np.random.RandomState(10)
    imgs = [(rng.rand(1, 64, 64, 3) * 255).astype(np.float32) for _ in range(2)]
    return _variables(0), imgs


@pytest.fixture(scope="module")
def wocontext_setup():
    rng = np.random.RandomState(11)
    imgs = [(rng.rand(1, 64, 64, 3) * 255).astype(np.float32) for _ in range(2)]
    return _variables(1, **WOCONTEXT), imgs


def _run_jax(variables, imgs, **kw):
    jm = JRAFT(iters=ITERS, **kw)
    return jax.jit(lambda v, a, b: jm.apply(v, a, b, test_mode=True))(
        variables, *imgs)


def _port(variables, **kw):
    model = RAFT(iters=ITERS, **kw).eval()
    model.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    return model


def _run_port(model, imgs):
    a, b = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in imgs)
    with torch.inference_mode():
        return model(a, b)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _rel_epe(got, ref):
    epe = np.sqrt(((got - ref) ** 2).sum(-1)).mean()
    return epe / np.sqrt((ref ** 2).sum(-1)).mean()


@pytest.fixture(scope="module")
def f32_taps(raft_setup):
    """JAX's f32 volume-path forward with its taps, and the port's."""
    v, imgs = raft_setup
    j_low, j_up, j_feats = _run_jax(v, imgs, mixed_precision=False,
                                    return_features=True)
    p_low, p_up, p_feats = _run_port(_port(v, return_features=True), imgs)
    return (np.asarray(j_low), np.asarray(j_up), j_feats), (p_low, p_up, p_feats)


def test_volume_path_f32_matches_jax(raft_setup, f32_taps):
    """``corr_impl="volume"`` against JAX's volume path in f32, and the same
    flow with the taps on."""
    v, imgs = raft_setup
    (j_low, j_up, _), (t_low, t_up, _) = f32_taps
    model = _port(v, corr_impl="volume")
    p_low, p_up = _run_port(model, imgs)
    assert tuple(p_up.shape) == (1, 2, 64, 64)
    assert np.abs(_nhwc(p_low) - j_low).max() < FLOW_ATOL_PX
    assert np.abs(_nhwc(p_up) - j_up).max() < FLOW_ATOL_PX
    torch.testing.assert_close(t_up, p_up, rtol=0, atol=0)
    # the alt path on the same weights: value-equal
    a_low, a_up = _run_port(_port(v), imgs)
    assert np.abs(_nhwc(a_up) - j_up).max() < FLOW_ATOL_PX


# every tap against JAX's, by family: atol 1e-4 x the tap's largest |value|
# in JAX, at least 1.  f32 on both sides, so the taps differ by the
# summation order of the convolutions only (measured: ~1e-6 of each tap's
# scale); the cnet's pre-activations reach ~60, and tanh passes their
# ~5e-5 differences onto net's values of at most 1 (measured 3.7e-5)
TAP_REL_ATOL = 1e-4
TAP_FAMILIES = {
    "fmap": ["fmap1", "fmap2"],
    "corr_pyramid": [f"corr_pyramid_{i}" for i in range(4)],
    "context": ["net", "inp"],
    **{name: [f"{name}_{it}" for it in range(ITERS)]
       for name in ("idx_corr_vol", "net", "motion_features", "cor1", "cor",
                    "cor_flo", "flow_pred")},
}


def test_feature_tap_keys(f32_taps):
    """The port's dict has the keys of ``get_feature_map_keys("RAFT")`` in
    its order, cut to the iterations that ran (8 fixed keys, then 7 per
    iteration), and JAX's the same set."""
    (_, _, j_feats), (_, _, p_feats) = f32_taps
    keys = get_feature_map_keys("RAFT")
    assert len(keys) == 8 + 7 * 12
    assert list(p_feats) == keys[:8 + 7 * ITERS]
    assert set(j_feats) == set(p_feats)


@pytest.mark.parametrize("family", list(TAP_FAMILIES))
def test_feature_taps_match_jax(f32_taps, family):
    """Each tap in the model's NCHW against JAX's NHWC tap, permuted;
    ``corr_pyramid_{i}`` is (B, N, Hl, Wl) in both."""
    (_, _, j_feats), (_, _, p_feats) = f32_taps
    for k in TAP_FAMILIES[family]:
        ref = np.asarray(j_feats[k])
        got = p_feats[k]
        if family != "corr_pyramid":
            got = got.permute(0, 2, 3, 1)
        assert tuple(got.shape) == ref.shape, k
        assert got.dtype == torch.float32, k
        got = got.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=TAP_REL_ATOL * max(1.0, np.abs(ref).max()),
            err_msg=k)


def test_volume_path_mixed_within_drift_bar(raft_setup):
    """Mixed precision on the volume path: bf16 volume and pyramid, bf16
    convolutions; against JAX's same configuration within the 1 % bar."""
    v, imgs = raft_setup
    _, j_up = _run_jax(v, imgs, mixed_precision=True, corr_impl="volume")
    model = _port(v, mixed_precision=True, corr_impl="volume")
    _, p_up = _run_port(model, imgs)
    assert _rel_epe(_nhwc(p_up), np.asarray(j_up)) < MIXED_REL_EPE


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
def test_wocontext_matches_jax(wocontext_setup, mixed):
    """``RAFT_FlowNetCEncoder_WoContext`` (FlowNetCEncoder fnet, conv_redir
    context, served on the alt path) against JAX's (its volume path on the
    CPU): f32 at 1e-3 px, mixed precision within the 1 % bar."""
    v, imgs = wocontext_setup
    j_low, j_up = _run_jax(v, imgs, mixed_precision=mixed, **WOCONTEXT)
    model = _port(v, mixed_precision=mixed, **WOCONTEXT)
    p_low, p_up = _run_port(model, imgs)
    j_up = np.asarray(j_up)
    assert tuple(p_up.shape) == (1, 2, 64, 64)
    if mixed:
        assert _rel_epe(_nhwc(p_up), j_up) < MIXED_REL_EPE
    else:
        assert np.abs(_nhwc(p_low) - np.asarray(j_low)).max() < FLOW_ATOL_PX
        assert np.abs(_nhwc(p_up) - j_up).max() < FLOW_ATOL_PX


@pytest.mark.parametrize("kw", [WOCONTEXT, {"flownetc_encoder": True}],
                         ids=["wocontext", "flownetc_cnet"])
def test_wocontext_weight_bridge(kw):
    """The bridge maps an encoder's ``conv{i}`` to the reference's
    ``conv{i}.0`` where it is a FlowNetCEncoder (fnet, and cnet unless
    ``no_separate_context``) and keeps ``conv_redir``; the port's state
    dict goes back through the JAX package's ``convert_raft`` to the same
    variables bit for bit, and the reference-named state dict loads
    strictly (for WoContext, into the registry's model)."""
    v = _variables(2, **kw)
    sd = raft_state_dict_from_jax(v)
    nets = ("fnet",) if kw.get("no_separate_context") else ("fnet", "cnet")
    want = [f"{net}.conv{i}.0.{a}" for net in nets for i in (1, 2, 3)
            for a in ("weight", "bias")]
    if kw.get("no_separate_context"):
        want += ["conv_redir.weight", "conv_redir.bias"]
    assert sorted(k for k in sd if not k.startswith("update_block.")) == sorted(want)
    if kw == WOCONTEXT:
        model = fetch_model("RAFT_FlowNetCEncoder_WoContext", iters=1,
                            device="cpu").module
    else:
        model = RAFT(iters=1, **kw)
    model.load_state_dict(sd, strict=True)
    back = jconvert.convert_raft(
        jconvert.to_numpy_state_dict(model.state_dict()))
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_v = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    assert flat_b.keys() == flat_v.keys()
    for k in flat_v:
        np.testing.assert_array_equal(flat_b[k], flat_v[k])
