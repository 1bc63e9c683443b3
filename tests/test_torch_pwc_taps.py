"""PWC-Net's feature taps in the PyTorch port against the JAX package's, on
the CPU: the keys and their order (JAX ``get_feature_map_keys``), every tap
in f32 and in the mixed precision configuration on the same weights (JAX
variables through the weight bridge), the NCHW layout, the reference's
``corr2`` quirk, and the registry's capture path.

On the CPU the port's warps and correlations run the plain versions of
their CUDA kernels; the JAX PWC-Net takes its gather warp and banded
einsums (tests/test_torch_pwcnet.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu.models.pwcnet import PWCNet as JPWCNet
from understanding_flow_robustness_tpu.models.registry import (
    get_feature_map_keys as jax_feature_map_keys,
)
from understanding_flow_robustness_tpu_torch.models import (
    PWCNet,
    fetch_model,
    get_feature_map_keys,
    predict_flow,
    predict_flow_with_features,
    pwcnet_state_dict_from_jax,
)

B, H, W = 2, 64, 128
# f32, per tap: max |port - JAX| / max |JAX|.  The flow's bar in
# tests/test_torch_pwcnet.py is 1e-4 px at a mean |flow| of 4.8 px; the
# taps are the same convolutions summed in other orders.  Measured: the
# worst tap 2.4e-6 (upfeat5)
F32_REL = 1e-4
# mixed precision, per tap: mean |port - JAX| / mean |JAX|.  Two bf16
# policies that round at other places: the flows part 0.55 % (the 1 % bar
# of tests/test_torch_pwcnet.py), the context network's taps, the last of
# the chain, most.  Measured: the worst tap 1.14e-2 (dc_conv4); the JAX
# package's own bar for its mixed PWC-Net against f32 is 1.75 %
# (tests/test_bf16_drift.py:58)
MIXED_REL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_taps():
    """JAX PWC-Net variables with perturbed biases, the images, and its
    (flow, taps) in f32 and in mixed precision."""
    v = jax.jit(JPWCNet().init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32)
        if x.ndim == 1 else x, v)
    a = rng.rand(B, H, W, 3).astype(np.float32)
    b = rng.rand(B, H, W, 3).astype(np.float32)
    out = {}
    for mixed in (False, True):
        m = JPWCNet(mixed_precision=mixed, return_features=True)
        flow, feats = jax.jit(m.apply)(v, jnp.asarray(a), jnp.asarray(b))
        out[mixed] = (np.asarray(flow, np.float32),
                      {k: np.asarray(t, np.float32) for k, t in feats.items()})
    return v, a, b, out


def _port(v, mixed):
    m = PWCNet(mixed_precision=mixed, return_features=True)
    m.load_state_dict(pwcnet_state_dict_from_jax(v, m.deconv2.state_dict()),
                      strict=True)
    return m.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", ["PWCNet", "PWCNet_adv_ifgsm_l2_002"])
def test_feature_map_keys_match_jax(name):
    """The keys and their order: the pyramids interleaved, levels 6..2,
    the context network, ``predict_flow2`` last (registry.py:332-347)."""
    keys = get_feature_map_keys(name)
    assert keys == jax_feature_map_keys(name) and len(keys) == 62
    assert keys[:2] == ["c11", "c21"] and keys[-1] == "predict_flow2"


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
def test_taps_match_jax(jax_taps, mixed):
    """Every tap against JAX's, NCHW against JAX's NHWC, in the JAX keys'
    order; the flow beside them; ``corr2`` is corr5 again in both."""
    v, a, b, out = jax_taps
    jflow, jfeats = out[mixed]
    with torch.no_grad():
        flow, feats = _port(v, mixed)(_nchw(a), _nchw(b))
    # (jit hands JAX's dict back with sorted keys)
    assert list(feats) == jax_feature_map_keys("PWCNet")
    assert set(feats) == set(jfeats)
    for k, ref in jfeats.items():
        got = feats[k].float().permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape, k
        if mixed:
            err = np.abs(got - ref).mean() / np.abs(ref).mean()
            assert err <= MIXED_REL, (k, err)
        else:
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err <= F32_REL, (k, err)
    assert feats["corr2"] is feats["corr5"]
    np.testing.assert_array_equal(jfeats["corr2"], jfeats["corr5"])
    assert feats["c11"].shape == (B, 16, H // 2, W // 2)
    got = flow.permute(0, 2, 3, 1).numpy()
    if not mixed:
        np.testing.assert_allclose(got, jflow, rtol=0, atol=1e-4)


def test_registry_capture_and_no_injection(jax_taps):
    """``fetch_model("PWCNet", return_features=True)`` through
    ``predict_flow_with_features``: the flow ``predict_flow`` serves and
    the taps; the taps are capture-only, so an injection raises as the
    JAX module's does (a TypeError on ``overrides``)."""
    _, a, b, _ = jax_taps
    model = fetch_model("PWCNet", device="cpu", seed=0, return_features=True)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    flow, feats = predict_flow_with_features(model, ta, tb)
    assert tuple(flow.shape) == (B, H, W, 2)
    assert list(feats) == get_feature_map_keys("PWCNet")
    assert feats["conv2_0"].dtype == torch.bfloat16
    assert feats["predict_flow2"].dtype == torch.float32
    torch.testing.assert_close(predict_flow(model, ta, tb), flow, rtol=0,
                               atol=0)
    with pytest.raises(TypeError, match="overrides"):
        predict_flow(model, ta, tb, overrides={"corr6": feats["corr6"]})
    # without return_features the module keeps no tap
    plain = fetch_model("PWCNet", device="cpu", seed=0)
    torch.testing.assert_close(predict_flow(plain, ta, tb), flow, rtol=0,
                               atol=0)
