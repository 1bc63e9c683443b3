"""The PyTorch port's SPyNet against the JAX package's, on the CPU: the
forward in f32 on the same weights (JAX variables through the weight
bridge), the per-level weight files both ways, and the registry.

On the CPU the port's six warps run the plain version of the CUDA kernel
``csrc/warp_fwd.cu``; the JAX SpyNet takes its gather warp and plain convs
(its space-to-depth G-units are for TPUs only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu.models import convert as jconvert
from understanding_flow_robustness_tpu.models.spynet import SpyNet as JSpyNet
from understanding_flow_robustness_tpu_torch.models import (
    SpyNet,
    fetch_model,
    load_spynet_dir,
    predict_flow,
    spynet_state_dict_from_jax,
)

B, H, W = 2, 64, 128
# max |dflow| in px, f32 on both sides, all 6 levels.  Measured 3.7e-5 px at
# a mean |flow| of 3.3 px: conv sums in other orders, amplified through the
# pyramid (tests/test_model_parity.py:143-148 sees the same against the
# reference); the bar is 1e-3 px
FLOW_ATOL_PX = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_spynet():
    """JAX SpyNet variables with perturbed biases, its flows at train
    (every level) and eval, and the images."""
    module = JSpyNet(nlevels=6)
    v = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                             jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32)
        if x.ndim == 1 else x, v)
    a = rng.rand(B, H, W, 3).astype(np.float32)
    b = rng.rand(B, H, W, 3).astype(np.float32)
    levels = jax.jit(lambda vv, x, y: module.apply(vv, x, y, train=True))(
        v, jnp.asarray(a), jnp.asarray(b))
    return v, a, b, [np.asarray(f) for f in levels]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port(v):
    m = SpyNet()
    m.load_state_dict(spynet_state_dict_from_jax(v), strict=True)
    return m.eval()


def test_spynet_matches_jax_f32(jax_spynet):
    v, a, b, jlevels = jax_spynet
    m = _port(v)
    with torch.no_grad():
        levels = m(_nchw(a), _nchw(b), train=True)
        flow = m(_nchw(a), _nchw(b))
    assert len(levels) == 6 and tuple(flow.shape) == (B, 2, H, W)
    for got, ref in zip(levels, jlevels):
        assert tuple(got.shape) == (B, 2) + ref.shape[1:3]
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=0, atol=FLOW_ATOL_PX)
    torch.testing.assert_close(flow, levels[0], rtol=0, atol=0)
    assert np.abs(jlevels[0]).mean() > 0.5  # the flow is not trivially 0


def _write_level_files(sd, wdir):
    """The reference's per-level files (tests/test_model_parity.py:125-144):
    modelL{L}_F-{k}-{weight,bias}.pth.tar, levels and convs from 1."""
    for lvl in range(6):
        for k in range(5):
            for attr in ("weight", "bias"):
                torch.save(sd[f"moduleBasic.{lvl}.moduleBasic.{2 * k}.{attr}"],
                           wdir / f"modelL{lvl + 1}_F-{k + 1}-{attr}.pth.tar")


def test_weight_files_round_trip_bit_equal(jax_spynet, tmp_path):
    """JAX -> port -> the reference's per-level files -> the JAX package's
    ``convert_spynet_dir``: the same bits; the port's own loader reads the
    files back into the same state dict."""
    v = jax_spynet[0]
    sd = spynet_state_dict_from_jax(v)
    _write_level_files(sd, tmp_path)
    back = jconvert.convert_spynet_dir(str(tmp_path))
    flat = jax.tree_util.tree_leaves_with_path(v["params"])
    assert len(flat) == 60
    for path, leaf in flat:
        node = back["params"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
    loaded = load_spynet_dir(str(tmp_path))
    assert loaded.keys() == sd.keys()
    for k, t in sd.items():
        torch.testing.assert_close(loaded[k], t, rtol=0, atol=0)


def test_registry_spynet(jax_spynet, tmp_path):
    """``fetch_model("SpyNet", device="cpu")``: seeded, full-resolution NHWC
    flow from [0, 1] images; strict loading from the per-level files."""
    v, a, b, jlevels = jax_spynet
    model = fetch_model("SpyNet", device="cpu", seed=0)
    assert not model.is_raft and model.size_multiple == 32
    flow = predict_flow(model, torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(flow.shape) == (B, H, W, 2) and flow.dtype == torch.float32
    assert bool(torch.isfinite(flow).all())
    _write_level_files(spynet_state_dict_from_jax(v), tmp_path)
    loaded = fetch_model("SpyNet", pretrained_path=str(tmp_path),
                         device="cpu", seed=7)
    got = predict_flow(loaded, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), jlevels[0], rtol=0,
                               atol=FLOW_ATOL_PX)
