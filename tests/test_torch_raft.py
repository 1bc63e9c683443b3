"""Parity of the PyTorch port's RAFT with the JAX package's, on the CPU.

One set of JAX ``RAFT`` init variables (biases, batch-norm parameters and
running statistics perturbed from a numpy seed, so that their mapping is
exercised) goes through the weight bridge into the port; both then run the
same numpy images.  On the CPU the JAX model takes its volume path, which is
value-equal to its on-demand lookup; the port runs the plain version of its
lookup kernel.
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
    upsample_flow_convex as j_upsample_flow_convex,
)
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    raft_state_dict_from_jax,
    scale_flow_head,
    upsample_flow_convex,
)

ITERS = 3
FLOW_ATOL_PX = 1e-3   # f32 vs f32 (tests/test_model_parity.py:194)
BF16_DRIFT_PCT = 5.0  # random-init mixed-precision drift bar (tests/test_bf16_drift.py:83)


def _perturb(tree, rng):
    """Norm scales and running variances, and the all-zero biases and
    running means, away from their init values, so that a wrong mapping of
    any of them cannot pass."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturb(v, rng)
        elif k in ("scale", "var"):
            out[k] = np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean") and np.shape(v) != () and np.all(np.asarray(v) == 0):
            out[k] = (0.1 * rng.randn(*np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    jm = JRAFT(iters=ITERS, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    v = {"params": _perturb(v["params"], rng),
         "batch_stats": _perturb(v["batch_stats"], rng)}
    imgs = [(rng.rand(1, 128, 128, 3) * 255).astype(np.float32) for _ in range(2)]
    return jm, v, imgs


def _port(variables, **kw):
    model = RAFT(iters=ITERS, **kw).eval()
    model.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    return model


def _run_port(model, imgs):
    a, b = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in imgs)
    with torch.inference_mode():
        low, up = model(a, b)
    return low.permute(0, 2, 3, 1).numpy(), up.permute(0, 2, 3, 1).numpy()


def _run_jax(jm, variables, imgs):
    low, up = jax.jit(lambda v, a, b: jm.apply(v, a, b, test_mode=True))(
        variables, *imgs)
    return np.asarray(low), np.asarray(up)


def test_weight_bridge_jax_to_port(setup):
    _, v, _ = setup
    sd = raft_state_dict_from_jax(v)
    model = _port(v)
    got = model.state_dict()
    for k, t in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    # the reference's layout: norm3 doubles as downsample.1, mask head is
    # mask.0 / mask.2 (models/convert.py:309-313, 328)
    blk = "cnet.layer2.0."
    np.testing.assert_array_equal(got[blk + "norm3.running_var"],
                                  got[blk + "downsample.1.running_var"])
    assert "update_block.mask.2.weight" in got
    w = v["params"]["fnet"]["conv1"]["kernel"]  # HWIO -> OIHW
    np.testing.assert_array_equal(got["fnet.conv1.weight"].numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))


def test_weight_bridge_port_to_jax(setup):
    """The port's state_dict through the JAX package's own converter gives
    back the same flax tree: the port's names are the reference's."""
    _, v, _ = setup
    back = jconvert.convert_raft(
        jconvert.to_numpy_state_dict(_port(v).state_dict()))
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_v = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    assert flat_b.keys() == flat_v.keys()
    for k in flat_v:
        np.testing.assert_array_equal(flat_b[k], flat_v[k])


@pytest.mark.parametrize("head_scale", [1.0, 0.05], ids=["raw", "calibrated"])
def test_raft_f32_matches_jax(setup, head_scale):
    jm, v, imgs = setup
    if head_scale != 1.0:
        v = j_scale_flow_head(v, head_scale)
    j_low, j_up = _run_jax(jm, v, imgs)
    p_low, p_up = _run_port(_port(v), imgs)
    assert p_up.shape == j_up.shape == (1, 128, 128, 2)
    assert np.abs(p_low - j_low).max() < FLOW_ATOL_PX
    assert np.abs(p_up - j_up).max() < FLOW_ATOL_PX


def test_raft_bf16_autocast_drift_against_jax_f32(setup):
    jm, v, imgs = setup
    _, j_up = _run_jax(jm, v, imgs)
    _, p_up = _run_port(_port(v, mixed_precision=True), imgs)
    d = np.sqrt(((p_up - j_up) ** 2).sum(-1))
    mag = np.sqrt((j_up ** 2).sum(-1))
    assert np.isfinite(p_up).all()
    assert 100.0 * d.mean() / mag.mean() < BF16_DRIFT_PCT


def test_upsample_flow_convex_matches_jax():
    rng = np.random.RandomState(4)
    flow = (rng.randn(2, 6, 10, 2) * 5).astype(np.float32)
    mask = rng.randn(2, 6, 10, 576).astype(np.float32)
    ref = np.asarray(j_upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask)))
    got = upsample_flow_convex(torch.from_numpy(flow).permute(0, 3, 1, 2),
                               torch.from_numpy(mask).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)


def test_scale_flow_head_copies_and_scales():
    model = RAFT(iters=1)
    w = model.update_block.flow_head.conv2.weight.detach().clone()
    scaled = scale_flow_head(model, 0.05)
    torch.testing.assert_close(model.update_block.flow_head.conv2.weight, w)
    torch.testing.assert_close(scaled.update_block.flow_head.conv2.weight, 0.05 * w)
