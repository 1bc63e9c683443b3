"""Parity of the PyTorch port's small RAFT with the JAX package's
``RAFT(small=True)``, on the CPU: its flows in f32 and in mixed precision,
the alt path against the volume path, its feature taps, one train step's
loss and gradients, and the weight bridge of its encoders.

JAX init variables (the FlowHead scaled by 0.05 to the calibrated operating
point) go through the weight bridge into the port; both run the same numpy
64x64 images for 2 iterations.  Small RAFT looks windows up at radius 3:
the port's lookups run the plain versions of their kernels on the CPU
(chip_smoke.py holds the kernels against them on the card at r = 3).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raft_variants import (
    FLOW_ATOL_PX,
    ITERS,
    MIXED_REL_EPE,
    TAP_REL_ATOL,
    _nhwc,
    _port,
    _rel_epe,
    _run_jax,
    _run_port,
    _variables,
)
from understanding_flow_robustness_tpu import training as jtraining
from understanding_flow_robustness_tpu.models import convert as jconvert
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    get_feature_map_keys,
    raft_state_dict_from_jax,
)
from understanding_flow_robustness_tpu_torch.models.raft_model import (
    SmallEncoder,
    SmallUpdateBlock,
)
from understanding_flow_robustness_tpu_torch.training import sequence_loss

SMALL = {"small": True}
B, HW = 2, 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_setup():
    rng = np.random.RandomState(20)
    imgs = [(rng.rand(1, HW, HW, 3) * 255).astype(np.float32)
            for _ in range(2)]
    return _variables(3, **SMALL), imgs


@pytest.fixture(scope="module")
def small_taps(small_setup):
    """JAX's f32 forward with its taps (its volume path) and the port's."""
    v, imgs = small_setup
    j_low, j_up, j_feats = _run_jax(v, imgs, mixed_precision=False,
                                    return_features=True, **SMALL)
    p_low, p_up, p_feats = _run_port(
        _port(v, return_features=True, **SMALL), imgs)
    return (np.asarray(j_low), np.asarray(j_up), j_feats), \
        (p_low, p_up, p_feats)


def test_small_modules():
    """The small configuration's modules and sizes (raft_model.py:762-770):
    hidden 96, context 64, radius 3, ``SmallEncoder`` fnet (128, instance)
    and cnet (160, no norm), ``SmallUpdateBlock`` without a mask head, and
    the registry passes ``small`` through."""
    model = fetch_model("RAFT", small=True, iters=1, device="cpu").module
    assert (model.hidden_dim, model.context_dim, model.corr_radius) == (
        96, 64, 3)
    assert isinstance(model.fnet, SmallEncoder)
    assert isinstance(model.cnet, SmallEncoder)
    assert isinstance(model.update_block, SmallUpdateBlock)
    assert model.fnet.conv2.out_channels == 128
    assert model.cnet.conv2.out_channels == 160
    assert model.update_block.encoder.convc1.in_channels == 4 * 7 ** 2
    assert not hasattr(model.update_block, "mask")
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in model.modules())


def test_small_f32_matches_jax(small_setup, small_taps):
    """The port's alt path and volume path against JAX in f32, 1e-3 px; the
    two paths agree with each other to summation order."""
    v, imgs = small_setup
    (j_low, j_up, _), (t_low, t_up, _) = small_taps
    alt_low, alt_up = _run_port(_port(v, **SMALL), imgs)
    vol_low, vol_up = _run_port(_port(v, corr_impl="volume", **SMALL), imgs)
    assert tuple(alt_up.shape) == (1, 2, HW, HW)
    for low, up in ((alt_low, alt_up), (vol_low, vol_up), (t_low, t_up)):
        assert np.abs(_nhwc(low) - j_low).max() < FLOW_ATOL_PX
        assert np.abs(_nhwc(up) - j_up).max() < FLOW_ATOL_PX
    assert np.abs(_nhwc(alt_up) - _nhwc(vol_up)).max() < FLOW_ATOL_PX
    # upflow8: the full-resolution flow is 8 x the bilinear upsample of the
    # low-resolution one, corners aligned
    np.testing.assert_allclose(_nhwc(alt_up)[0, 0, 0], 8 * _nhwc(alt_low)[0, 0, 0],
                               rtol=1e-6)


# bf16 drift of the configurations whose own JAX mixed run misses the 1 %
# bar (MIXED_REL_EPE) against JAX's f32 run: the port's mixed-precision
# flow is held to the JAX f32 flow at most this many times as far as the
# JAX package's own mixed-precision flow is.  Small RAFT's 128-channel bf16
# fmaps (and the spatial mode's) on random weights and noise images put
# JAX's mixed run 1.6 % (small RAFT, this test's inputs) to 5.1 % (other
# seeds) from its f32 run, and the port's and JAX's bf16 roundings are
# independent (measured on the CPU over five seeds: the port's drift 0.8-1.3
# x JAX's; the fnet in f32 alone halves it)
DRIFT_RATIO = 1.5


def assert_drift_within_jax(v, imgs, j_f32, kw, impls=("alt", "volume")):
    """RAFT(**kw)'s mixed-precision flow on each path within DRIFT_RATIO x
    JAX's own mixed-precision distance to JAX's f32 flow ``j_f32``."""
    _, j_mixed = _run_jax(v, imgs, mixed_precision=True, **kw)
    jax_drift = _rel_epe(np.asarray(j_mixed), j_f32)
    assert 0 < jax_drift < 10 * MIXED_REL_EPE
    for impl in impls:
        _, p_up = _run_port(_port(v, mixed_precision=True, corr_impl=impl,
                                  **kw), imgs)
        assert _rel_epe(_nhwc(p_up), j_f32) <= DRIFT_RATIO * jax_drift, impl


def test_small_mixed_within_drift_bar(small_setup, small_taps):
    """Mixed precision (the registry's RAFT default), on the alt and the
    volume path: its distance to JAX's f32 flow within DRIFT_RATIO x the
    distance of JAX's mixed-precision flow to it."""
    v, imgs = small_setup
    (_, j_f32, _), _ = small_taps
    assert_drift_within_jax(v, imgs, j_f32, SMALL)


def test_small_taps_match_jax(small_taps):
    """The taps hold the keys of ``get_feature_map_keys("RAFT")`` cut to the
    iterations that ran, and each equals JAX's (atol 1e-4 x its scale);
    ``cor1``, ``cor`` and ``cor_flo`` repeat the motion features, as in
    JAX (raft_model.py:468-470)."""
    (_, _, j_feats), (_, _, p_feats) = small_taps
    keys = get_feature_map_keys("RAFT")
    assert list(p_feats) == keys[:8 + 7 * ITERS]
    assert set(j_feats) == set(p_feats)
    for k, got in p_feats.items():
        ref = np.asarray(j_feats[k])
        if not k.startswith("corr_pyramid"):
            got = got.permute(0, 2, 3, 1)
        assert tuple(got.shape) == ref.shape, k
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=0,
            atol=TAP_REL_ATOL * max(1.0, np.abs(ref).max()), err_msg=k)
    for it in range(ITERS):
        mf = p_feats[f"motion_features_{it}"]
        assert mf.shape[1] == 82
        for k in ("cor1", "cor", "cor_flo"):
            assert p_feats[f"{k}_{it}"] is mf


# the biases of the instance-normed fnet's convolutions that feed a norm
# (every one but its output conv), as flax key paths
NORMED_BIAS = re.compile(r"\['fnet'\]\['(conv1|layer\d_\d'\]\['(conv\d|downsample))'\]"
                         r"\['bias'\]")


def train_step_matches_jax(kw, seed, hw=HW, grad_rel=5e-3):
    """One backward of the sequence loss of RAFT(**kw) in f32, train mode,
    on a numpy batch, against jax.grad of JAX's: the loss within 1e-5
    relative and every parameter gradient within ``grad_rel`` relative L2
    (+1e-6 absolute), as tests/test_torch_training.py holds RAFT's."""
    rng = np.random.RandomState(seed)
    # JAX on the CPU takes its volume path (its alt path is a Pallas kernel)
    jkw = {k: x for k, x in kw.items() if k != "corr_impl"}
    jm = JRAFT(iters=ITERS, mixed_precision=False, **jkw)
    v = jax.jit(JRAFT(iters=1, **jkw).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3)),
        jnp.zeros((1, hw, hw, 3)))
    batch = {"image1": rng.rand(B, hw, hw, 3).astype(np.float32),
             "image2": rng.rand(B, hw, hw, 3).astype(np.float32),
             "flow": (rng.randn(B, hw, hw, 2) * 4).astype(np.float32),
             "valid": (rng.rand(B, hw, hw) > 0.1).astype(np.float32)}
    stats = v.get("batch_stats", {})

    def j_loss(params):
        preds, _ = jm.apply({"params": params, "batch_stats": stats},
                            batch["image1"] * 255.0, batch["image2"] * 255.0,
                            train=True, test_mode=False,
                            mutable=["batch_stats"])
        return jtraining.sequence_loss(preds, batch["flow"],
                                       batch["valid"])[0]

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(v["params"])
    model = _port(v, mixed_precision=False, **kw).train()
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    preds = model(tb["image1"].permute(0, 3, 1, 2) * 255.0,
                  tb["image2"].permute(0, 3, 1, 2) * 255.0, test_mode=False)
    assert len(preds) == ITERS and tuple(preds[0].shape) == (B, 2, hw, hw)
    loss, _ = sequence_loss([p.permute(0, 2, 3, 1) for p in preds],
                            tb["flow"], tb["valid"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    by_id = {id(p): p.grad for p in model.parameters()}
    sd = {k: by_id.get(id(t), t).detach()
          for k, t in model.state_dict(keep_vars=True).items()}
    got = dict(jax.tree_util.tree_flatten_with_path(jconvert.convert_raft(
        jconvert.to_numpy_state_dict(sd))["params"])[0])
    ref = dict(jax.tree_util.tree_flatten_with_path(j_grads)[0])
    assert got.keys() == ref.keys()
    instance_fnet = (not kw.get("flownetc_encoder")
                     and kw.get("fnorm", "instance") == "instance")
    for k, r in ref.items():
        name = jax.tree_util.keystr(k)
        if instance_fnet and NORMED_BIAS.search(name):
            # an instance norm removes the bias: both gradients are noise
            assert max(np.linalg.norm(got[k]), np.linalg.norm(r)) <= 1e-5, \
                name
            continue
        err = np.linalg.norm(got[k] - np.asarray(r))
        assert err <= grad_rel * np.linalg.norm(r) + 1e-6, name


@pytest.mark.parametrize("impl", ["alt", "volume"])
def test_small_train_step_matches_jax(impl):
    """Small RAFT's train step: upflow8 predictions, no batch norm; the
    lookup's gradient at radius 3 through the plain backward (alt path) or
    the volume and its pyramid (volume path)."""
    train_step_matches_jax({**SMALL, "corr_impl": impl}, seed=21)


def test_small_weight_bridge():
    """The bridge maps the small encoders' bottleneck blocks (``conv3``;
    ``norm4`` as ``downsample.1`` where it has parameters) and the small
    update block; the port's state dict goes back through the JAX
    package's ``convert_raft`` to the same variables bit for bit."""
    v = _variables(4, **SMALL)
    sd = raft_state_dict_from_jax(v)
    assert "fnet.layer2.0.conv3.weight" in sd
    assert "fnet.layer2.0.downsample.0.weight" in sd
    assert "update_block.gru.convz.weight" in sd
    model = fetch_model("RAFT", small=True, iters=1, device="cpu").module
    model.load_state_dict(sd, strict=True)
    back = jconvert.convert_raft(
        jconvert.to_numpy_state_dict(model.state_dict()))
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_v = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    assert flat_b.keys() == flat_v.keys()
    for k in flat_v:
        np.testing.assert_array_equal(flat_b[k], flat_v[k])


def test_bottleneck_group_norm_bridge():
    """A bottleneck block whose norms carry parameters (group norm) maps
    its ``norm4`` to ``downsample.1`` too, and its ``norm3`` (the third
    conv's) to itself alone."""
    from understanding_flow_robustness_tpu.models.raft_model import (
        SmallEncoder as JSmallEncoder,
    )
    from understanding_flow_robustness_tpu_torch.models.convert import (
        raft_state_dict_from_jax as bridge,
    )

    v = jax.jit(JSmallEncoder(128, "group").init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(5)
    v = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.randn(*np.shape(x)).astype(np.float32),
        v)
    sd = bridge({"params": {"fnet": v["params"]}})
    sd = {k[len("fnet."):]: t for k, t in sd.items()}
    enc = SmallEncoder(128, "group")
    enc.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        sd["layer2.0.downsample.1.weight"].numpy(),
        np.asarray(v["params"]["layer2_0"]["norm4"]["scale"]))
    x = np.random.RandomState(6).rand(1, 32, 32, 3).astype(np.float32)
    ref = np.asarray(jax.jit(JSmallEncoder(128, "group").apply)(v, x))
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-4)
