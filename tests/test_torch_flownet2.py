"""The PyTorch port's FlowNet2 against the JAX package's, on the CPU: the
5-net cascade stage by stage, the partial stacks, the weight bridge's round
trip through ``convert_flownet2``, ``upsample_nearest``, an image gradient
of the l2 attack loss, the channel norm's gradient at an exact zero, and
the registry's "FlowNet2" through ``predict_flow``.

One set of JAX FlowNet2 variables (flax's init from a seed, biases moved
off zero) goes through the bridge into the port; the partial stacks take
their sub-networks from it.  Models run in f32 at full width, 64x128.  On
the CPU the port's warps and correlation run their plain versions (the
CUDA kernels are held against them in tests/test_torch_cuda.py and
chip_smoke.py).

The JAX models run under ``jit``.  FlowNet2's warps are all in border
mode, where the sample coordinate is x + u with no normalisation, so jit
changes none of its bits (the 2/(W-1) that XLA folds belongs to the
zeros_mask and spynet modes); the two packages part only by the order of
each convolution's sums, and the cascade carries that forward: each stage
warps by the previous stage's flow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu import ops as jops
from understanding_flow_robustness_tpu.attacks import losses as jlosses
from understanding_flow_robustness_tpu.models import convert as jconvert
from understanding_flow_robustness_tpu.models import flownet2 as jfn2
from understanding_flow_robustness_tpu_torch import attacks as tattacks
from understanding_flow_robustness_tpu_torch import ops as tops
from understanding_flow_robustness_tpu_torch.models import (
    NOT_PORTED,
    FlowModel,
    FlowNet2,
    FlowNet2CS,
    FlowNet2Single,
    fetch_model,
    flownet2_state_dict_from_jax,
    get_feature_map_keys,
    predict_flow,
    predict_flow_differentiable,
)

B, H, W = 2, 64, 128
STAGES = ("flownetc", "flownets_1", "flownets_2", "flownets_d")
# each stage's flow2 and the fused flow, relative L2.  Measured: FlowNetC
# 1.0e-6, S1 4.7e-6, S2 1.3e-5 (two warps downstream of FlowNetC), SD
# 1.7e-6 and the fused flow 1.2e-5: the drift grows along the chain of
# warps, as a sample coordinate that lies within the convolutions'
# difference of an integer takes the other floor
STAGE_REL_L2 = {"flownetc": 1e-5, "flownets_1": 5e-5, "flownets_2": 1e-4,
                "flownets_d": 1e-5, "fused": 1e-4}
# the partial stacks, relative L2: one or two warps at most
PARTIAL_REL_L2 = 5e-5
# the l2 attack loss's image gradient through FlowNet2, relative L2.  The
# gradient of a bilinear sample in its coordinate jumps where the
# coordinate crosses an integer, and four warps chain it: at these
# weights (mean |flow| 11.5 px) a 1e-6 relative change of the input moves
# the port's own f32 gradient by 2.3 % (measured), and the port's f32
# gradient is 2.0 % / 1.9 % from JAX's.  A missing or wrong path (the
# warp's flow gradient, a stage's input) is off by far more; the cosine
# to JAX's gradient is held too
GRAD_REL_L2 = 5e-2
GRAD_COSINE = 0.998


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _images(seed=0, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32))


@pytest.fixture(scope="module")
def built():
    """JAX FlowNet2 variables (biases moved off flax's zeros, so that a
    wrong mapping of any of them cannot pass) and the port's FlowNet2
    loaded from them through the bridge."""
    jm = jfn2.FlowNet2()
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32)
        if x.ndim == 1 else np.asarray(x), v)
    m = FlowNet2()
    m.load_state_dict(flownet2_state_dict_from_jax(v), strict=True)
    return jm, v, m.eval()


def test_flownet2_matches_jax_stage_by_stage(built):
    """Each sub-network's flow2 (FlowNetC, S1, S2, SD) and the fused
    full-resolution flow against the JAX cascade, on one batch."""
    jm, v, m = built
    a, b = _images(0)
    ref, state = jax.jit(lambda x, y: jm.apply(
        v, x, y, capture_intermediates=True))(a, b)
    flows = {}
    hooks = [getattr(m, n).register_forward_hook(
        lambda mod, i, o, n=n: flows.__setitem__(n, o[0])) for n in STAGES]
    try:
        with torch.no_grad():
            got = _nhwc(m(_nchw(a), _nchw(b)))
    finally:
        for h in hooks:
            h.remove()
    for name in STAGES:
        jflow = np.asarray(state["intermediates"][name]["__call__"][0][0])
        tflow = _nhwc(flows[name])
        assert tflow.shape == jflow.shape == (B, H // 4, W // 4, 2)
        assert _rel_l2(tflow, jflow) <= STAGE_REL_L2[name], name
    assert got.shape == (B, H, W, 2)
    assert _rel_l2(got, np.asarray(ref)) <= STAGE_REL_L2["fused"]
    # the plain switches change nothing on the CPU, where both are plain
    m.plain_warp = m.plain_corr = True
    try:
        with torch.no_grad():
            again = _nhwc(m(_nchw(a), _nchw(b)))
    finally:
        m.plain_warp = m.plain_corr = False
    np.testing.assert_array_equal(again, got)


# partial stacks: name -> (JAX module, port module, JAX sub-networks taken
# from FlowNet2's variables)
PARTIALS = {
    "CS": (lambda: jfn2.FlowNet2CS(stages=1), lambda: FlowNet2CS(stages=1),
           ("flownetc", "flownets_1")),
    "CSS": (lambda: jfn2.FlowNet2CS(stages=2), lambda: FlowNet2CS(stages=2),
            ("flownetc", "flownets_1", "flownets_2")),
    "C": (lambda: jfn2.FlowNet2Single(subnet="C"),
          lambda: FlowNet2Single("C"), ("flownetc",)),
    "S": (lambda: jfn2.FlowNet2Single(subnet="S"),
          lambda: FlowNet2Single("S"), None),
    "SD": (lambda: jfn2.FlowNet2Single(subnet="SD"),
           lambda: FlowNet2Single("SD"), ("flownets_d",)),
}


@pytest.mark.parametrize("name", list(PARTIALS))
def test_partial_stacks_match_jax(built, name):
    """FlowNet2CS (stages 1 and 2) and FlowNet2Single (C, S, SD) against
    the JAX package's, with their per-image RGB-mean normalisation.  The
    JAX partial stacks have only smoke tests against the reference
    (VERDICT.md Missing #4), so this proves agreement with the JAX package
    only; the full cascade above is the one held end to end."""
    _, fv, _ = built
    jfactory, tfactory, subs = PARTIALS[name]
    jm = jfactory()
    if subs is None:  # FlowNet2S's 6-channel net has no cascade twin
        v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)),
                             jnp.zeros((1, 64, 64, 3)))
        v = {"params": {"flownets": v["params"]["flownets"]}}
    else:
        v = {"params": {s: fv["params"][s] for s in subs}}
    m = tfactory()
    m.load_state_dict(flownet2_state_dict_from_jax(v), strict=True)
    a, b = _images(3)
    ref = np.asarray(jax.jit(jm.apply)(v, a, b))
    with torch.no_grad():
        got = _nhwc(m.eval()(_nchw(a), _nchw(b)))
    assert got.shape == ref.shape == (B, H, W, 2)
    assert _rel_l2(got, ref) <= PARTIAL_REL_L2
    m.return_features = True
    with torch.no_grad():
        flow, feats = m(_nchw(a), _nchw(b))
    assert feats == {} and tuple(flow.shape) == (B, 2, H, W)


def test_flownet2_bridge_round_trip(built):
    """The port's state dict through the JAX package's own converter
    (which raises on any unmapped key) gives back the JAX variables
    exactly, and the bridge gives back the state dict."""
    _, v, m = built
    sd = {k: t.detach() for k, t in m.state_dict().items()}
    back = jconvert.convert_flownet2(jconvert.to_numpy_state_dict(sd))
    assert back.keys() == {"params"}
    flat_v = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))
    again = flownet2_state_dict_from_jax(back)
    assert again.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(again[k], t), k
    for k in ("flownets_d.inter_conv5.0.weight",
              "flownetfusion.inter_conv0.0.bias",
              "flownetfusion.upsampled_flow1_to_0.weight",
              "flownetc.upsampled_flow6_to_5.bias"):
        assert k in sd, k
    assert not any(k.startswith("flownets_1.upsampled") and
                   k.endswith("bias") for k in sd)


@pytest.mark.parametrize("scale,shape", [(4, (2, 5, 7, 2)), (2, (1, 3, 4, 3))])
def test_upsample_nearest_matches_jax(scale, shape):
    x = np.random.RandomState(scale).randn(*shape).astype(np.float32)
    ref = np.asarray(jops.upsample_nearest(jnp.asarray(x), scale))
    got = _nhwc(tops.upsample_nearest(_nchw(x), scale))
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def jax_grad(built):
    """jax.grad of the l2 attack loss through the JAX FlowNet2, jitted
    once for every input of the one shape (batch 1)."""
    jm, v, _ = built
    return jax.jit(jax.grad(lambda x, y, g: jlosses.flow_attack_loss(
        jm.apply(v, x, y), g, "l2"), argnums=(0, 1)))


def _port_grad(m, a, b, gt):
    model = FlowModel("FlowNet2", m, torch.device("cpu"), is_raft=False,
                      size_multiple=64)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b.copy()).requires_grad_()
    loss = tattacks.flow_attack_loss(predict_flow_differentiable(
        model, ta, tb), torch.from_numpy(gt), "l2")
    return [g.numpy() for g in torch.autograd.grad(loss, (ta, tb))]


def test_flownet2_image_gradient_matches_jax_grad(built, jax_grad):
    """The attack loss's image gradient through FlowNet2 (four border
    warps on the plain sampler's autograd, the correlation's plain
    backward) against jax.grad, toward a target offset from the clean
    flow; the parameters stay frozen."""
    jm, v, m = built
    a, b = _images(9, b=1)
    flow = np.asarray(jax.jit(jm.apply)(v, a, b))
    rng = np.random.RandomState(10)
    gt = np.concatenate([flow + rng.randn(*flow.shape).astype(np.float32),
                         np.ones_like(flow[..., :1])], -1)
    jg = jax_grad(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gt))
    for got, ref in zip(_port_grad(m, a, b, gt), jg):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0 and np.isfinite(got).all()
        assert _rel_l2(got, ref) < GRAD_REL_L2
        cos = float(np.sum(got * ref) / np.linalg.norm(got)
                    / np.linalg.norm(ref))
        assert cos > GRAD_COSINE
    assert all(p.grad is None and p.requires_grad for p in m.parameters())


def test_channel_norm_gradient_at_zero_is_nan_as_in_jax(built, jax_grad):
    """The channel norm's gradient is NaN where its input is exactly zero
    (sqrt's 0 x inf), in jnp.sqrt and in the reference's ChannelNorm
    backward alike; the port adds no epsilon.  On identical frames the
    cascade's brightness error is exactly zero wherever a border warp
    clamps both coordinates (a corner whose flow points out of the image),
    and the NaN spreads, through the warp's clamp (``jnp.clip``'s
    multiplicative gradient), over the whole image gradient in both
    packages."""
    x = np.zeros((1, 2, 2, 3), np.float32)
    x[0, 0, 0] = [3.0, 4.0, 0.0]
    jg = np.asarray(jax.grad(lambda t: jops.channel_norm(t).sum())(
        jnp.asarray(x)))
    t = _nchw(x).requires_grad_()
    tops.channel_norm(t).sum().backward()
    got = _nhwc(t.grad)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jg))
    assert np.isnan(got[0, 1, 1]).all()
    np.testing.assert_allclose(got[0, 0, 0], [0.6, 0.8, 0.0], rtol=1e-6)

    jm, v, m = built
    a, _ = _images(11, b=1)
    gt = np.concatenate([np.zeros((1, H, W, 2), np.float32),
                         np.ones((1, H, W, 1), np.float32)], -1)
    jg = [np.asarray(g) for g in jax_grad(jnp.asarray(a), jnp.asarray(a),
                                          jnp.asarray(gt))]
    tg = _port_grad(m, a, a, gt)
    for got, ref in zip(tg, jg):
        assert np.isnan(ref).all()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))


def test_fetch_model_builds_flownet2():
    """The registry's last ID: FlowNet2 builds on the CPU when asked, f32,
    size multiple 64, no taps; it serves through ``predict_flow`` and
    ``return_features`` gives ``(flow, {})``."""
    assert NOT_PORTED == {}
    model = fetch_model("FlowNet2", device="cpu")
    assert type(model.module) is FlowNet2 and not model.is_raft
    assert model.size_multiple == 64 and not model.module.training
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    assert get_feature_map_keys("FlowNet2") == []
    a, b = (torch.from_numpy(x) for x in _images(4, b=1, h=64, w=64))
    flow = predict_flow(model, a, b)
    assert tuple(flow.shape) == (1, 64, 64, 2) and flow.dtype == torch.float32
    assert bool(torch.isfinite(flow).all())
    torch.testing.assert_close(model.predict(a, b), flow)
    model.module.return_features = True
    with torch.no_grad():
        out, taps = model.module(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))
    assert taps == {}
    torch.testing.assert_close(out.permute(0, 2, 3, 1), flow)
