"""The PyTorch port's FlowNet family against the JAX package's, on the CPU:
the spatial correlation (the plain version of ``csrc/spatial_corr_fwd.cu``)
and its gradient (the plain version of ``csrc/spatial_corr_bwd.cu``), the
channel norm, FlowNetC, FlowNetCFlex under both naming schemes,
FlowNetC_larger_field, FlowNetS2 (the registry's "FlowNetS") and FlowNetS
on weights carried through the bridge -- eval flows, ``train=True``
outputs, taps and ``overrides`` -- the bridge's round trip, the registry
and the image gradient of an attack on FlowNetC.

On the CPU the port's correlation runs its plain version (the CUDA kernels
are held against it in tests/test_torch_cuda.py); the JAX package runs its
banded einsums.  Models run in f32 at full width, batch 2 at 64x128.
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
from understanding_flow_robustness_tpu.models import flownet_family as jfn
from understanding_flow_robustness_tpu.models.registry import (
    get_feature_map_keys as jax_feature_map_keys,
)
from understanding_flow_robustness_tpu_torch import attacks as tattacks
from understanding_flow_robustness_tpu_torch import ops as tops
from understanding_flow_robustness_tpu_torch.models import (
    FLOWNET_IDS,
    NOT_PORTED,
    FlowModel,
    FlowNetC,
    FlowNetCFlex,
    FlowNetS,
    FlowNetS2,
    fetch_model,
    flownet_c_flex_state_dict_from_jax,
    flownet_c_state_dict_from_jax,
    flownet_s_state_dict_from_jax,
    get_feature_map_keys,
    predict_flow,
    predict_flow_differentiable,
)

B, H, W = 2, 64, 128
# the plain correlation against JAX's banded einsums, f32: the same
# products summed over C in another order; x max|ref|
CORR_REL_TOL = 1e-5
# its gradient, relative L2: sums over the displacements in other orders
CORR_GRAD_REL_L2 = 1e-5
# models, f32, relative L2 of flows and taps: the same weights and inputs,
# every convolution summed in another order
MODEL_REL_L2 = 1e-5
# the attack loss's image gradient, relative L2 (tests/test_torch_attacks.py)
GRAD_REL_L2 = 1e-3
TAPS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "corr",
        "conv_redir", "conv3_1")


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


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


# --- the spatial correlation -------------------------------------------------

CORR_CASES = [
    # (patch, dilation, (B, C, H, W)): FlowNetC's and PWC-Net's patches,
    # windows mostly inside, and a map smaller than the patch's reach; the
    # op's default patch 1 and patch 3, with more channels than the CUDA
    # kernel stages at a time
    (21, 2, (2, 16, 48, 64)), (9, 1, (2, 16, 48, 64)),
    (21, 2, (1, 8, 12, 14)), (9, 1, (1, 8, 3, 5)),
    (1, 1, (2, 40, 13, 37)), (3, 2, (2, 35, 19, 45))]


def _corr_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    b, c, h, w = shape
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32))


@pytest.mark.parametrize("patch,dil,shape", CORR_CASES)
def test_spatial_correlation_matches_jax(patch, dil, shape):
    f1, f2 = _corr_inputs(shape, seed=patch + shape[2])
    ref = np.asarray(jops.spatial_correlation(
        jnp.asarray(f1), jnp.asarray(f2), patch_size=patch,
        dilation_patch=dil))
    got = _nhwc(tops.spatial_correlation(_nchw(f1), _nchw(f2), patch,
                                         dilation_patch=dil))
    assert got.shape == ref.shape == shape[:1] + shape[2:] + (patch ** 2,)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=CORR_REL_TOL * np.abs(ref).max())
    # displacements that leave the map give exact zeros
    r, (h, w) = (patch - 1) // 2, shape[2:]
    for p in range(patch ** 2):
        du, dv = (p // patch - r) * dil, (p % patch - r) * dil
        if abs(du) >= h or abs(dv) >= w:
            assert not got[..., p].any()
    # bf16 in and out: f32 sums on both sides, one rounding each, so one
    # bf16 ulp apart; where a sum cancels to below the f32 bar above, the
    # f32 sums' own difference can be more ulps of that tiny value
    ref16 = np.asarray(jops.spatial_correlation(
        jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16),
        patch_size=patch, dilation_patch=dil).astype(jnp.float32))
    got16 = tops.spatial_correlation(_nchw(f1).bfloat16(),
                                     _nchw(f2).bfloat16(), patch,
                                     dilation_patch=dil)
    assert got16.dtype == torch.bfloat16
    bar = np.maximum(_bf16_ulp(ref16), CORR_REL_TOL * np.abs(ref16).max())
    assert (np.abs(_nhwc(got16) - ref16) <= bar).all()


@pytest.mark.parametrize("patch,dil,shape", CORR_CASES[:3])
def test_spatial_correlation_grad_matches_jax_vjp(patch, dil, shape):
    """The autograd of the plain version (the backward on the CPU) against
    jax.vjp of the JAX function, both feature maps."""
    f1, f2 = _corr_inputs(shape, seed=3)
    g = np.random.RandomState(4).randn(
        shape[0], shape[2], shape[3], patch ** 2).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jops.spatial_correlation(
        a, b, patch_size=patch, dilation_patch=dil), jnp.asarray(f1),
        jnp.asarray(f2))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    a = _nchw(f1).requires_grad_()
    b = _nchw(f2).requires_grad_()
    out = tops.spatial_correlation(a, b, patch, dilation_patch=dil)
    out.backward(_nchw(g))
    for got, r in zip((a.grad, b.grad), ref):
        assert np.abs(r).max() > 0
        assert _rel_l2(_nhwc(got), r) <= CORR_GRAD_REL_L2
    # one input alone, and a bf16 input gets a bf16 gradient
    a16 = _nchw(f1).bfloat16().requires_grad_()
    tops.spatial_correlation(a16, _nchw(f2).bfloat16(), patch,
                             dilation_patch=dil).float().sum().backward()
    assert a16.grad.dtype == torch.bfloat16


def test_spatial_correlation_refuses_the_general_path():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="kernel_size 1"):
        tops.spatial_correlation(x, x, 3, kernel_size=3)
    with pytest.raises(NotImplementedError, match="A7"):
        tops.spatial_correlation(x, x, 3, stride=2)


@pytest.mark.parametrize("patch,dil,fits", [
    (21, 2, True), (9, 1, True),       # the register-tiled kernels
    (155, 1, True), (157, 1, False),   # the generic forward's one channel
    (113, 2, True), (115, 2, False),   # of two buffers, at the limit
])
def test_spatial_corr_shared_memory_limit(patch, dil, fits):
    """The wrappers refuse exactly the patches whose blocks would need more
    than the H100's 232,448 bytes of shared memory, by the kernels' own
    count (``spatial_corr_smem_bytes``); one that fits passes that check
    and stops at the device check (these tensors lie on the CPU)."""
    from understanding_flow_robustness_tpu_torch.ops import correlation as tcorr

    assert (max(tcorr.spatial_corr_smem_bytes(patch, dil)) <= 232448) == fits
    x = torch.zeros(1, 2, 4, 4)
    match = "CUDA device" if fits else "shared memory"
    with pytest.raises(ValueError, match=match):
        tcorr._check_spatial_args("spatial_corr_fwd", x, x, patch, dil)


def test_channel_norm_matches_jax():
    x = np.random.RandomState(5).randn(2, 6, 7, 3).astype(np.float32)
    ref = np.asarray(jops.channel_norm(jnp.asarray(x)))
    got = _nhwc(tops.channel_norm(_nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert tops.channel_norm(_nchw(x).bfloat16()).dtype == torch.bfloat16


# --- the models -------------------------------------------------------------

# name -> (JAX module kwargs and class, port module factory, bridge)
MODELS = {
    "FlowNetC": (jfn.FlowNetC, {},
                 lambda **kw: FlowNetC(**kw), flownet_c_state_dict_from_jax),
    "k3_reps3": (jfn.FlowNetCFlex, {"kernel_size": 3, "number_of_reps": 3},
                 lambda **kw: FlowNetCFlex(3, 3, **kw),
                 flownet_c_flex_state_dict_from_jax),
    "k5_reps0": (jfn.FlowNetCFlex, {"kernel_size": 5, "number_of_reps": 0,
                                    "flat_entry_names": True},
                 lambda **kw: FlowNetCFlex(5, 0, stage_names="flat", **kw),
                 lambda v: flownet_c_flex_state_dict_from_jax(v, "flat")),
    "larger_field": (jfn.FlowNetCFlex, {"kernel_size": 5,
                                        "number_of_reps": 1},
                     lambda **kw: FlowNetCFlex(5, 1,
                                               stage_names="larger_field",
                                               **kw),
                     lambda v: flownet_c_flex_state_dict_from_jax(
                         v, "larger_field")),
    "FlowNetS2": (jfn2.FlowNetS2, {}, lambda **kw: FlowNetS2(**kw),
                  flownet_s_state_dict_from_jax),
    "FlowNetS": (jfn.FlowNetS, {}, lambda **kw: FlowNetS(**kw),
                 flownet_c_state_dict_from_jax),
}
FLOWNETC_FAMILY = ("FlowNetC", "k3_reps3", "k5_reps0", "larger_field")


def _images(seed=0, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32))


@pytest.fixture(scope="module")
def built():
    """Per model: JAX variables with perturbed biases (flax initialises
    them to zero), the port module loaded from them through the bridge,
    and the images."""
    cache = {}

    def get(name):
        if name not in cache:
            jcls, jkw, port, bridge = MODELS[name]
            jm = jcls(**jkw)
            v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3)),
                                 jnp.zeros((1, 64, 64, 3)))
            rng = np.random.RandomState(1)
            v = jax.tree_util.tree_map(
                lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32)
                if x.ndim == 1 else x, v)
            m = port()
            m.load_state_dict(bridge(v), strict=True)
            cache[name] = (jcls, jkw, v, m.eval())
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(built, name):
    """Eval flow and train=True outputs against the JAX module on the same
    weights and images."""
    jcls, jkw, v, m = built(name)
    a, b = _images()
    ref = np.asarray(jax.jit(jcls(**jkw).apply)(v, a, b))
    with torch.no_grad():
        got = _nhwc(m(_nchw(a), _nchw(b)))
        train = [_nhwc(f) for f in m(_nchw(a), _nchw(b), train=True)]
    quarter = name == "FlowNetS"  # 5 x flow2 at H/4 x W/4
    assert got.shape == ((B, H // 4, W // 4, 2) if quarter else (B, H, W, 2))
    assert _rel_l2(got, ref) <= MODEL_REL_L2
    jtrain = jax.jit(lambda v, a, b: jcls(**jkw).apply(v, a, b, train=True))(
        v, a, b)
    assert len(train) == len(jtrain) == 5
    for lvl, (t, j) in enumerate(zip(train, jtrain)):
        j = np.asarray(j)
        assert t.shape == j.shape, lvl
        assert _rel_l2(t, j) <= MODEL_REL_L2, lvl


@pytest.mark.parametrize("name", FLOWNETC_FAMILY)
def test_taps_match_jax(built, name):
    jcls, jkw, v, m = built(name)
    a, b = _images(2)
    jflow, jfeats = jax.jit(jcls(return_features=True, **jkw).apply)(v, a, b)
    m.return_features = True
    try:
        with torch.no_grad():
            flow, feats = m(_nchw(a), _nchw(b))
    finally:
        m.return_features = False
    assert set(feats) == set(jfeats) == set(TAPS)
    assert _rel_l2(_nhwc(flow), np.asarray(jflow)) <= MODEL_REL_L2
    for k in TAPS:
        ref = np.asarray(jfeats[k])
        assert _nhwc(feats[k]).shape == ref.shape, k
        assert _rel_l2(_nhwc(feats[k]), ref) <= MODEL_REL_L2, k


OVERRIDES = [("conv3a", "conv3b"), ("conv3a",), ("corr",), ("conv_redir",),
             ("conv3_1",)]


@pytest.mark.parametrize("keys", OVERRIDES, ids="+".join)
def test_overrides_match_jax(built, keys):
    """Each injection point of FlowNetC (the flexible variant shares the
    port's forward; k3_reps3 is checked on corr), through ``predict_flow``:
    conv3a/conv3b only as a pair, a singleton conv3a is a no-op."""
    for name in ("FlowNetC",) + (("k3_reps3",) if keys == ("corr",) else ()):
        jcls, jkw, v, m = built(name)
        a, b = _images(3)
        _, jfeats = jax.jit(jcls(return_features=True, **jkw).apply)(v, a, b)
        rng = np.random.RandomState(6)
        ov = {k: rng.randn(*np.asarray(jfeats[k]).shape).astype(np.float32)
              for k in keys}
        ref = np.asarray(jax.jit(lambda v, a, b, o: jcls(**jkw).apply(
            v, a, b, overrides=o))(v, a, b, ov))
        model = FlowModel(name, m, torch.device("cpu"), is_raft=False,
                          size_multiple=64)
        got = predict_flow(model, torch.from_numpy(a), torch.from_numpy(b),
                           overrides={k: _nchw(x) for k, x in ov.items()})
        assert _rel_l2(got.numpy(), ref) <= MODEL_REL_L2
        clean = predict_flow(model, torch.from_numpy(a), torch.from_numpy(b))
        moved = _rel_l2(got.numpy(), clean.numpy())
        assert (moved == 0) if keys == ("conv3a",) else moved > 1e-3


# --- the bridge and the registry -------------------------------------------

ROUND_TRIPS = [
    ("FlowNetC", lambda: FlowNetC(), jconvert.convert_flownet_c,
     flownet_c_state_dict_from_jax),
    ("FlowNetC_bn", lambda: FlowNetC(batch_norm=True),
     jconvert.convert_flownet_c, flownet_c_state_dict_from_jax),
    ("k3_reps3", lambda: FlowNetCFlex(3, 3), jconvert.convert_flownet_c_flex,
     flownet_c_flex_state_dict_from_jax),
    ("k5_reps0", lambda: FlowNetCFlex(5, 0, stage_names="flat"),
     jconvert.convert_flownet_c_flex,
     lambda v: flownet_c_flex_state_dict_from_jax(v, "flat")),
    ("flat_reps2", lambda: FlowNetCFlex(3, 2, stage_names="flat"),
     jconvert.convert_flownet_c_flex,
     lambda v: flownet_c_flex_state_dict_from_jax(v, "flat")),
    ("larger_field", lambda: FlowNetCFlex(5, 1, stage_names="larger_field"),
     jconvert.convert_flownet_c_larger,
     lambda v: flownet_c_flex_state_dict_from_jax(v, "larger_field")),
    ("FlowNetS2", lambda: FlowNetS2(), jconvert.convert_flownet_s,
     flownet_s_state_dict_from_jax),
]


@pytest.mark.parametrize("name,port,to_jax,from_jax", ROUND_TRIPS,
                         ids=[c[0] for c in ROUND_TRIPS])
def test_bridge_round_trip_is_bit_equal(name, port, to_jax, from_jax):
    """Port state_dict (seeded, with random biases and batch-norm
    statistics) -> the JAX package's converter -> back: bit-equal."""
    from understanding_flow_robustness_tpu_torch.models.layers import (
        init_like_flax,
    )

    m = port()
    init_like_flax(m, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    sd = {k: (v + torch.rand(v.shape, generator=g) if v.dim() == 1 else v)
          for k, v in m.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    back = from_jax(to_jax({k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", FLOWNET_IDS)
def test_fetch_model_builds_flownet_ids(name):
    """The six FlowNet-family IDs build on the CPU, f32, size multiple 64,
    and serve 64x64 frames; their taps are the JAX registry's."""
    model = fetch_model(name, device="cpu")
    assert not model.is_raft and model.size_multiple == 64
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    a, b = (torch.from_numpy(x) for x in _images(4, b=1, h=64, w=64))
    flow = predict_flow(model, a, b)
    assert tuple(flow.shape) == (1, 64, 64, 2)
    assert bool(torch.isfinite(flow).all())
    assert get_feature_map_keys(name) == jax_feature_map_keys(name)
    expect = {"FlowNetC": (FlowNetC, 20.0), "FlowNetS": (FlowNetS2, None)}
    cls, div = expect.get(name, (FlowNetCFlex, 1.0))
    assert type(model.module) is cls
    if div is not None:
        assert model.module.div_flow == div
    assert NOT_PORTED == {}


def test_flownetc_image_gradient_matches_jax_grad(built):
    """The attack loss's image gradient through FlowNetC (the correlation's
    plain backward on the CPU) against jax.grad of the JAX model."""
    jcls, jkw, v, m = built("FlowNetC")
    model = FlowModel("FlowNetC", m, torch.device("cpu"), is_raft=False,
                      size_multiple=64)
    a, b = _images(9, b=1)
    jpred = jax.jit(lambda x, y: jcls(**jkw).apply(v, x, y))
    rng = np.random.RandomState(10)
    flow = np.asarray(jpred(a, b))
    gt = np.concatenate([flow + rng.randn(*flow.shape).astype(np.float32),
                         np.ones_like(flow[..., :1])], -1)
    jg = jax.grad(lambda x, y: jlosses.flow_attack_loss(
        jpred(x, y), jnp.asarray(gt), "l2"), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    loss = tattacks.flow_attack_loss(predict_flow_differentiable(
        model, ta, tb), torch.from_numpy(gt), "l2")
    tg = torch.autograd.grad(loss, (ta, tb))
    for got, ref in zip(tg, jg):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        assert _rel_l2(got.numpy(), ref) < GRAD_REL_L2
    assert all(p.grad is None for p in m.parameters())
