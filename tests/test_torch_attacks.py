"""The PyTorch port's global attacks against the JAX package's, on the CPU.

Losses, the diverse-input transform and whole attacks run on the same
numpy inputs in both packages.  Whole attacks are compared on a toy flow
"model" (a smoothed image difference, as in tests/test_attacks.py:27-39)
with a target offset from its clean flow, so that no gradient sits near 0
and no sign can flip on a rounding difference.  Random draws (Gaussian,
uniform, diverse input) differ between ``jax.random`` and
``torch.Generator``, so those are checked by their laws and invariants.
The image gradient of the attack loss through RAFT and PWC-Net is held
against ``jax.grad`` on the same weights (the weight bridges of
tests/test_torch_raft.py and tests/test_torch_pwcnet.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from understanding_flow_robustness_tpu.attacks import global_attacks as jga
from understanding_flow_robustness_tpu.attacks import losses as jlosses
from understanding_flow_robustness_tpu.models.pwcnet import PWCNet as JPWCNet
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu_torch import attacks as tattacks
from understanding_flow_robustness_tpu_torch.attacks import global_attacks as tga
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    FlowModel,
    PWCNet,
    predict_flow_differentiable,
    pwcnet_state_dict_from_jax,
    raft_state_dict_from_jax,
)

LOSS_RTOL = 1e-5   # f32 sums in other orders
NOISE_ATOL = 1e-6  # the same f32 update arithmetic; no sign flips on the toy
# relative L2 of the image gradients, port vs jax.grad, f32 models: the
# same weights and inputs, summed in other orders through every conv's
# transpose (RAFT: 2 iterations, its lookup's plain backward; PWC-Net: the
# warp's gather transpose).  Measured on the CPU: RAFT 3.1e-4 and 1.8e-4,
# PWC-Net 1.0e-5 and 1.1e-5 (image 0 and image 1)
GRAD_REL_L2 = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _j(x):
    return jnp.asarray(np.array(x, np.float32))


# --- losses -----------------------------------------------------------------

def _loss_inputs(seed, valid, pred_size=(8, 12), nan=False):
    rng = np.random.RandomState(seed)
    gt = rng.randn(2, 16, 24, 3 if valid else 2).astype(np.float32) * 3
    if valid:
        gt[..., 2] = (rng.rand(2, 16, 24) > 0.3).astype(np.float32)
    if nan:
        gt[0, :3, :5, 0] = np.nan
    pred = rng.randn(2, *pred_size, 2).astype(np.float32) * 3
    return gt, pred


@pytest.mark.parametrize("valid", [True, False])
@pytest.mark.parametrize("name", ["compute_epe", "compute_cossim",
                                  "compute_l1"])
def test_eval_losses_match_jax(name, valid):
    gt, pred = _loss_inputs(0, valid)
    got = float(getattr(tattacks, name)(_t(gt), _t(pred)))
    ref = float(getattr(jlosses, name)(_j(gt), _j(pred)))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("valid", [True, False])
def test_compute_l1_nan_semantics_match_jax(valid):
    """The mean runs over the non-NaN elements only; all NaN gives NaN."""
    gt, pred = _loss_inputs(1, valid, pred_size=(16, 24), nan=True)
    got = float(tattacks.compute_l1(_t(gt), _t(pred)))
    ref = float(jlosses.compute_l1(_j(gt), _j(pred)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    gt[..., :2] = np.nan
    assert np.isnan(float(tattacks.compute_l1(_t(gt), _t(pred))))
    assert np.isnan(float(jlosses.compute_l1(_j(gt), _j(pred))))


def test_cosine_similarity_and_multiscale_match_jax():
    rng = np.random.RandomState(2)
    a = rng.randn(2, 5, 7, 2).astype(np.float32)
    b = rng.randn(2, 5, 7, 2).astype(np.float32)
    a[0, 0, 0] = 0.0  # the eps floor of the norm
    got = tattacks.cosine_similarity(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlosses.cosine_similarity(
        _j(a), _j(b))), rtol=LOSS_RTOL, atol=1e-7)
    assert got[0, 0, 0] == 0.0
    # torch's own cosine_similarity away from the eps floor
    np.testing.assert_allclose(got[1], F.cosine_similarity(
        _t(a[1]), _t(b[1]), dim=-1).numpy(), rtol=LOSS_RTOL)
    scales = [(a, b), (a[:, ::2, ::2], b[:, ::2, ::2])]
    got = float(tattacks.multiscale_cossim([_t(x) for x, _ in scales],
                                           [_t(y) for _, y in scales]))
    ref = float(jlosses.multiscale_cossim([_j(x) for x, _ in scales],
                                          [_j(y) for _, y in scales]))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("valid", [True, False])
@pytest.mark.parametrize("flow_loss", ["cossim", "l2", "l1"])
def test_flow_attack_loss_matches_jax(flow_loss, valid):
    gt, pred = _loss_inputs(3, valid, pred_size=(16, 24))
    got = float(tattacks.flow_attack_loss(_t(pred), _t(gt), flow_loss))
    ref = float(jlosses.flow_attack_loss(_j(pred), _j(gt), flow_loss))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    with pytest.raises(NotImplementedError):
        tattacks.flow_attack_loss(_t(pred), _t(gt), "corr")


# --- whole attacks on a toy flow model ----------------------------------------

def jax_toy(img1, img2):
    """tests/test_attacks.py:27-39: 5x the difference of the first two
    channels, smoothed by a 3x3 box filter."""
    d = (img1 - img2)[..., :2] * 5.0
    k = jnp.ones((3, 3, 1, 1), img1.dtype) / 9.0
    return jnp.concatenate([jax.lax.conv_general_dilated(
        d[..., c:c + 1], k, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) for c in range(2)], -1)


def torch_toy(img1, img2):
    d = ((img1 - img2)[..., :2] * 5.0).permute(0, 3, 1, 2)
    k = torch.ones((2, 1, 3, 3), dtype=img1.dtype) / 9.0
    return F.conv2d(d, k, padding=1, groups=2).permute(0, 2, 3, 1)


def _toy_case(seed, b=1):
    rng = np.random.RandomState(seed)
    img0 = rng.rand(b, 16, 24, 3).astype(np.float32)
    img1 = rng.rand(b, 16, 24, 3).astype(np.float32)
    flow = np.asarray(jax_toy(_j(img0), _j(img1)))
    gt = np.concatenate([flow + 1.0, np.ones_like(flow[..., :1])], -1)
    return img0, img1, gt


def _both(method, cfg_kw, img0, img1, gt):
    kw = dict(perturb_method=method, flow_loss="l2", output_norm=0.05,
              n_step=5, learning_rate=0.01, **cfg_kw)
    jn = jga.perturb(jax_toy, _j(img0), _j(img1), _j(gt),
                     jga.PerturbConfig(**kw), jax.random.PRNGKey(0))
    tn = tga.perturb(torch_toy, _t(img0), _t(img1), _t(gt),
                     tga.PerturbConfig(**kw))
    return [np.asarray(x) for x in jn], [x.numpy() for x in tn]


@pytest.mark.parametrize("mode", ["both", "left", "right"])
@pytest.mark.parametrize("method", ["fgsm", "ifgsm", "ifgm", "mifgsm",
                                    "mifgm"])
def test_toy_attacks_equal_jax(method, mode):
    img0, img1, gt = _toy_case(4)
    jres, tres = _both(method, {"perturb_mode": mode}, img0, img1, gt)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t, j, atol=NOISE_ATOL)
    n0, n1 = tres[:2]
    assert np.abs(n0).max() <= 0.05 + 1e-6 and np.abs(n1).max() <= 0.05 + 1e-6
    assert (np.abs(n0).max() > 0) == (mode != "right")
    assert (np.abs(n1).max() > 0) == (mode != "left")
    # the untargeted attack moves the flow away from the target
    before = float(tattacks.compute_epe(_t(gt), torch_toy(_t(img0), _t(img1))))
    after = float(tattacks.compute_epe(_t(gt), torch_toy(_t(tres[2]),
                                                         _t(tres[3]))))
    assert after > before


@pytest.mark.parametrize("method", ["fgsm", "ifgsm", "ifgm", "mifgsm",
                                    "mifgm"])
def test_toy_targeted_attacks_equal_jax(method):
    img0, img1, gt = _toy_case(5)
    jres, tres = _both(method, {"targeted": True}, img0, img1, gt)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t, j, atol=NOISE_ATOL)
    before = float(tattacks.compute_epe(_t(gt), torch_toy(_t(img0), _t(img1))))
    after = float(tattacks.compute_epe(_t(gt), torch_toy(_t(tres[2]),
                                                         _t(tres[3]))))
    assert after < before  # a targeted attack moves the flow to the target


def test_same_mode_is_accepted_and_raises():
    img0, img1, gt = _toy_case(6)
    cfg = tga.PerturbConfig(perturb_method="ifgsm", perturb_mode="same")
    with pytest.raises(ValueError, match="invalid perturbation mode"):
        tga.perturb(torch_toy, _t(img0), _t(img1), _t(gt), cfg)
    with pytest.raises(ValueError, match="invalid perturbation method"):
        tga.perturb(torch_toy, _t(img0), _t(img1), _t(gt),
                    tga.PerturbConfig(perturb_method="pgd"))


def test_mifgsm_batched_matches_per_sample():
    """The L1 normalisation is per sample: a batch of two gives each
    sample the noise it gets alone."""
    img0, img1, gt = _toy_case(7, b=2)
    cfg = tga.PerturbConfig(perturb_method="mifgsm", flow_loss="l2",
                            output_norm=0.05, n_step=4, learning_rate=0.01)
    n0b, n1b, _, _ = tga.perturb(torch_toy, _t(img0), _t(img1), _t(gt), cfg)
    for b in range(2):
        n0, n1, _, _ = tga.perturb(torch_toy, _t(img0[b:b + 1]),
                                   _t(img1[b:b + 1]), _t(gt[b:b + 1]), cfg)
        np.testing.assert_allclose(n0b[b].numpy(), n0[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(n1b[b].numpy(), n1[0].numpy(), atol=1e-6)


def test_trajectory_final_step_equals_perturb():
    img0, img1, gt = _toy_case(8)
    for method, steps in (("ifgsm", 5), ("mifgm", 5), ("fgsm", 1)):
        cfg = tga.PerturbConfig(perturb_method=method, flow_loss="l2",
                                output_norm=0.05, n_step=5,
                                learning_rate=0.01)
        outs, (tr0, tr1) = tga.perturb_trajectory(
            torch_toy, _t(img0), _t(img1), _t(gt), cfg)
        ref = tga.perturb(torch_toy, _t(img0), _t(img1), _t(gt), cfg)
        assert tuple(tr0.shape) == (steps,) + img0.shape == tuple(tr1.shape)
        for a, b in zip(outs, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(tr0[-1], outs[0], rtol=0, atol=0)


# --- the diverse-input transform --------------------------------------------

@pytest.mark.parametrize("nh,nw,top,left", [
    (16, 24, 0, 0),   # identity size
    (14, 22, 1, 2),
    (15, 21, 0, 3),
    (13, 23, 3, 0),
])
def test_apply_diverse_input_equals_jax(nh, nw, top, left):
    rng = np.random.RandomState(9)
    img0 = rng.rand(2, 16, 24, 3).astype(np.float32)
    img1 = rng.rand(2, 16, 24, 3).astype(np.float32)
    gt = rng.randn(2, 16, 24, 3).astype(np.float32)
    ref = jga.apply_diverse_input(_j(img0), _j(img1), _j(gt), nh, nw, top,
                                  left)
    got = tga.apply_diverse_input(_t(img0), _t(img1), _t(gt), nh, nw, top,
                                  left)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # outside the resized block the canvas is zero
    assert float(got[0][:, :top].abs().sum()) == 0
    assert float(got[0][:, top + nh:].abs().sum()) == 0
    assert float(got[2][:, :, left + nw:].abs().sum()) == 0


def test_diverse_input_draws_and_gradient():
    """p = 0 passes the inputs through; p = 1 always resizes within the
    reference's ranges; one generator seed gives one draw; the gradient
    reaches the pre-diversification images."""
    rng = np.random.RandomState(10)
    img0 = _t(rng.rand(1, 20, 30, 3))
    img1 = _t(rng.rand(1, 20, 30, 3))
    gt = _t(rng.randn(1, 20, 30, 3))
    gen = torch.Generator().manual_seed(0)
    out = tga.diverse_input(img0, img1, gt, gen, 0.0)
    assert all(a is b for a, b in zip(out, (img0, img1, gt)))
    sizes = set()
    for seed in range(20):
        d0, _, dgt = tga.diverse_input(img0, img1, gt,
                                       torch.Generator().manual_seed(seed),
                                       1.0)
        rows = int((d0.abs().sum((0, 2, 3)) > 0).sum())
        cols = int((d0.abs().sum((0, 1, 3)) > 0).sum())
        assert 18 <= rows <= 20 and 27 <= cols <= 30  # [H-H/10, H]
        sizes.add((rows, cols))
        again = tga.diverse_input(img0, img1, gt,
                                  torch.Generator().manual_seed(seed), 1.0)
        torch.testing.assert_close(again[0], d0, rtol=0, atol=0)
    assert len(sizes) > 3
    a = img0.clone().requires_grad_()
    d0, _, _ = tga.diverse_input(a, img1, gt,
                                 torch.Generator().manual_seed(1), 1.0)
    (g,) = torch.autograd.grad(d0.sum(), a)
    assert float(g.abs().sum()) > 0


def test_iterative_attack_with_diverse_input_is_reproducible():
    img0, img1, gt = _toy_case(11)
    cfg = tga.PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                            output_norm=0.05, n_step=4, learning_rate=0.01,
                            probability_diverse_input=0.5)
    runs = [tga.make_attack(torch_toy, cfg)(
        _t(img0), _t(img1), _t(gt), torch.Generator().manual_seed(s))
        for s in (3, 3, 4)]
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert float(runs[0][0].abs().max()) <= 0.05 + 1e-6


# --- noise methods ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["both", "left", "right"])
def test_noise_methods_laws_masks_and_generator(mode):
    img = torch.full((2, 32, 48, 3), 0.5)
    eps = 0.08
    for method in ("gaussian", "uniform", "none"):
        cfg = tga.PerturbConfig(perturb_method=method, output_norm=eps,
                                perturb_mode=mode)
        n0, n1, adv0, adv1 = tga.perturb(torch_toy, img, img, img, cfg,
                                         torch.Generator().manual_seed(0))
        assert n0.shape == img.shape and adv1.shape == img.shape
        assert float(adv0.min()) >= 0 and float(adv1.max()) <= 1
        if method == "none":
            assert float(n0.abs().max()) == 0 == float(n1.abs().max())
            continue
        live = n0 if mode != "right" else n1
        dead = n1 if mode == "both" else (n0 if mode == "right" else n1)
        assert float(live.abs().max()) > 0
        if mode != "both":
            assert float(dead.abs().max()) == 0
        if method == "uniform":  # U[-eps, eps): mean 0, std eps/sqrt(3)
            assert float(live.abs().max()) <= eps
            assert abs(float(live.std()) - eps / 3 ** 0.5) < 0.03 * eps
        else:  # N(0, (eps/4)^2), no clipping at 0.5 +- 4 sigma
            assert abs(float(live.std()) - eps / 4) < 0.03 * eps / 4
        assert abs(float(live.mean())) < 0.03 * eps
        again = tga.perturb(torch_toy, img, img, img, cfg,
                            torch.Generator().manual_seed(0))
        other = tga.perturb(torch_toy, img, img, img, cfg,
                            torch.Generator().manual_seed(1))
        torch.testing.assert_close(again[0], n0, rtol=0, atol=0)
        assert not torch.equal(other[0], n0) or mode == "right"
    with pytest.raises(ValueError, match="Generator"):
        tga.perturb(torch_toy, img, img, img,
                    tga.PerturbConfig(perturb_method="uniform"))


# --- image gradients through the models ----------------------------------------

def _attack_grads(jpredict, tpredict, a, b, seed):
    """The l2 attack loss's image gradients in both packages, against a
    target offset from the clean flow."""
    rng = np.random.RandomState(seed)
    flow = np.asarray(jpredict(_j(a), _j(b)))
    gt = np.concatenate([flow + rng.randn(*flow.shape).astype(np.float32),
                         np.ones_like(flow[..., :1])], -1)
    jg = jax.grad(lambda x, y: jlosses.flow_attack_loss(
        jpredict(x, y), _j(gt), "l2"), argnums=(0, 1))(_j(a), _j(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    loss = tattacks.flow_attack_loss(tpredict(ta, tb), _t(gt), "l2")
    tg = torch.autograd.grad(loss, (ta, tb))
    return [np.asarray(x) for x in jg], [x.numpy() for x in tg]


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_raft_image_gradient_matches_jax_grad():
    jm = JRAFT(iters=2, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    module = RAFT(iters=2, mixed_precision=False)
    module.load_state_dict(raft_state_dict_from_jax(v), strict=True)
    model = FlowModel("RAFT_adv_kitti2012_ifgsm_l2_002", module.eval(),
                      torch.device("cpu"))
    rng = np.random.RandomState(12)
    a = rng.rand(1, 64, 64, 3).astype(np.float32)
    b = rng.rand(1, 64, 64, 3).astype(np.float32)
    jpred = jax.jit(lambda x, y: jm.apply(v, x * 255.0, y * 255.0,
                                          test_mode=True)[1])
    jg, tg = _attack_grads(jpred, lambda x, y: predict_flow_differentiable(
        model, x, y), a, b, seed=13)
    for got, ref in zip(tg, jg):
        assert np.abs(ref).max() > 0
        assert _rel_l2(got, ref) < GRAD_REL_L2
    # the parameters stayed frozen only while the predict ran
    assert all(p.requires_grad for p in module.parameters())
    assert all(p.grad is None for p in module.parameters())


def test_pwcnet_image_gradient_matches_jax_grad():
    jm = JPWCNet(mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    module = PWCNet(mixed_precision=False)
    module.load_state_dict(pwcnet_state_dict_from_jax(
        v, module.deconv2.state_dict()), strict=True)
    model = FlowModel("PWCNet", module.eval(), torch.device("cpu"),
                      is_raft=False, size_multiple=64)
    rng = np.random.RandomState(14)
    a = rng.rand(1, 64, 128, 3).astype(np.float32)
    b = rng.rand(1, 64, 128, 3).astype(np.float32)
    jpred = jax.jit(lambda x, y: jm.apply(v, x, y))
    jg, tg = _attack_grads(jpred, lambda x, y: predict_flow_differentiable(
        model, x, y), a, b, seed=15)
    for got, ref in zip(tg, jg):
        assert np.abs(ref).max() > 0
        assert _rel_l2(got, ref) < GRAD_REL_L2


def test_perturb_config_defaults_match_jax():
    assert dataclasses.asdict(tga.PerturbConfig()) == dataclasses.asdict(
        jga.PerturbConfig())
    for k in ("PERTURB_METHOD", "PERTURB_MODE", "OUTPUT_NORM", "N_STEP",
              "LEARNING_RATE", "MOMENTUM"):
        assert getattr(tga, k) == getattr(jga, k)
