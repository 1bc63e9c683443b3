"""The PyTorch port's patch attack and universal perturbation against the
JAX package's, on the CPU.

Whole attacks run on the toy flow "model" of tests/test_attacks.py:27-39
(a smoothed image difference).  That model is antisymmetric in its two
frames, so the patch update ``g_tgt + g_ref`` is exactly 0 on it in both
packages: it pins that the gradient is taken to the two composited images
and summed.  To move the patch, the same toy also runs with the second
frame halved (``toy(a, 0.5 b)``).  Placement draws from the global
``np.random`` stream in both packages, so a seeded epoch places the patch
at the same spots.  FlowNetC runs on weights carried across by the bridge
of tests/test_torch_flownet.py at 64x128, against the JAX package's
``make_patch_attack_step(takes_variables=True)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from understanding_flow_robustness_tpu.attacks import patch as jpatch
from understanding_flow_robustness_tpu.attacks import patch_attack as jpa
from understanding_flow_robustness_tpu.attacks import universal as juni
from understanding_flow_robustness_tpu.models import flownet_family as jfn
from understanding_flow_robustness_tpu_torch import attacks as tattacks
from understanding_flow_robustness_tpu_torch.attacks import patch_attack as tpa
from understanding_flow_robustness_tpu_torch.attacks import universal as tuni
from understanding_flow_robustness_tpu_torch.models import (
    FlowModel,
    FlowNetC,
    flownet_c_state_dict_from_jax,
    predict_flow_differentiable,
)

# toy model: the same f32 elementwise arithmetic, the 3x3 box filter and
# its transpose summed in other orders (a few ulps of the images)
ATOL = 1e-6
# the loss: a mean of a few thousand f32 terms in another order, a few
# ulps of a loss up to ~4 (1e-6 abs alone is 4 ulps at 3.6)
LOSS_RTOL = 1e-6
# FlowNetC: the update multiplies the image gradients by 0.5 lr = 50
# before the +-2 clamp, so the packages' gradients, equal up to summation
# order through every convolution's transpose (~1e-6 of |g| on the CPU),
# differ by up to 50 |g| 1e-6 ~ 1e-4 where 50 |g| reaches the clamp.
# Measured: 1.5e-6 on the patch and images, 1.4e-7 relative on the loss
FLOWNETC_ATOL = 1e-4
FLOWNETC_LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jtoy(img1, img2):
    """tests/test_attacks.py:27-39."""
    d = (img1 - img2)[..., :2] * 5.0
    k = jnp.ones((3, 3, 1, 1), img1.dtype) / 9.0
    return jnp.concatenate([
        jax.lax.conv_general_dilated(
            d[..., c : c + 1], k, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        for c in range(2)], axis=-1)


def ttoy(img1, img2):
    d = ((img1 - img2)[..., :2] * 5.0).permute(0, 3, 1, 2)
    k = torch.ones((2, 1, 3, 3), dtype=img1.dtype) / 9.0
    return F.conv2d(d, k, padding=1, groups=2).permute(0, 2, 3, 1)


TOYS = {"antisymmetric": (jtoy, ttoy),
        "halved": (lambda a, b: jtoy(a, 0.5 * b),
                   lambda a, b: ttoy(a, 0.5 * b))}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=atol)


def _canvases(shape=(1, 32, 48, 3), seed=0):
    rng = np.random.RandomState(seed)
    tgt = rng.rand(*shape).astype(np.float32)
    ref = rng.rand(*shape).astype(np.float32)
    np.random.seed(seed)
    patch, mask, pshape = jpatch.init_patch_circle(32, 0.4)
    pc, mc, ic, _, _, _ = jpatch.circle_transform(
        patch, mask, patch.copy(), shape, pshape, margin=1, norotate=True)
    return [x.astype(np.float32) for x in (tgt, ref, pc, mc, ic)]


def _run_both(toy, cfg, arrays):
    jpred, tpred = TOYS[toy]
    target = -np.asarray(jpred(jnp.asarray(arrays[0]), jnp.asarray(arrays[1])))
    args = list(arrays) + [target]
    ref = jpa.make_patch_attack_step(jpred, cfg)(*map(jnp.asarray, args))
    got = tpa.make_patch_attack_step(
        tpred, tpa.PatchAttackConfig(**dataclasses.asdict(cfg)))(
            *map(torch.from_numpy, args))
    return got, ref


def _assert_attack_equal(got, ref, atol=ATOL, loss_rtol=LOSS_RTOL):
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r, atol)
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=loss_rtol,
                               atol=atol)
    assert got[4] == int(ref[4])


def test_patch_config_defaults_match_jax():
    assert dataclasses.asdict(tpa.PatchAttackConfig()) == \
        dataclasses.asdict(jpa.PatchAttackConfig())
    assert dataclasses.asdict(tuni.UniversalConfig()) == \
        dataclasses.asdict(juni.UniversalConfig())


# the antisymmetric toy runs l2 only: its flow is exactly 0 inside the
# patch (both frames hold the same patch there), where the cossim loss's
# gradient is NaN in the JAX package and 0 in the port
# (test_cossim_gradient_at_zero_flow_is_torchs)
@pytest.mark.parametrize("toy,l2", [("antisymmetric", True),
                                    ("halved", False), ("halved", True)])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_patch_attack_step_matches_jax_by_max_count(toy, l2, alpha):
    """threshold 0: both loops run max_count iterations."""
    arrays = _canvases()
    cfg = jpa.PatchAttackConfig(lr=100.0, alpha=alpha, max_count=4, l2=l2,
                                loss_threshold=0.0)
    got, ref = _run_both(toy, cfg, arrays)
    _assert_attack_equal(got, ref)
    assert got[4] == 4
    moved = np.abs(_np(ref[2]) - arrays[2]).max()
    assert (moved == 0) == (toy == "antisymmetric")
    # outside the mask the adversarial images are the clean ones
    outside = (1 - arrays[3]) * np.abs(_np(got[0]) - arrays[0])
    assert outside.max() == 0


@pytest.mark.parametrize("l2", [False, True])
def test_patch_attack_step_matches_jax_by_threshold(l2):
    """A threshold between the first two losses stops both loops after
    two iterations, returning the second loss (evaluated before the
    second update); a threshold above the first loss after one."""
    arrays = _canvases(seed=1)
    cfg = jpa.PatchAttackConfig(lr=100.0, max_count=1, l2=l2,
                                loss_threshold=0.0)
    first = float(_run_both("halved", cfg, arrays)[1][3])
    cfg = dataclasses.replace(cfg, max_count=2)
    second = float(_run_both("halved", cfg, arrays)[1][3])
    assert second < first
    for thr, count in (((first + second) / 2, 2), (first * 1.5, 1)):
        cfg = dataclasses.replace(cfg, max_count=10, loss_threshold=thr)
        got, ref = _run_both("halved", cfg, arrays)
        _assert_attack_equal(got, ref)
        assert got[4] == count
    cfg = dataclasses.replace(cfg, max_count=0)
    got, ref = _run_both("halved", cfg, arrays)
    _assert_attack_equal(got, ref)
    assert got[4] == 0 and float(got[3]) == np.inf


def test_cossim_gradient_at_zero_flow_is_torchs():
    """At an exactly zero flow vector the cossim loss's gradient is finite
    in the port (target / (eps |target|), 0 for a zero target), as in
    torch's own ``F.cosine_similarity`` (the reference's loss); the JAX
    package's ``jnp.linalg.norm`` adds 0 * inf = NaN there."""
    from understanding_flow_robustness_tpu.attacks import losses as jlosses

    flow = np.zeros((1, 2, 2, 2), np.float32)
    flow[0, 0, 0] = [1.0, 2.0]
    target = -flow + np.float32(0.5)
    x = torch.from_numpy(flow).requires_grad_()
    got = torch.autograd.grad(torch.mean(1.0 - tattacks.cosine_similarity(
        x, torch.from_numpy(target))), x)[0]
    y = torch.from_numpy(flow).requires_grad_()
    torch_ref = torch.autograd.grad(torch.mean(1.0 - F.cosine_similarity(
        y, torch.from_numpy(target), dim=-1)), y)[0]
    # F.cosine_similarity normalises in another order: a few ulps apart
    torch.testing.assert_close(got, torch_ref, rtol=1e-5, atol=0)
    assert bool(torch.isfinite(got).all())
    jgrad = np.asarray(jax.grad(lambda f: jnp.mean(1.0 - jlosses.cosine_similarity(
        f, jnp.asarray(target))))(jnp.asarray(flow)))
    assert np.isnan(jgrad[0, 1:]).all()
    np.testing.assert_allclose(jgrad[0, 0, 0], got[0, 0, 0].numpy(), rtol=1e-5)


def test_patch_attack_step_clamps_the_update():
    """lr = 1e6: every update inside the mask hits the +-2 clamp."""
    arrays = _canvases(seed=2)
    cfg = jpa.PatchAttackConfig(lr=1e6, max_count=3, l2=True,
                                loss_threshold=0.0)
    got, ref = _run_both("halved", cfg, arrays)
    _assert_attack_equal(got, ref)
    step = np.abs(_np(got[2]) - arrays[2])[arrays[3][..., 0] > 0]
    assert step.max() == pytest.approx(6.0)


def _epoch_batches(n=3, shape=(1, 40, 64, 3), seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shape).astype(np.float32),
             rng.rand(*shape).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("patch_type", ["circle", "square"])
def test_train_patch_epoch_and_validate_match_jax(patch_type):
    """Three seeded batches: placement, attack, extraction and re-zoom,
    then validation's placements and metrics."""
    jpred, tpred = TOYS["halved"]
    cfg = jpa.PatchAttackConfig(max_count=2, l2=True)
    batches = _epoch_batches()
    val = [(a, a, b, np.concatenate([np.zeros_like(a[..., :2]),
                                     np.ones_like(a[..., :1])], -1))
           for a, b in _epoch_batches(seed=4)]
    out = []
    for pkg, pred, step in (
            ("jax", jax.jit(jpred), jpa.make_patch_attack_step(jpred, cfg)),
            ("torch", tpred, tpa.make_patch_attack_step(
                tpred, tpa.PatchAttackConfig(**dataclasses.asdict(cfg))))):
        np.random.seed(5)
        if patch_type == "circle":
            patch, mask, shape = jpatch.init_patch_circle(40, 0.4)
        else:
            patch, shape = jpatch.init_patch_square(40, 0.4)
            mask = np.ones(shape, np.float32)
        losses = []
        kw = {} if pkg == "jax" else {"device": "cpu"}
        train = jpa.train_patch_epoch if pkg == "jax" else tpa.train_patch_epoch
        validate = jpa.validate_patch if pkg == "jax" else tpa.validate_patch
        res = train(step, pred, patch, mask, patch.copy(), shape, iter(batches),
                    patch_type=patch_type,
                    on_batch=lambda i, t, a, p, loss: losses.append(loss),
                    **kw)
        metrics = validate(pred, res[0], res[1], res[3], iter(val),
                           patch_type=patch_type, **kw)
        out.append((res, losses, metrics, np.random.random()))
    (rj, lj, mj, nj), (rt, lt, mt, nt) = out
    for g, r in zip(rt[:3], rj[:3]):
        _close(g, r)
    assert rt[3] == rj[3]
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL, atol=ATOL)
    assert list(mt) == list(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-6, atol=ATOL)
    assert mj["adv_epe"] != mj["epe"]
    assert nt == nj


# descent toward -flow runs l2 only: cossim's 1 - cos(f, -f) = 2 is its
# maximum, where the gradient is rounding noise whose sign the packages
# need not share; ascent (add_gaussian) runs both losses
UNIVERSAL_CASES = [(m, mode, False, "l2") for m in ("ifgsm", "ifgm", "mifgsm")
                   for mode in ("both", "left", "right")] + [
    (m, "both", True, loss) for m in ("ifgsm", "ifgm")
    for loss in ("l2", "cossim")]


@pytest.mark.parametrize("method,mode,add_gaussian,loss", UNIVERSAL_CASES)
def test_universal_trainer_matches_jax(tmp_path, method, mode, add_gaussian,
                                       loss):
    """Two epochs over three batches: the step, the accumulation across
    batches, the eps-ball and the per-epoch snapshots."""
    jpred, tpred = TOYS["halved"]
    shape = (1, 16, 24, 3)
    batches = lambda: iter(_epoch_batches(shape=shape, seed=6))  # noqa: E731
    cfg = juni.UniversalConfig(perturb_method=method, perturb_mode=mode,
                               output_norm=0.05, n_step=3, learning_rate=0.02,
                               flow_loss=loss, add_gaussian=add_gaussian)
    ref = juni.train_universal_perturbation(
        jax.jit(jpred), juni.make_universal_attack_step(jpred, cfg), batches,
        shape, cfg, epochs=2, save_dir=str(tmp_path / "j"),
        rng=np.random.RandomState(7))
    tcfg = tuni.UniversalConfig(**dataclasses.asdict(cfg))
    got = tuni.train_universal_perturbation(
        tpred, tuni.make_universal_attack_step(tpred, tcfg), batches, shape,
        tcfg, epochs=2, save_dir=str(tmp_path / "t"),
        rng=np.random.RandomState(7), device="cpu")
    for g, r in zip(got, ref):
        _close(g, r)
    for side, n in ((0, got[0]), (1, got[1])):
        frozen = (mode == "left" and side == 1) or (mode == "right"
                                                    and side == 0)
        assert (np.abs(n).max() == 0) == frozen
        assert np.abs(n).max() <= 0.05 + 1e-6
    for epoch in (0, 1):
        f = f"perturbations/epoch_{epoch}.npy"
        _close(np.load(tmp_path / "t" / f), np.load(tmp_path / "j" / f))
    assert np.load(tmp_path / "t" / "perturbations/epoch_1.npy").shape == \
        (1, 2) + shape[1:]


def test_universal_step_with_offset_target_matches_jax():
    """One step call with a cossim target offset from the clean flow (no
    gradient near 0): adversarial images and the noise pair."""
    jpred, tpred = TOYS["halved"]
    rng = np.random.RandomState(8)
    img0, img1 = (rng.rand(1, 16, 24, 3).astype(np.float32) for _ in range(2))
    n0, n1 = ((rng.rand(1, 16, 24, 3).astype(np.float32) - 0.5) * 0.02
              for _ in range(2))
    target = (np.asarray(jpred(jnp.asarray(img0), jnp.asarray(img1)))
              + rng.randn(1, 16, 24, 2).astype(np.float32))
    for method in ("ifgsm", "ifgm"):
        cfg = juni.UniversalConfig(perturb_method=method, n_step=4,
                                   learning_rate=0.01, flow_loss="cossim")
        args = (img0, img1, n0, n1, target)
        ref = juni.make_universal_attack_step(jpred, cfg)(
            *map(jnp.asarray, args))
        got = tuni.make_universal_attack_step(
            tpred, tuni.UniversalConfig(**dataclasses.asdict(cfg)))(
                *map(torch.from_numpy, args))
        for g, r in zip(got, ref):
            _close(g, r)


def test_universal_step_rejects_like_jax():
    for bad in ({"perturb_method": "fgsm"}, {"perturb_mode": "same"}):
        with pytest.raises((NotImplementedError, ValueError)):
            juni.make_universal_attack_step(jtoy, juni.UniversalConfig(**bad))
        with pytest.raises((NotImplementedError, ValueError)):
            tuni.make_universal_attack_step(ttoy, tuni.UniversalConfig(**bad))


def test_flownetc_patch_attack_matches_jax():
    """FlowNetC at 64x128 (one JAX jit): a 24x24 square mask, l2 loss,
    max_count 2, target = -clean flow; the gradients are large enough at
    this size that part of the update hits the clamp."""
    jm = jfn.FlowNetC()
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32)
        if x.ndim == 1 else x, v)
    m = FlowNetC()
    m.load_state_dict(flownet_c_state_dict_from_jax(v), strict=True)
    model = FlowModel("FlowNetC", m.eval(), torch.device("cpu"),
                      is_raft=False, size_multiple=64)
    rng = np.random.RandomState(9)
    tgt = rng.rand(1, 64, 128, 3).astype(np.float32)
    ref = rng.rand(1, 64, 128, 3).astype(np.float32)
    mask = np.zeros((1, 64, 128, 3), np.float32)
    mask[:, 16:40, 40:64] = 1
    patch = rng.rand(1, 64, 128, 3).astype(np.float32) * mask
    cfg = jpa.PatchAttackConfig(max_count=2, l2=True, loss_threshold=0.0)
    with torch.no_grad():
        target = -predict_flow_differentiable(
            model, torch.from_numpy(tgt), torch.from_numpy(ref)).numpy()
    args = (tgt, ref, patch, mask, patch, target)
    jres = jpa.make_patch_attack_step(
        lambda var, a, b: jm.apply(var, a, b), cfg, takes_variables=True)(
            *map(jnp.asarray, args), v)
    tres = tattacks.make_patch_attack_step(
        lambda a, b: predict_flow_differentiable(model, a, b),
        tpa.PatchAttackConfig(**dataclasses.asdict(cfg)))(
            *map(torch.from_numpy, args))
    _assert_attack_equal(tres, jres, atol=FLOWNETC_ATOL,
                         loss_rtol=FLOWNETC_LOSS_RTOL)
    update = np.abs(_np(jres[2]) - patch)
    assert update.max() > 2.0  # the clamp bound a first update
    assert np.abs(_np(tres[0]) - tgt)[mask == 0].max() == 0
    assert all(p.grad is None for p in m.parameters())
