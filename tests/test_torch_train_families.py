"""Training of the families other than RAFT in the PyTorch port against the
JAX package, on the CPU: one train step of FlowNetS, FlowNetC (also with
batch norm), FlowNetCFlexLarger_k3_reps3, PWC-Net (f32 and mixed), SPyNet
and FlowNet2 -- the loss on the per-level flows, the parameter gradients,
the updated parameters and batch norm's running statistics.  The train
CLI on these families: tests/test_torch_train_family_clis.py.

JAX variables with perturbed biases go through each family's weight bridge
into the port; the same numpy batch goes to both packages.  On the CPU the
port's correlation and warp run the plain versions of their CUDA kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu import training as jtraining
from understanding_flow_robustness_tpu.models import flownet2 as jfn2
from understanding_flow_robustness_tpu.models import flownet_family as jfn
from understanding_flow_robustness_tpu.models.pwcnet import PWCNet as JPWCNet
from understanding_flow_robustness_tpu.models.spynet import SpyNet as JSpyNet
from understanding_flow_robustness_tpu_torch.models import (
    FlowNet2,
    FlowNetC,
    FlowNetCFlex,
    FlowNetS2,
    PWCNet,
    SpyNet,
    flownet2_state_dict_from_jax,
    flownet_c_flex_state_dict_from_jax,
    flownet_c_state_dict_from_jax,
    flownet_s_state_dict_from_jax,
    pwcnet_state_dict_from_jax,
    spynet_state_dict_from_jax,
)
from understanding_flow_robustness_tpu_torch.training import (
    fetch_optimizer,
    make_train_step,
)

B, H, W = 2, 64, 128
LR = 1e-4
# The bounds of tests/test_torch_training.py::test_train_step_gradients_
# match_jax: the loss within 1e-5 relative; each parameter's gradient, and
# all of them together, within 5e-3 relative L2 (+1e-6 absolute, the noise
# of a bias that a norm removes).  Measured: the loss <= 9.1e-7 apart, the
# worst tensor 3.2e-3 (FlowNetS), all together <= 1.1e-3.
LOSS_RTOL = 1e-5
GRAD_REL_L2, GRAD_ATOL = 5e-3, 1e-6
# FlowNet2's worst tensors (flownets_2's conv6, 3.2e-2; all together
# 6.2e-4) sit behind three chained warps whose gradient jumps where a
# sample coordinate crosses an integer: the bar of its image gradient
# (tests/test_torch_flownet2.py, chip_smoke.py's FLOWNET2_GRAD_REL_L2)
FLOWNET2_GRAD_REL_L2 = 5e-2
# After one AdamW step a weight moves by lr * g / (|g| + eps), about lr
# whatever its gradient's size, so a weight whose near-zero gradient the
# two frameworks' summation orders give opposite signs lands 2 lr (and an
# f32 rounding of the weight) apart: every weight within that, and the
# share of weights more than lr apart below 1e-4 (measured <= 5.1e-5,
# SpyNet).
FLIPPED_SHARE = 1e-4
# PWC-Net in mixed precision: two bf16 policies that round at other places
# (its flows part 0.55 % mean EPE / mean |flow|, tests/test_torch_pwcnet.
# py), carried through the backward.  Measured: the loss 6.5e-5 apart, all
# gradients together 2.5e-2 relative L2 (the worst tensor 0.16, deconv3's
# weight), 0.93 % of the weights more than lr apart after the step.  The
# bars: the loss 1e-3, the gradients together 5e-2, that share 2e-2; a
# wrong level or a missing scale is off by O(1).
MIXED_LOSS_RTOL = 1e-3
MIXED_GRAD_REL_L2 = 5e-2
MIXED_FLIPPED_SHARE = 2e-2

# name -> (JAX module, port module, bridge of a flax tree to port names,
#          the loss's pwc branch)
FAMILIES = {
    "FlowNetS": (lambda: jfn2.FlowNetS2(), lambda: FlowNetS2(),
                 flownet_s_state_dict_from_jax, False),
    "FlowNetC": (lambda: jfn.FlowNetC(div_flow=20.0),
                 lambda: FlowNetC(div_flow=20.0),
                 flownet_c_state_dict_from_jax, False),
    "FlowNetC_bn": (lambda: jfn.FlowNetC(batch_norm=True, div_flow=20.0),
                    lambda: FlowNetC(batch_norm=True, div_flow=20.0),
                    flownet_c_state_dict_from_jax, False),
    "FlowNetCFlexLarger_k3_reps3": (
        lambda: jfn.FlowNetCFlex(kernel_size=3, number_of_reps=3),
        lambda: FlowNetCFlex(3, 3), flownet_c_flex_state_dict_from_jax,
        False),
    "PWCNet": (lambda: JPWCNet(mixed_precision=True),
               lambda: PWCNet(mixed_precision=True), None, True),
    "PWCNet_f32": (lambda: JPWCNet(), lambda: PWCNet(), None, True),
    "SpyNet": (lambda: JSpyNet(nlevels=6), lambda: SpyNet(nlevels=6),
               spynet_state_dict_from_jax, False),
    "FlowNet2": (lambda: jfn2.FlowNet2(), lambda: FlowNet2(),
                 flownet2_state_dict_from_jax, False),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"image1": rng.rand(B, H, W, 3).astype(np.float32),
            "image2": rng.rand(B, H, W, 3).astype(np.float32),
            "flow": (rng.randn(B, H, W, 2) * 4).astype(np.float32),
            "valid": (rng.rand(B, H, W) > 0.1).astype(np.float32)}


def _bridge(name, port_module):
    bridge = FAMILIES[name][2]
    if bridge is not None:
        return bridge
    # PWC-Net's: the dead deconv2 comes from the port module
    return lambda tree: pwcnet_state_dict_from_jax(
        tree, port_module.deconv2.state_dict())


_JAX_STEPS = {}


def _jax_step(name, batch_seed=0):
    """``_jax_step_uncached`` once per (family, batch)."""
    key = (name, batch_seed)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _jax_step_uncached(name, _batch(batch_seed))
    return _JAX_STEPS[key]


def _jax_step_uncached(name, batch):
    """The JAX package's train step (make_train_step, is_raft=False,
    flownetc=True) on the family's perturbed variables: (variables before,
    after, the loss, the parameter gradients, the schedule's first lr)."""
    jm = FAMILIES[name][0]()
    pwc = FAMILIES[name][3]
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                         jnp.zeros((1, H, W, 3)))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32)
        if x.ndim == 1 else x, dict(v))
    stats = v.get("batch_stats", {})
    tx, sched = jtraining.fetch_optimizer(lr=LR, num_steps=10)
    step = jtraining.make_train_step(jm, tx, is_raft=False, flownetc=True,
                                     pwc=pwc)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss(params):
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
            preds, _ = jm.apply(variables, jb["image1"], jb["image2"],
                                train=True, mutable=["batch_stats"])
        else:
            preds = jm.apply(variables, jb["image1"], jb["image2"],
                             train=True)
        preds = list(preds) if isinstance(preds, (list, tuple)) else [preds]
        return jtraining.sequence_loss(preds, jb["flow"], jb["valid"],
                                       flownetc=True, pwc=pwc)[0]

    @jax.jit
    def run(params, opt_state, stats):
        new_params, _, new_stats, metrics = step(params, opt_state, stats, jb)
        return new_params, new_stats, metrics["loss"], jax.grad(loss)(params)

    # the step donates nothing here, but keep copies of what it read
    before = jax.tree_util.tree_map(lambda x: np.array(x, copy=True), v)
    new_params, new_stats, j_loss, grads = run(v["params"],
                                               tx.init(v["params"]), stats)
    after = {"params": new_params}
    if stats:
        after["batch_stats"] = new_stats
    return before, after, float(j_loss), grads, float(sched(0))


def _port_step(name, before, batch):
    """The port's make_train_step on the same variables: (module after the
    step, its loss, its gradients by name as the backward left them)."""
    module = FAMILIES[name][1]()
    module.load_state_dict(_bridge(name, module)(before), strict=True)
    opt, sched = fetch_optimizer(module.parameters(), lr=LR, num_steps=10)
    pwc = FAMILIES[name][3]
    step = make_train_step(module, opt, sched, is_raft=False, flownetc=True,
                           pwc=pwc)
    grads = {}
    real_clip = torch.nn.utils.clip_grad_norm_

    def record(params, clip):
        for n, p in module.named_parameters():
            if p.grad is not None:
                grads[n] = p.grad.detach().clone()
        return real_clip(params, clip)

    torch.nn.utils.clip_grad_norm_ = record
    try:
        metrics = step({k: torch.from_numpy(x) for k, x in batch.items()})
    finally:
        torch.nn.utils.clip_grad_norm_ = real_clip
    return module, metrics["loss"], grads


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_step_matches_jax(name):
    """One step of the port's make_train_step against the JAX package's
    on the same variables and batch: the loss, every parameter's gradient,
    the updated parameters and, with batch norm, the running statistics
    (JAX's new_stats)."""
    batch = _batch()
    before, after, j_loss, j_grads, lr0 = _jax_step(name)
    module, t_loss, t_grads = _port_step(name, before, batch)
    bridge = _bridge(name, module)
    mixed = name == "PWCNet"
    np.testing.assert_allclose(t_loss, j_loss,
                               rtol=MIXED_LOSS_RTOL if mixed else LOSS_RTOL)

    ref = {k: t.numpy() for k, t in bridge({"params": j_grads}).items()}
    assert set(t_grads) == {n for n, _ in module.named_parameters()} - (
        {"deconv2.weight", "deconv2.bias"} if "PWC" in name else set())
    tensor_bar = FLOWNET2_GRAD_REL_L2 if name == "FlowNet2" else GRAD_REL_L2
    num = den = 0.0
    for n, g in t_grads.items():
        g, r = g.numpy(), ref[n]
        num += np.sum((g - r) ** 2)
        den += np.sum(r ** 2)
        if not mixed:
            err = np.linalg.norm(g - r)
            assert err <= tensor_bar * np.linalg.norm(r) + GRAD_ATOL, n
    assert np.sqrt(num / den) < (MIXED_GRAD_REL_L2 if mixed else GRAD_REL_L2)

    got = module.state_dict()
    want = bridge(jax.tree_util.tree_map(np.asarray, after))
    start = bridge(before)
    flipped = total = 0
    for k, w in want.items():
        a, b, z = got[k].numpy(), w.numpy(), start[k].numpy()
        if "running" in k:  # batch norm's statistics: JAX's new_stats
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=k)
            assert not np.array_equal(a, z), k
            continue
        apart = np.abs(a - b) - np.spacing(np.abs(b))
        assert apart.max() <= 2 * lr0, k
        # the step moved it (PWC-Net's dead deconv2 has no gradient)
        assert k.startswith("deconv2.") or not np.array_equal(a, z), k
        flipped += int((apart > lr0).sum())
        total += a.size
    assert flipped <= (MIXED_FLIPPED_SHARE if mixed else FLIPPED_SHARE) * total
    assert any("running" in k for k in want) == (name == "FlowNetC_bn")


def test_non_raft_step_trains_on_the_per_level_flows():
    """The repair of the non-RAFT step: it calls the module with
    ``train=True``, as the JAX step does (train_step.py:126-127), so the
    loss weighs FlowNetS's five flows of levels 2..6; called without it
    the module gives its one upsampled inference flow and another loss."""
    batch = _batch()
    before, _, j_loss, _, _ = _jax_step("FlowNetS")
    module, t_loss, _ = _port_step("FlowNetS", before, batch)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    calls = []
    module.register_forward_hook(lambda m, args, kwargs, out: calls.append(
        (kwargs, out)), with_kwargs=True)
    _port_step_on(module, batch)
    (kwargs, out), = calls
    assert kwargs == {"train": True} and len(out) == 5
    assert [tuple(f.shape[2:]) for f in out] == [
        (H // 4, W // 4), (H // 8, W // 8), (H // 16, W // 16),
        (H // 32, W // 32), (H // 64, W // 64)]


def _port_step_on(module, batch):
    opt, sched = fetch_optimizer(module.parameters(), lr=LR, num_steps=10)
    step = make_train_step(module, opt, sched, is_raft=False, flownetc=True)
    return step({k: torch.from_numpy(x) for k, x in batch.items()})
