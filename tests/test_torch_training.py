"""The PyTorch port's training path against the JAX package, on the CPU:
losses, the learning-rate schedule, the RAFT train step (gradients, three
AdamW steps, batch-norm statistics, frozen batch norm, the NaN guard), the
trainer with resume and the train CLI.

Inputs come from a numpy seed and go to both packages; one set of JAX RAFT
variables (perturbed as in tests/test_torch_raft.py) goes through the weight
bridge into the port.  On the CPU the port's lookup and its gradient run the
plain versions of the CUDA kernels.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_workers as workers
from test_torch_raft import _perturb
from understanding_flow_robustness_tpu import training as jtraining
from understanding_flow_robustness_tpu.models import convert as jconvert
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu_torch.cli import train as cli_train
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    FlowModel,
    fetch_model,
    raft_state_dict_from_jax,
)
from understanding_flow_robustness_tpu_torch.training import (
    TrainConfig,
    checkpoint,
    fetch_optimizer,
    make_train_step,
    multiscale_epe,
    sequence_loss,
    train,
)

LOSS_TOL = 1e-5
LR = 1e-4
B, HW, ITERS = 2, 64, 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; with
    PyTorch's default of one thread per core in each, they mostly wait on
    one another (this file took 6x its time alone with six processes on
    eight cores).  Two threads each keep the cores busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("loss_name", ["sequence", "multiscale"])
@pytest.mark.parametrize("branch", ["raft", "flownetc", "pwc", "weighing",
                                    "div_flow"])
def test_losses_match_jax(loss_name, branch):
    rng = np.random.RandomState(0)
    H, W = 23, 31  # not divisible by the coarse scales: variable area bins
    gt = (rng.randn(2, H, W, 2) * 5).astype(np.float32)
    gt[0, 0, 0] = [300.0, 300.0]  # |gt| >= MAX_FLOW: excluded
    valid = (rng.rand(2, H, W) > 0.2).astype(np.float32)
    if branch == "raft":
        sizes = [(H, W)] * 3
    else:
        sizes = [(12, 16), (6, 8), (3, 4), (2, 2)]
    preds = [(rng.randn(2, h, w, 2) * 3).astype(np.float32) for h, w in sizes]
    preds[-1][0, 0, 0, 0] = np.nan  # the per-scale losses skip NaNs
    if branch == "raft":
        preds[-1][0, 0, 0, 0] = 0.0
    kw = {"flownetc": branch in ("flownetc", "weighing", "div_flow"),
          "pwc": branch == "pwc", "flownetc_weighing": branch == "weighing",
          "div_flow": 20.0 if branch == "div_flow" else 1.0, "gamma": 0.8}
    j_fn = (jtraining.sequence_loss if loss_name == "sequence"
            else jtraining.multiscale_epe)
    t_fn = sequence_loss if loss_name == "sequence" else multiscale_epe
    j_loss, j_met = j_fn([jnp.asarray(p) for p in preds], jnp.asarray(gt),
                         jnp.asarray(valid), **kw)
    t_loss, t_met = t_fn([_t(p) for p in preds], _t(gt), _t(valid), **kw)
    assert np.isfinite(float(t_loss))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert t_met.keys() == j_met.keys()
    for k in j_met:
        np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)


def test_schedule_matches_jax_onecycle():
    """fetch_optimizer's OneCycleLR against the JAX package's
    onecycle_linear, both for num_steps=100 (200 schedule steps): the LR
    before every update."""
    _, j_sched = jtraining.fetch_optimizer(lr=LR, num_steps=100)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = fetch_optimizer([p], lr=LR, num_steps=100)
    assert sched.total_steps == 200 and opt.param_groups[0]["clip"] == 1.0
    for step in range(199):
        got, ref = opt.param_groups[0]["lr"], float(j_sched(step))
        assert abs(got - ref) <= 1e-5 * ref, (step, got, ref)
        opt.step()
        sched.step()


# ------------------------------------------------------------ train step

def _batch(rng, nan=False):
    b = {"image1": rng.rand(B, HW, HW, 3).astype(np.float32),
         "image2": rng.rand(B, HW, HW, 3).astype(np.float32),
         "flow": (rng.randn(B, HW, HW, 2) * 4).astype(np.float32),
         "valid": (rng.rand(B, HW, HW) > 0.1).astype(np.float32)}
    if nan:
        b["flow"][0, 3, 5] = np.nan
    return b


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    jm = JRAFT(iters=ITERS, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
                         jnp.zeros((1, HW, HW, 3)))
    v = {"params": _perturb(v["params"], rng),
         "batch_stats": _perturb(v["batch_stats"], rng)}
    batches = [_batch(rng) for _ in range(3)]
    return jm, v, batches


def _port(variables):
    model = RAFT(iters=ITERS, mixed_precision=False)
    model.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    return model


def _tensors(batch):
    return {k: _t(v) for k, v in batch.items()}


def _flax(model, grads=False):
    """The port's parameters (or their .grad) and running statistics as a
    flax tree, through the JAX package's own converter."""
    by_id = {id(p): p.grad for p in model.parameters()} if grads else {}
    sd = {k: by_id.get(id(v), v).detach()
          for k, v in model.state_dict(keep_vars=True).items()}
    return jconvert.convert_raft(jconvert.to_numpy_state_dict(sd))


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_train_step_gradients_match_jax(setup):
    """One backward of the sequence loss, train-mode batch norm, f32 on both
    sides: every parameter gradient within 5e-3 relative L2 (+1e-6
    absolute) of jax.grad.  Most agree within 2e-5; fnet's full-resolution
    layers (conv1, layer1) differ by up to 2.5e-3, and there it is JAX's
    CPU gradient that strays: a float64 run of the port is 1.6e-5 from the
    port's f32 and 2.5e-3 from JAX's.  The absolute term covers the
    biases of the convolutions ahead of a norm, whose gradient is ~1e-8
    noise (the norm removes the bias).  The lookup's Function path and the
    plain lookup differentiated by autograd agree within 1e-5."""
    jm, v, batches = setup
    batch = batches[0]

    def j_loss(params):
        preds, _ = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            batch["image1"] * 255.0, batch["image2"] * 255.0,
                            train=True, test_mode=False,
                            mutable=["batch_stats"])
        return jtraining.sequence_loss(preds, batch["flow"],
                                       batch["valid"])[0]

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(v["params"])

    model = _port(v).train()
    tb = _tensors(batch)
    preds = model(tb["image1"].permute(0, 3, 1, 2) * 255.0,
                  tb["image2"].permute(0, 3, 1, 2) * 255.0, test_mode=False)
    assert len(preds) == ITERS and preds[0].shape == (B, 2, HW, HW)
    loss, _ = sequence_loss([p.permute(0, 2, 3, 1) for p in preds],
                            tb["flow"], tb["valid"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    got = _leaves(_flax(model, grads=True)["params"])
    ref = _leaves(j_grads)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        err = np.linalg.norm(got[k] - np.asarray(r))
        assert err <= 5e-3 * np.linalg.norm(r) + 1e-6, jax.tree_util.keystr(k)

    plain = _port(v).train()
    plain.plain_lookup = True
    preds = plain(tb["image1"].permute(0, 3, 1, 2) * 255.0,
                  tb["image2"].permute(0, 3, 1, 2) * 255.0, test_mode=False)
    sequence_loss([p.permute(0, 2, 3, 1) for p in preds], tb["flow"],
                  tb["valid"])[0].backward()
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        err = (p.grad - q.grad).norm()
        assert err <= 1e-5 * q.grad.norm() + 1e-6, name


def test_three_train_steps_match_jax(setup):
    """Three steps of make_train_step with fetch_optimizer against the JAX
    package's jitted step.  Loss per step within 1e-4 relative; batch-norm
    running statistics within 1e-5; parameters within 2 * (the sum of the
    three learning rates): AdamW's first steps move a weight by about lr
    whatever its gradient's size, so a near-zero gradient whose sign the
    two frameworks' summation orders flip can put its weight that far
    apart.  The update as a whole agrees within 1e-2 relative L2."""
    jm, v, batches = setup
    tx, j_sched = jtraining.fetch_optimizer(lr=LR, num_steps=10)
    j_step = jax.jit(jtraining.make_train_step(jm, tx, is_raft=True))
    params, stats, opt_state = v["params"], v["batch_stats"], None
    opt_state = tx.init(params)
    j_losses = []
    for batch in batches:
        params, opt_state, stats, m = j_step(
            params, opt_state, stats, {k: jnp.asarray(x) for k, x in batch.items()})
        j_losses.append(float(m["loss"]))

    model = _port(v)
    opt, sched = fetch_optimizer(model.parameters(), lr=LR, num_steps=10)
    step = make_train_step(model, opt, sched, is_raft=True)
    t_losses = [step(_tensors(b))["loss"] for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert sched.last_epoch == 3

    got = _flax(model)
    lr_sum = sum(float(j_sched(i)) for i in range(3))
    p0, pg, pj = (_leaves(t) for t in (v["params"], got["params"], params))
    num = den = 0.0
    for k in pj:
        a, b, z = np.asarray(pg[k]), np.asarray(pj[k]), np.asarray(p0[k])
        assert np.abs(a - b).max() <= 2 * lr_sum, jax.tree_util.keystr(k)
        num += np.sum(((a - z) - (b - z)) ** 2)
        den += np.sum((b - z) ** 2)
    assert np.sqrt(num / den) < 1e-2
    sg, sj = _leaves(got["batch_stats"]), _leaves(stats)
    assert sg.keys() == sj.keys()
    for k in sj:
        np.testing.assert_allclose(sg[k], np.asarray(sj[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=jax.tree_util.keystr(k))


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


def test_freeze_bn_keeps_running_statistics(setup):
    _, v, batches = setup
    model = _port(v)
    before = _stats(model)
    opt, sched = fetch_optimizer(model.parameters(), lr=LR, num_steps=10)
    step = make_train_step(model, opt, sched, is_raft=True, freeze_bn=True)
    assert np.isfinite(step(_tensors(batches[0]))["loss"])
    assert model.training and not model.cnet.norm1.training
    for k, t in _stats(model).items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="RAFT-only"):
        make_train_step(model, opt, sched, is_raft=False, freeze_bn=True)


def test_nan_loss_skips_the_update(setup):
    """A NaN in the ground truth gives a NaN loss: parameters, AdamW state
    and the schedule stay as they were; batch-norm statistics still move
    (JAX's new_stats on that step)."""
    _, v, batches = setup
    model = _port(v)
    opt, sched = fetch_optimizer(model.parameters(), lr=LR, num_steps=10)
    step = make_train_step(model, opt, sched, is_raft=True)
    step(_tensors(batches[0]))
    params = copy.deepcopy(list(model.parameters()))
    opt_state = copy.deepcopy(opt.state_dict())
    stats, epoch = _stats(model), sched.last_epoch
    metrics = step(_tensors(_batch(np.random.RandomState(7), nan=True)))
    assert np.isnan(metrics["loss"])
    for p, q in zip(model.parameters(), params):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        assert p.grad is None
    after = opt.state_dict()
    for i, s in opt_state["state"].items():
        for name, t in s.items():
            torch.testing.assert_close(after["state"][i][name], t, rtol=0,
                                       atol=0)
    assert sched.last_epoch == epoch
    assert any(not torch.equal(t, stats[k]) for k, t in _stats(model).items())


def test_single_prediction_is_wrapped_not_unpacked():
    """A model that returns one flow in train mode (FlowNet2's shape) trains
    on a one-element list: list() of the flow would unpack its batch
    dimension (the bug train_step.py:138-144 fixes)."""
    class Single(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(6, 2, 1)

        def forward(self, a, b, train=False):
            return self.conv(torch.cat([a, b], dim=1))

    torch.manual_seed(0)
    model = Single()
    tb = _tensors(_batch(np.random.RandomState(3)))
    with torch.no_grad():
        pred = model(tb["image1"].permute(0, 3, 1, 2),
                     tb["image2"].permute(0, 3, 1, 2))
    ref = float(sequence_loss([pred.permute(0, 2, 3, 1)], tb["flow"],
                              tb["valid"])[0])
    opt, sched = fetch_optimizer(model.parameters(), lr=LR, num_steps=10)
    step = make_train_step(model, opt, sched, is_raft=False)
    assert step(tb)["loss"] == pytest.approx(ref, rel=1e-6)


# --------------------------------------------------------- trainer and CLI

def _synthetic(n=2):
    def gen():
        rng = np.random.RandomState(0)
        for _ in range(n):
            yield _batch(rng)
    return gen


def test_train_loop_and_resume(tmp_path):
    """The JAX package's test_train_loop_and_resume: num_steps=3 takes 4
    batches (total_steps > num_steps stops it), and the resume from the
    final checkpoint returns at once."""
    model = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", iters=ITERS, seed=0,
                        device="cpu")
    cfg = TrainConfig(name="tiny", num_steps=3, val_freq=100, lr=LR,
                      checkpoint_dir=str(tmp_path / "ckpt"), seed=0,
                      add_noise=True)
    seen = []
    steps = train(cfg, model, _synthetic(), logger=lambda s, m: seen.append(m))
    assert steps == 4 and len(seen) == 4
    assert all(np.isfinite(m["loss"]) for m in seen)
    for f in ("args.json", "checkpoint.pth", "tiny.pth"):
        assert os.path.exists(tmp_path / "ckpt" / f), f
    assert checkpoint.restore_checkpoint(cfg.checkpoint_dir)["total_steps"] == 3

    fresh = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", iters=ITERS, seed=1,
                        device="cpu")
    again = []
    assert train(cfg, fresh, _synthetic(), logger=lambda s, m: again.append(m)) == 4
    assert again == []
    w = checkpoint.load_weights(str(tmp_path / "ckpt" / "tiny.pth"),
                                RAFT(iters=ITERS))
    for k, t in model.module.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(w.state_dict()[k], t)


@pytest.mark.parametrize("field,item", [("grad_transport", "A13"),
                                        ("n_devices", "A13")])
def test_trainer_refuses_unported_paths(tmp_path, field, item):
    """The two paths this test once saw refused (ROADMAP A13) run.

    ``grad_transport="bf16"`` on one device: the step's explicit mode, the
    gradients rounded to bf16 as JAX's one-device shard_map does; the
    first step's loss is the f32 run's and the weights stay within 3 lr of
    it a step (the JAX package's bar, tests/test_grad_transport.py).

    ``n_devices=2``: a library call launches two CPU ranks; the caller's
    model ends with rank 0's weights and the logger sees rank 0's metrics,
    those of the one-device run (f32, 1e-5; the weights within 2 lr a step,
    AdamW's sign flips); an argument that does not pickle is named."""
    def run(sub, **kw):
        model = fetch_model("RAFT", iters=ITERS, mixed_precision=False,
                            seed=0, device="cpu")
        cfg = TrainConfig(name="t", num_steps=1, batch_size=2, lr=LR,
                          val_freq=100, checkpoint_dir=str(tmp_path / sub),
                          seed=0, **kw)
        seen = []
        batches = functools.partial(workers.synthetic_batches, n=2)
        steps = train(cfg, model, batches,
                      logger=lambda s, m: seen.append(m))
        assert steps == 2 and len(seen) == 2
        assert os.path.exists(tmp_path / sub / "t.pth")
        return seen, model.module.state_dict()

    n = torch.get_num_threads()
    torch.set_num_threads(1)   # as each rank, so the sums agree
    try:
        ref, ref_state = run("f32")
    finally:
        torch.set_num_threads(n)
    if field == "grad_transport":
        got, state = run("bf16", grad_transport="bf16")
        np.testing.assert_allclose(got[0]["loss"], ref[0]["loss"],
                                   rtol=1e-6)
        bar = 3
    else:
        got, state = run("ranks", n_devices=2)
        for g, r in zip(got, ref):
            for k, x in r.items():
                np.testing.assert_allclose(g[k], x, rtol=1e-5, atol=1e-6,
                                           err_msg=k)
        bar = 2
        with pytest.raises(TypeError, match="'batches' does not pickle"):
            train(TrainConfig(n_devices=2, checkpoint_dir=str(tmp_path)),
                  FlowModel("RAFT", RAFT(iters=1), torch.device("cpu")),
                  lambda: iter(()))
    for k, x in ref_state.items():
        if x.is_floating_point():
            assert (state[k] - x).abs().max() <= bar * 2 * LR, k


def test_train_cli_synthetic(tmp_path):
    out = cli_train.main([
        "--synthetic", "2", "--num_steps", "1", "--batch_size", "1",
        "--image_size", "64", "64", "--iters", "2", "--name", "cli",
        "--model", "RAFT_adv_kitti2012_ifgsm_l2_002",
        "--checkpoint_dir", str(tmp_path), "--lr", "1e-4", "--device", "cpu"])
    assert out["total_steps"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["history"])
    assert os.path.exists(tmp_path / "cli" / "cli.pth")


# RAFT_FlowNetCEncoder_WoContext and --small train now
# (tests/test_torch_train_clis.py, test_torch_raft_variants.py)
@pytest.mark.parametrize("argv,item", [
    (["--n_devices", "2"], "A13"), ([], "A11")])
def test_train_cli_refuses_unported_paths(tmp_path, argv, item):
    if item == "A11":
        # the dataset stages are ported (tests/test_torch_train_clis.py):
        # with no dataset on disk the default stage raises reading it
        with pytest.raises(OSError):
            cli_train.main(argv + [
                "--checkpoint_dir", str(tmp_path), "--device", "cpu",
                "--data_roots", f'{{"chairs": "{tmp_path / "none"}"}}'])
        return
    # --n_devices 2 (ROADMAP A13) runs: two CPU ranks, rank 0's history
    out = cli_train.main(argv + [
        "--synthetic", "2", "--num_steps", "1", "--batch_size", "2",
        "--image_size", "64", "64", "--iters", "2", "--name", "dp",
        "--checkpoint_dir", str(tmp_path), "--lr", "1e-4", "--device",
        "cpu"])
    assert out["total_steps"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["history"])
    assert os.path.exists(tmp_path / "dp" / "dp.pth")
