"""The PyTorch port's adversarial training against the JAX package's, on the
CPU: RAFT (f32, 64x64, 2 iterations) trained on synthetic batches with an
I-FGSM attack of 2 steps per batch and 3 updates per batch, plain and with
``arbitrary_gt``'s random target; then the train CLI with ``--adversarial``
and its resume, and its refusal of the KITTI pairs.

One set of JAX RAFT variables (perturbed as in tests/test_torch_raft.py)
goes through the weight bridge into the port; the batches and the random
targets come from one numpy seed on both sides.  On the CPU the port's
lookup and its gradient run the plain versions of the CUDA kernels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raft import _perturb
from understanding_flow_robustness_tpu import training as jtraining
from understanding_flow_robustness_tpu.attacks.global_attacks import (
    PerturbConfig as JPerturbConfig,
)
from understanding_flow_robustness_tpu.models import convert as jconvert
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu.models.registry import (
    FlowModel as JFlowModel,
)
from understanding_flow_robustness_tpu_torch.attacks import PerturbConfig
from understanding_flow_robustness_tpu_torch.cli import train as cli_train
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    FlowModel,
    raft_state_dict_from_jax,
)
from understanding_flow_robustness_tpu_torch.training import (
    TrainConfig,
    checkpoint,
    train,
)
from understanding_flow_robustness_tpu_torch.training.trainer import (
    INNER_ITERATION,
)

B, HW, ITERS, N_STEP, BATCHES = 1, 64, 2, 2, 2
LR = 1e-4
# the trainer with the attack "none" (a zero noise: the adversarial half is
# a copy of the clean one), which holds the trainer's own work: parameters
# after each batch per weight within 2 x the sum of the learning rates so
# far (AdamW's first updates move a weight by ~lr whatever its gradient's
# size, so a near-zero gradient whose sign the two frameworks' summation
# orders flip puts it that far apart), the update as a whole within
# UPDATE_REL_L2, and each batch's loss and EPE within LOSS_RTOL, relative:
# the first batch's agree within 3e-6, the second's, after three such
# updates, within 6.2e-4, and its 1/3/5 px shares within 8 of 8,192
# pixels; the updates 2.7e-3 and 1.1e-2 apart after 3 and 6 (measured)
LOSS_RTOL = 2e-3
UPDATE_REL_L2 = 2e-2
# the trainer with the real 2-step I-FGSM on both sides.  The attacks'
# sign steps part where an image gradient is within the packages'
# difference of zero (36 of 12,288 pixels after one step, 316-468 after
# two, each by 2 x the step), and JAX's f32 image gradient through RAFT on
# the CPU is itself 0.75 % from the port's (fnet's full-resolution layers,
# tests/test_torch_training.py).  Training on these halves is sensitive
# too: adversarial halves 3.5e-6 apart moved the second batch's loss
# 1.5e-3 apart.  Measured: losses and EPEs 3e-5-7e-4 apart after the
# first batch and 4.7e-3-9.5e-3 after the second, updates 0.12 relative
# L2, pixel shares up to 20 of 8,192 pixels apart.  A missing adversarial
# half or a missing update moves the loss by far more
IFGSM_LOSS_RTOL = 2e-2
IFGSM_UPDATE_REL_L2 = 0.25
IFGSM_PX_SHARE_TOL = 40 / 8192


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _synthetic(n=BATCHES, seed=3):
    """Batches as the train CLIs' --synthetic draws them."""
    def gen():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield {"image1": rng.rand(B, HW, HW, 3).astype(np.float32),
                   "image2": rng.rand(B, HW, HW, 3).astype(np.float32),
                   "flow": (4 * rng.randn(B, HW, HW, 2)).astype(np.float32),
                   "valid": np.ones((B, HW, HW), np.float32)}
    return gen


def _sample_gt(rng):
    """The train CLIs' synthetic ``sample_gt_fn``: a random flow from the
    trainer's own RandomState."""
    return (rng.randn(B, HW, HW, 2).astype(np.float32),
            np.ones((B, HW, HW), np.float32))


@pytest.fixture(scope="module")
def variables():
    rng = np.random.RandomState(0)
    jm = JRAFT(iters=ITERS, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
                         jnp.zeros((1, HW, HW, 3)))
    return {"params": _perturb(v["params"], rng),
            "batch_stats": _perturb(v["batch_stats"], rng)}


def _leaves(tree):
    """Copies of a tree's arrays by path: the JAX train step donates its
    parameter buffers, so a view taken after one batch would show the
    next batch's values."""
    return {jax.tree_util.keystr(k): np.array(x, copy=True) for k, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flax_params(module):
    sd = {k: v.detach() for k, v in module.state_dict().items()}
    return _leaves(jconvert.convert_raft(
        jconvert.to_numpy_state_dict(sd))["params"])


@pytest.mark.parametrize("method,arbitrary_gt", [("none", False),
                                                 ("ifgsm", False),
                                                 ("ifgsm", True)])
def test_adversarial_batches_match_jax(tmp_path, variables, method,
                                       arbitrary_gt):
    """BATCHES adversarial batches of the port's trainer against the JAX
    trainer's, from the same weights on the same batches: each batch's
    loss and metrics and the parameters after each batch, with
    INNER_ITERATION updates a batch on the schedule.  ``arbitrary_gt``
    attacks toward a random target drawn from the trainer's RandomState
    after the batch.  "none" (a zero noise) holds the trainer's own work
    tightly; "ifgsm" runs the real 2-step I-FGSM, at the bounds its sign
    steps allow."""
    tight = method == "none"
    loss_rtol = LOSS_RTOL if tight else IFGSM_LOSS_RTOL
    update_rel_l2 = UPDATE_REL_L2 if tight else IFGSM_UPDATE_REL_L2
    px_share_tol = 16 / 8192 if tight else IFGSM_PX_SHARE_TOL
    adv = dict(perturb_method=method, flow_loss="l2", output_norm=0.02,
               n_step=N_STEP, targeted=arbitrary_gt)
    common = dict(num_steps=BATCHES - 1, lr=LR, val_freq=1, seed=7,
                  adversarial=True, arbitrary_gt=arbitrary_gt,
                  save_checkpoints=False)

    j_metrics, j_params = [], []
    jm = JRAFT(iters=ITERS, mixed_precision=False)
    jmodel = JFlowModel("RAFT", jm, variables, True, 8)
    jtraining.train(
        jtraining.TrainConfig(checkpoint_dir=str(tmp_path / "j"),
                              adv_config=JPerturbConfig(**adv), n_devices=1,
                              **common),
        jmodel, _synthetic(),
        validate_fn=lambda p, s, step: j_params.append(_leaves(p)),
        logger=lambda step, m: j_metrics.append(m),
        sample_gt_fn=_sample_gt)

    module = RAFT(iters=ITERS, mixed_precision=False)
    module.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    model = FlowModel("RAFT", module.eval(), torch.device("cpu"))
    t_metrics, t_params = [], []
    steps = train(
        TrainConfig(checkpoint_dir=str(tmp_path / "t"),
                    adv_config=PerturbConfig(**adv), **common),
        model, _synthetic(),
        validate_fn=lambda m, step: t_params.append(_flax_params(m)),
        logger=lambda step, m: t_metrics.append(m),
        sample_gt_fn=_sample_gt)

    assert steps == BATCHES and len(t_metrics) == len(j_metrics) == BATCHES
    for got, ref in zip(t_metrics, j_metrics):
        assert got.keys() == ref.keys()
        # the loss and the mean EPE; the 1/3/5 px shares count pixels on
        # either side of a threshold, where a few of the 8,192 cross with
        # the summation orders and ~20 with the real attacks' differences
        for k in ("loss", "epe"):
            np.testing.assert_allclose(got[k], ref[k], rtol=loss_rtol,
                                       err_msg=k)
        for k in ("1px", "3px", "5px"):
            assert abs(got[k] - ref[k]) <= px_share_tol, k
    p0 = _leaves(variables["params"])
    lr_sum = 0.0
    _, j_sched = jtraining.fetch_optimizer(lr=LR, num_steps=BATCHES - 1,
                                           inner_iteration=INNER_ITERATION)
    for i, (pg, pj) in enumerate(zip(t_params, j_params)):
        lr_sum += sum(float(j_sched(INNER_ITERATION * i + u))
                      for u in range(INNER_ITERATION))
        num = den = 0.0
        for k in pj:
            a, b, z = pg[k], pj[k], p0[k]
            if tight:
                assert np.abs(a - b).max() <= 2 * lr_sum, (i, k)
            num += np.sum(((a - z) - (b - z)) ** 2)
            den += np.sum((b - z) ** 2)
        assert den > 0 and np.sqrt(num / den) < update_rel_l2, i
    # the attack left the module in train mode, its parameters trainable
    assert module.training
    assert all(p.requires_grad for p in module.parameters())


def test_adversarial_batch_doubles_and_restores_the_module(tmp_path):
    """One adversarial batch: the train step sees the clean and adversarial
    pairs together (batch 2B), the adversarial images within the eps-ball
    of the clean ones and in [0, 1]; the attack ran in eval mode with the
    parameters frozen and left the module in train mode with frozen batch
    norm and every parameter trainable; 3 updates, one batch counted."""
    from understanding_flow_robustness_tpu_torch.training import (
        trainer as ttrainer,
    )

    module = RAFT(iters=ITERS, mixed_precision=False)
    model = FlowModel("RAFT", module, torch.device("cpu"))
    seen, modes = [], []
    make_step = ttrainer.make_train_step

    def spy_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            out = step(batch)
            modes.append((module.training, module.cnet.norm1.training))
            return out
        return run

    ttrainer.make_train_step = spy_step
    try:
        cfg = TrainConfig(checkpoint_dir=str(tmp_path), num_steps=0, lr=LR,
                          adversarial=True, freeze_bn=True, seed=1,
                          adv_config=PerturbConfig("ifgsm", "both", 0.02,
                                                   N_STEP, flow_loss="l2"))
        assert train(cfg, model, _synthetic(1)) == 1
    finally:
        ttrainer.make_train_step = make_step
    assert len(seen) == INNER_ITERATION
    batch = seen[0]
    assert tuple(batch["image1"].shape) == (2 * B, HW, HW, 3)
    clean = next(_synthetic(1)())
    for k, adv in (("image1", batch["image1"][B:]),
                   ("image2", batch["image2"][B:])):
        np.testing.assert_array_equal(batch[k][:B].numpy(), clean[k])
        d = (adv - torch.from_numpy(clean[k])).abs().max().item()
        assert 0 < d <= 0.02 + 1e-6
        assert 0.0 <= adv.min().item() and adv.max().item() <= 1.0
    for k in ("flow", "valid"):
        np.testing.assert_array_equal(batch[k][:B].numpy(), clean[k])
        np.testing.assert_array_equal(batch[k][B:].numpy(), clean[k])
    assert modes == [(True, False)] * INNER_ITERATION
    assert all(p.requires_grad for p in module.parameters())
    assert checkpoint.restore_checkpoint(cfg.checkpoint_dir)["total_steps"] == 0


def test_train_cli_adversarial_and_resume(tmp_path):
    """``--adversarial --synthetic 2``: two batches of 3 updates each,
    finite losses, the checkpoint and weights written, ``val_freq`` 1000
    (train.py:143-148); the rerun resumes as fully trained; and with
    ``--arbitrary_gt`` the attack is targeted."""
    argv = ["--adversarial", "--synthetic", "2", "--num_steps", "1",
            "--batch_size", "1", "--image_size", "64", "64", "--iters", "2",
            "--perturb_n_step", "2", "--model",
            "RAFT_adv_kitti2012_ifgsm_l2_002", "--name", "adv",
            "--checkpoint_dir", str(tmp_path), "--lr", "1e-4",
            "--device", "cpu"]
    args = cli_train.build_parser().parse_args(argv)
    assert args.adversarial and args.perturb_n_step == 2
    assert (args.adv_method, args.adv_loss, args.adv_norm) == ("ifgsm", "l2",
                                                               0.02)
    assert cli_train.build_parser().parse_args(["--adv_train"]).adversarial
    out = cli_train.main(argv)
    assert out["total_steps"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["history"])
    for f in ("args.json", "checkpoint.pth", "adv.pth"):
        assert os.path.exists(tmp_path / "adv" / f), f
    saved = open(tmp_path / "adv" / "args.json").read()
    assert '"adversarial": "True"' in saved and '"val_freq": "1000"' in saved
    ckpt = checkpoint.restore_checkpoint(str(tmp_path / "adv"))
    # 2 batches x 3 updates on the schedule
    assert ckpt["scheduler_state_dict"]["last_epoch"] == 2 * INNER_ITERATION
    again = cli_train.main(argv)
    assert again["total_steps"] == 2 and again["history"] == []

    arb = cli_train.main(argv + ["--arbitrary_gt", "--name", "arb"])
    assert arb["total_steps"] == 2
    assert all(np.isfinite(m["loss"]) for m in arb["history"])
    assert "'targeted': True" in open(tmp_path / "arb" / "args.json").read()


@pytest.mark.parametrize("stage", ["kitti2015", "kitti2012"])
def test_train_cli_refuses_adversarial_kitti_pairs(tmp_path, stage):
    """Adversarial training's data path, KITTI pairs at batch 1
    (training/utils.py:245-289), is ported (tests/test_torch_train_clis.py
    trains on it): a batch other than 1 raises, and so do missing path
    lists."""
    argv = ["--adversarial", "--stage", stage, "--checkpoint_dir",
            str(tmp_path), "--device", "cpu", "--data_list_dir",
            str(tmp_path / "none")]
    with pytest.raises(ValueError, match="batch_size 1"):
        cli_train.main(argv + ["--batch_size", "2"])
    with pytest.raises(FileNotFoundError):
        cli_train.main(argv + ["--batch_size", "1"])
