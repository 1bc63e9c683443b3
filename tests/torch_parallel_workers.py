"""Rank functions of the port's data-parallel tests (tests/test_torch_
parallel.py, tests/test_torch_grad_transport.py, and the trainer and CLI
cases of tests/test_torch_training.py).

``parallel.launch`` spawns each rank, which imports the function's module
anew: this one imports numpy, torch and the port only, so that a rank does
not import JAX.  Every function here also runs unsharded in the test
process, with ``mesh=None``, as the one-device reference.
"""

import numpy as np
import torch

from understanding_flow_robustness_tpu_torch.attacks import (
    PerturbConfig,
    make_attack,
    make_sharded_attack,
)
from understanding_flow_robustness_tpu_torch.attacks import (
    perturb_runner as runner,
)
from understanding_flow_robustness_tpu_torch.cli import evaluate as tcli
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    FlowNetS2,
    fetch_model,
)
from understanding_flow_robustness_tpu_torch.parallel import (
    all_gather,
    all_reduce_sum,
    gather_objects,
    shard_batch,
)
from understanding_flow_robustness_tpu_torch.training import (
    TrainConfig,
    fetch_optimizer,
    make_train_step,
    multiscale_epe,
    sequence_loss,
    train,
)
from understanding_flow_robustness_tpu_torch.training import (
    trainer as trainer_mod,
)

# the toy model of the JAX package's tests/test_parallel_eval.py: a 1x1
# projection of the concatenated frames
TOY_W = np.random.RandomState(3).randn(6, 2).astype(np.float32)


def toy_predict(a, b):
    w = torch.from_numpy(TOY_W).to(a.device)
    return torch.einsum("bhwc,cd->bhwd", torch.cat([a, b], -1), w)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------ train steps

MODELS = {"RAFT": lambda: RAFT(iters=2, mixed_precision=False),
          "FlowNetS": FlowNetS2}


def train_step(mesh, kind, state, batch, mode, lr):
    """One step of ``make_train_step`` on ``kind`` (RAFT: the sequence
    loss, batch norm training; FlowNetS: the multiscale loss's FlowNet
    branch) from ``state`` on this rank's slice of ``batch``, in ``mode``
    ("pjit", "explicit" or "bf16").  Returns the global metrics, the
    gradients the optimizer received before the clip, the state dict after
    the step (numpy) and the bytes all-reduced."""
    torch.manual_seed(0)
    module = MODELS[kind]()
    module.load_state_dict(state, strict=True)
    opt, sched = fetch_optimizer(module.parameters(), lr=lr, num_steps=10)
    is_raft = kind == "RAFT"
    step = make_train_step(
        module, opt, sched, is_raft=is_raft, flownetc=not is_raft,
        loss_type="sequence" if is_raft else "multiscale", mesh=mesh,
        explicit=mode != "pjit",
        grad_transport="bf16" if mode == "bf16" else "f32")
    grads = {}
    real_clip = torch.nn.utils.clip_grad_norm_

    def record(params, clip):
        for n, p in module.named_parameters():
            if p.grad is not None:
                grads[n] = p.grad.detach().numpy().copy()
        return real_clip(params, clip)

    torch.nn.utils.clip_grad_norm_ = record
    try:
        metrics = step(shard_batch(mesh, _tensors(batch)))
    finally:
        torch.nn.utils.clip_grad_norm_ = real_clip
    return {"metrics": metrics, "grads": grads,
            "state": {k: v.detach().numpy().copy()
                      for k, v in module.state_dict().items()},
            "sent": step.sent_bytes}


def train_steps(mesh, cases):
    """``train_step`` for every case {name: (kind, state, batch, mode,
    lr)}."""
    return {name: train_step(mesh, *args) for name, args in cases.items()}


# ----------------------------------------------------------------- losses

def losses(mesh, cases):
    """Each case {name: (loss name, preds, gt, valid, kwargs)} on this
    rank's slice, with the global counts: the loss and metrics summed over
    the ranks (the global batch's values)."""
    out = {}
    for name, (loss_name, preds, gt, valid, kw) in cases.items():
        fn = sequence_loss if loss_name == "sequence" else multiscale_epe
        p, g, v = shard_batch(mesh, ([torch.from_numpy(x) for x in preds],
                                     torch.from_numpy(gt),
                                     torch.from_numpy(valid)))
        loss, metrics = fn(list(p), g, v, mesh=mesh, **kw)
        keys = sorted(metrics)
        vals = torch.stack([loss] + [metrics[k] for k in keys]).detach()
        vals = all_reduce_sum(mesh, vals).tolist()
        out[name] = (vals[0], dict(zip(keys, vals[1:])))
    return out


# ---------------------------------------------------------------- attacks

def attacks(mesh, images, cfgs, seed):
    """Each attack config on the global ``images`` (img0, img1, gt), this
    rank's slice attacked (``make_sharded_attack``) and the results
    gathered; unsharded with ``mesh=None``."""
    out = {}
    for name, cfg in cfgs.items():
        gen = torch.Generator().manual_seed(seed)
        full = [torch.from_numpy(x) for x in images]
        if mesh is None:
            res = make_attack(toy_predict, cfg)(*full, gen)
        else:
            res = make_sharded_attack(toy_predict, cfg, mesh)(
                *shard_batch(mesh, full), gen)
            res = [all_gather(mesh, x) for x in res]
        out[name] = [x.numpy() for x in res]
    return out


def runner_samples(n_batches=2, b=8, h=16, w=32):
    rng = np.random.RandomState(5)
    for _ in range(n_batches):
        img0 = rng.rand(b, h, w, 3).astype(np.float32)
        img1 = rng.rand(b, h, w, 3).astype(np.float32)
        gt = np.concatenate([rng.randn(b, h, w, 2), np.ones((b, h, w, 1))],
                            -1).astype(np.float32)
        yield img0, img1, gt, gt


def run_runner(mesh, output_path):
    cfg = runner.RunConfig(
        perturb=PerturbConfig(perturb_method="ifgsm", n_step=2),
        output_path=output_path, device="cpu")
    return runner.run(toy_predict, runner_samples(), cfg, mesh=mesh)


# ------------------------------------------------- the adversarial trainer

def adversarial_batches(h=64, w=64):
    rng = np.random.RandomState(7)
    yield {"image1": rng.rand(1, h, w, 3).astype(np.float32),
           "image2": rng.rand(1, h, w, 3).astype(np.float32),
           "flow": (rng.randn(1, h, w, 2) * 3).astype(np.float32),
           "valid": np.ones((1, h, w), np.float32)}


def adversarial_train(mesh, checkpoint_dir):
    """One adversarial batch (3 updates on the clean and attacked pair) of
    RAFT (2 iterations, 64x64, f32) at ``mesh``'s size.  Returns the metrics of
    each update, every rank's local ``image1`` of each update (in rank
    order) and the final state dict."""
    model = fetch_model("RAFT", iters=2, mixed_precision=False, seed=0,
                        device="cpu")
    cfg = TrainConfig(
        name="adv", num_steps=0, batch_size=1, val_freq=100, lr=1e-4,
        checkpoint_dir=checkpoint_dir, seed=0, adversarial=True,
        adv_config=PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                                 output_norm=0.02, n_step=2),
        n_devices=1 if mesh is None else mesh.world)
    seen, metrics = [], []
    real = trainer_mod.make_train_step

    def spy(*args, **kw):
        step = real(*args, **kw)

        def wrapped(batch):
            seen.append(batch["image1"].numpy().copy())
            metrics.append(step(batch))
            return metrics[-1]
        return wrapped

    trainer_mod.make_train_step = spy
    try:
        steps = train(cfg, model, adversarial_batches)
    finally:
        trainer_mod.make_train_step = real
    return {"steps": steps, "metrics": metrics,
            "seen": gather_objects(mesh, seen),
            "state": {k: v.numpy().copy()
                      for k, v in model.module.state_dict().items()}}


def synthetic_batches(n=2, b=2, h=64, w=64, seed=0):
    """The train CLI's --synthetic batches, importable by a spawned rank
    (``train(..., n_devices=2)`` pickles its ``batches``)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield {"image1": rng.rand(b, h, w, 3).astype(np.float32),
               "image2": rng.rand(b, h, w, 3).astype(np.float32),
               "flow": rng.randn(b, h, w, 2).astype(np.float32),
               "valid": np.ones((b, h, w), np.float32)}


def time_limited_train(mesh, checkpoint_dir):
    """``train`` at world 2 with rank 0 past its time limit from the start
    and rank 1 never: rank 0's clock stops every rank after the first
    batch.  Returns every rank's step count."""
    model = fetch_model("RAFT", iters=2, mixed_precision=False, seed=0,
                        device="cpu")
    cfg = TrainConfig(
        name="clock", num_steps=10, batch_size=2, val_freq=100,
        checkpoint_dir=checkpoint_dir, seed=0, n_devices=mesh.world,
        time_limit=-1.0 if mesh.rank == 0 else 1e9, save_checkpoints=False)
    return gather_objects(mesh, train(cfg, model, synthetic_batches))


# ------------------------------------------------------ everything at once

def parallel_suite(mesh, job):
    """tests/test_torch_parallel.py's world-2 rank: the losses, the KITTI
    validation through ``cli.evaluate --n_devices`` (this worker's mesh),
    the sharded attacks, the runner's mesh mode, the adversarial trainer
    and the time limit."""
    out = {"losses": losses(mesh, job["losses"]),
           "attacks": attacks(mesh, job["images"], job["attack_cfgs"], 0),
           "runner": run_runner(mesh, job["runner_path"]),
           "adversarial": adversarial_train(mesh, job["adv_dir"]),
           "clock": time_limited_train(mesh, job["clock_dir"])}
    out["validate"] = tcli.main(job["evaluate_argv"])
    return out


def fail_on_rank1(mesh):
    """Raises on rank 1 while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    all_reduce_sum(mesh, torch.ones(1))
