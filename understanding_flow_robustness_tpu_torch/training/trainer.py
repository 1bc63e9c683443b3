"""The training loop (counterpart of
``understanding_flow_robustness_tpu/training/trainer.py``; reference:
training/train.py:95-353).

Writes ``args.json``, resumes from ``<checkpoint_dir>/checkpoint.pth``,
adds the optional per-batch noise, runs the optional adversarial branch
(an eval-mode attack on each batch, trained on the clean and adversarial
pairs together, train.py:171-225), takes ``inner_iteration`` updates per
batch (``INNER_ITERATION`` under adversarial training), checkpoints every
``val_freq`` batches, stops after ``num_steps + 1`` batches or at the time
limit, and ends with a checkpoint and the ``<name>.pth`` weights.

With ``n_devices`` > 1 it trains in that many ranks, one process per
device (``parallel.launch``; trainer.py:144-178, 252-255 of the JAX
package): every rank draws the same global batch stream (its noise, its
adversarial pair, each rank decoding the whole batch) and trains on its
slice of it with the step's global statistics; rank 0 alone writes the
files and calls ``logger`` and ``validate_fn`` while the others wait.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..attacks.global_attacks import PerturbConfig, make_attack
from ..models.registry import FlowModel, predict_flow_differentiable
from ..parallel.mesh import (
    all_reduce_sum,
    barrier,
    current_mesh,
    is_rank0,
    launch,
    replicate,
    shard_batch,
)
from . import checkpoint as ckpt
from .optim import fetch_optimizer
from .train_step import make_train_step

VAL_FREQ = 5000                     # training/train.py:49
INNER_ITERATION = 3                 # training/train.py:52 (adversarial)
TIME_LIMIT = 24 * 60 * 60 - 1000    # training/train.py:50
_BATCH_KEYS = ("image1", "image2", "flow", "valid")


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` (trainer.py:34-78), same fields
    and defaults."""

    name: str = "flow"
    stage: str = "chairs"
    image_size: tuple = (368, 496)
    batch_size: int = 6
    lr: float = 4e-4
    wdecay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8
    num_steps: int = 100000
    val_freq: int = VAL_FREQ
    checkpoint_dir: str = "checkpoints"
    loss_type: str = "sequence"       # sequence | multiscale
    flownetc: bool = False
    pwc: bool = False
    div_flow: float = 1.0
    flownetc_weighing: bool = False
    freeze_bn: bool = False           # non-chairs stages (train.py:131-137)
    adversarial: bool = False
    adv_config: PerturbConfig = dataclasses.field(
        default_factory=lambda: PerturbConfig(
            perturb_method="ifgsm", flow_loss="l2", output_norm=0.02))
    inner_iteration: int = 1
    time_limit: float = TIME_LIMIT
    n_devices: Optional[int] = None
    grad_transport: str = "f32"
    seed: int = 1234
    add_noise: bool = False           # --add_noise (train.py:162-169)
    arbitrary_gt: bool = False        # --arbitrary_gt (train.py:151,188-199)
    not_excluding: bool = False       # --no_excluding (a dead no-op upstream)
    save_checkpoints: bool = True     # --DEBUG turns them off


def _adversarial_batch(cfg: TrainConfig, model, batch: dict,
                       sample_gt_fn: Optional[Callable], np_rng,
                       generator: torch.Generator) -> dict:
    """The batch and its adversarial pair together (train.py:171-221): the
    attack ``cfg.adv_config`` runs the module in eval mode with its
    current parameters and running statistics, its parameters frozen
    (``predict_flow_differentiable``, which restores the module's mode and
    flags), toward the batch's ground truth or, with ``arbitrary_gt`` and
    ``sample_gt_fn(np_rng) -> (flow, valid)``, a random sample's
    (train.py:188-199); images, flow and valid maps come back doubled."""
    if cfg.arbitrary_gt and sample_gt_fn is not None:
        flow, valid = sample_gt_fn(np_rng)
        gt = np.concatenate([np.asarray(flow, np.float32),
                             np.asarray(valid, np.float32)[..., None]], -1)
        if gt.ndim == 3:
            gt = gt[None]
        gt = torch.as_tensor(gt, device=model.device)
    else:
        gt = torch.cat([batch["flow"], batch["valid"][..., None]], -1)

    def predict(a, b):
        return predict_flow_differentiable(model, a, b)

    _, _, adv1, adv2 = make_attack(predict, cfg.adv_config)(
        batch["image1"], batch["image2"], gt, generator)
    return {"image1": torch.cat([batch["image1"], adv1]),
            "image2": torch.cat([batch["image2"], adv2]),
            "flow": torch.cat([batch["flow"]] * 2),
            "valid": torch.cat([batch["valid"]] * 2)}


def n_devices_for(cfg: TrainConfig, device: torch.device) -> int:
    """``cfg.n_devices``, or by default the largest divisor of the batch
    that is at most the device count (DataParallel never scatters more
    replicas than batch items; trainer.py:144-153 of the JAX package): the
    card count on CUDA, 1 on the CPU device."""
    if cfg.n_devices is not None:
        return int(cfg.n_devices)
    n_avail = torch.cuda.device_count() if device.type == "cuda" else 1
    return max(n for n in range(1, min(n_avail, cfg.batch_size) + 1)
               if cfg.batch_size % n == 0)


def _train_rank(mesh, cfg, name, is_raft, size_multiple, blob, batches,
                validate_fn, log, sample_gt_fn):
    """One rank of a library call's ``train``: the model from ``blob`` on
    the rank's device; rank 0 returns the step count, its weights on the
    host and what it logged."""
    module = torch.load(io.BytesIO(blob), map_location=mesh.device,
                        weights_only=False)
    model = FlowModel(name, module, mesh.device, is_raft, size_multiple)
    logged = []
    steps = train(cfg, model, batches, validate_fn=validate_fn,
                  logger=(lambda s, m: logged.append((s, m))) if log else None,
                  sample_gt_fn=sample_gt_fn)
    return steps, {k: v.cpu() for k, v in module.state_dict().items()}, logged


def _launch_train(cfg, model, n, batches, validate_fn, logger, sample_gt_fn):
    """``train`` in ``n`` spawned ranks; the caller's model ends with rank
    0's weights and ``logger`` sees rank 0's metrics, after the run."""
    for arg, value in (("cfg", cfg), ("batches", batches),
                       ("validate_fn", validate_fn),
                       ("sample_gt_fn", sample_gt_fn)):
        try:
            pickle.dumps(value)
        except Exception as e:
            raise TypeError(
                f"train(n_devices={n}): argument {arg!r} does not pickle "
                f"({type(e).__name__}: {e}); each rank is a spawned process "
                "and receives it pickled: pass a module-level function or a "
                "functools.partial of one") from e
    blob = io.BytesIO()
    torch.save(model.module, blob)
    steps, state, logged = launch(
        _train_rank, n, cfg, model.name, model.is_raft, model.size_multiple,
        blob.getvalue(), batches, validate_fn, logger is not None,
        sample_gt_fn, device=model.device.type)
    model.module.load_state_dict(state)
    for step, metrics in logged:
        logger(step, metrics)
    return steps


def train(cfg: TrainConfig, model, batches: Callable,
          validate_fn: Optional[Callable] = None,
          logger: Optional[Callable] = None,
          sample_gt_fn: Optional[Callable] = None) -> int:
    """Train ``model`` (a ``models.FlowModel``) in place; returns the number
    of batches taken, counting those of a resumed run.

    ``batches()`` yields dicts of numpy arrays: ``image1``,
    ``image2`` (B, H, W, 3) in [0, 1], ``flow`` (B, H, W, 2), ``valid``
    (B, H, W).  ``logger(step, metrics)`` sees every batch's metrics;
    ``validate_fn(module, step)`` runs at each ``val_freq`` checkpoint.
    ``sample_gt_fn(np_rng) -> (flow, valid)`` gives ``arbitrary_gt``'s
    random target, drawn from the trainer's ``RandomState(cfg.seed)``
    after the batch's noise.  With ``adversarial`` every batch takes
    ``INNER_ITERATION`` updates: the schedule advances per update, the
    step count per batch (train.py:225-338).

    ``n_devices`` (see ``n_devices_for``) > 1: inside a worker of
    ``parallel.launch`` with that many ranks (the train CLI's
    ``--n_devices``) this rank trains; otherwise the call launches the
    ranks itself on the model's device type, its arguments pickled (a
    clear error names one that does not pickle), and the caller's model
    ends with rank 0's weights, as after a one-device run; ``logger`` then
    sees rank 0's metrics after the run.  ``grad_transport="bf16"`` runs
    the step's explicit mode with bf16 gradients (trainer.py:155-168)."""
    n = n_devices_for(cfg, model.device)
    mesh = current_mesh()
    if mesh is None and n > 1:
        return _launch_train(cfg, model, n, batches, validate_fn, logger,
                             sample_gt_fn)
    if mesh is not None and mesh.world != n:
        raise ValueError(f"n_devices={n} inside a worker of a "
                         f"{mesh.world}-rank launch")
    rank0 = is_rank0(mesh)
    if rank0:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        with open(os.path.join(cfg.checkpoint_dir, "args.json"), "w") as f:
            json.dump({k: str(v) for k, v in dataclasses.asdict(cfg).items()},
                      f, indent=2)

    module = model.module
    inner = INNER_ITERATION if cfg.adversarial else cfg.inner_iteration
    optimizer, scheduler = fetch_optimizer(
        module.parameters(), lr=cfg.lr, wdecay=cfg.wdecay,
        epsilon=cfg.epsilon, num_steps=cfg.num_steps,
        inner_iteration=inner, clip=cfg.clip)
    total_steps = 0
    restored = ckpt.restore_checkpoint(cfg.checkpoint_dir)
    if restored is not None:
        module.load_state_dict(restored["model_state_dict"])
        optimizer.load_state_dict(restored["optimizer_state_dict"])
        scheduler.load_state_dict(restored["scheduler_state_dict"])
        # checkpoints are written before the increment (train.py:124)
        total_steps = restored["total_steps"] + 1
        print(f"resumed from step {total_steps}")
        if total_steps >= cfg.num_steps:  # train.py:619-622
            print("fully trained")
            return total_steps
    # every rank starts from rank 0's weights, however the caller built them
    replicate(mesh, module)

    step_fn = make_train_step(
        module, optimizer, scheduler, loss_type=cfg.loss_type,
        is_raft=model.is_raft, flownetc=cfg.flownetc, pwc=cfg.pwc,
        gamma=cfg.gamma, div_flow=cfg.div_flow,
        flownetc_weighing=cfg.flownetc_weighing, freeze_bn=cfg.freeze_bn,
        not_excluding=cfg.not_excluding, mesh=mesh,
        explicit=cfg.grad_transport != "f32",
        grad_transport=cfg.grad_transport)

    t_start = time.time()
    np_rng = np.random.RandomState(cfg.seed)
    # the attack's diverse-input draws
    generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
    should_keep_training = True
    while should_keep_training:
        for batch in batches():
            if cfg.add_noise:
                # train.py:162-169: stdv ~ U(0, 5) on the 0-255 scale
                stdv = np_rng.uniform(0.0, 5.0) / 255.0
                batch = dict(batch)
                for k in ("image1", "image2"):
                    x = np.asarray(batch[k])
                    batch[k] = np.clip(
                        x + stdv * np_rng.randn(*x.shape).astype(np.float32),
                        0.0, 1.0)
            dev_batch = {k: torch.as_tensor(batch[k], dtype=torch.float32,
                                            device=model.device)
                         for k in _BATCH_KEYS}
            if cfg.adversarial:
                # every rank attacks the whole batch: the clean and the
                # adversarial halves are concatenated before sharding
                # (trainer.py:238-255), so with 2 ranks rank 0 trains on
                # the clean half and rank 1 on the attacked one
                dev_batch = _adversarial_batch(cfg, model, dev_batch,
                                               sample_gt_fn, np_rng,
                                               generator)
            dev_batch = shard_batch(mesh, dev_batch)
            for _ in range(inner):
                metrics = step_fn(dev_batch)
            if logger is not None and rank0:
                logger(total_steps, metrics)

            if total_steps % cfg.val_freq == cfg.val_freq - 1:  # train.py:289
                if rank0 and cfg.save_checkpoints:
                    ckpt.save_checkpoint(cfg.checkpoint_dir, module,
                                         optimizer, scheduler, total_steps)
                if rank0 and validate_fn is not None:
                    validate_fn(module, total_steps)
                barrier(mesh)

            total_steps += 1
            if total_steps > cfg.num_steps:
                should_keep_training = False
                break
            over = time.time() - t_start > cfg.time_limit
            if mesh is not None and mesh.world > 1:
                # rank 0's clock decides for every rank: a one-element sum
                flag = torch.tensor([float(over and rank0)],
                                    device=mesh.device)
                over = all_reduce_sum(mesh, flag).item() > 0
            if over:
                print("time limit reached; checkpointing for resume")
                should_keep_training = False
                break

    if rank0 and cfg.save_checkpoints:
        # the step is stored before its increment, like the val_freq ones
        ckpt.save_checkpoint(cfg.checkpoint_dir, module, optimizer,
                             scheduler, total_steps - 1)
        ckpt.save_weights(os.path.join(cfg.checkpoint_dir, f"{cfg.name}.pth"),
                          module)
    barrier(mesh)
    return total_steps
