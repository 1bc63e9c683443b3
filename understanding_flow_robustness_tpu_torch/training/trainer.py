"""The training loop (counterpart of
``understanding_flow_robustness_tpu/training/trainer.py``; reference:
training/train.py:95-353), without its adversarial branch.

Writes ``args.json``, resumes from ``<checkpoint_dir>/checkpoint.pth``,
adds the optional per-batch noise, takes ``inner_iteration`` updates per
batch, checkpoints every ``val_freq`` batches, stops after ``num_steps + 1``
batches or at the time limit, and ends with a checkpoint and the
``<name>.pth`` weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from .optim import fetch_optimizer
from .train_step import make_train_step

VAL_FREQ = 5000                     # training/train.py:49
TIME_LIMIT = 24 * 60 * 60 - 1000    # training/train.py:50
_BATCH_KEYS = ("image1", "image2", "flow", "valid")


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` (trainer.py:34-78), same fields
    and defaults.  ``adv_config`` stays None here: the attack
    configuration arrives with the attacks (ROADMAP A8)."""

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
    adv_config: Optional[Any] = None
    inner_iteration: int = 1
    time_limit: float = TIME_LIMIT
    n_devices: Optional[int] = None
    grad_transport: str = "f32"
    seed: int = 1234
    add_noise: bool = False           # --add_noise (train.py:162-169)
    arbitrary_gt: bool = False        # --arbitrary_gt (train.py:151,188-199)
    not_excluding: bool = False       # --no_excluding (a dead no-op upstream)
    save_checkpoints: bool = True     # --DEBUG turns them off


def train(cfg: TrainConfig, model, batches: Callable,
          validate_fn: Optional[Callable] = None,
          logger: Optional[Callable] = None) -> int:
    """Train ``model`` (a ``models.FlowModel``) in place; returns the number
    of batches taken, counting those of a resumed run.

    ``batches()`` yields dicts of numpy arrays: ``image1``,
    ``image2`` (B, H, W, 3) in [0, 1], ``flow`` (B, H, W, 2), ``valid``
    (B, H, W).  ``logger(step, metrics)`` sees every batch's metrics;
    ``validate_fn(module, step)`` runs at each ``val_freq`` checkpoint."""
    if cfg.adversarial or cfg.arbitrary_gt:
        raise NotImplementedError(
            "adversarial training (--adversarial, --arbitrary_gt) needs the "
            "attacks, ROADMAP A8")
    if (cfg.n_devices or 1) > 1 or cfg.grad_transport != "f32":
        raise NotImplementedError(
            "data parallelism and bf16 gradient transport are ROADMAP A13; "
            "the port trains on one device")
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    with open(os.path.join(cfg.checkpoint_dir, "args.json"), "w") as f:
        json.dump({k: str(v) for k, v in dataclasses.asdict(cfg).items()}, f,
                  indent=2)

    module = model.module
    optimizer, scheduler = fetch_optimizer(
        module.parameters(), lr=cfg.lr, wdecay=cfg.wdecay,
        epsilon=cfg.epsilon, num_steps=cfg.num_steps,
        inner_iteration=cfg.inner_iteration, clip=cfg.clip)
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

    step_fn = make_train_step(
        module, optimizer, scheduler, loss_type=cfg.loss_type,
        is_raft=model.is_raft, flownetc=cfg.flownetc, pwc=cfg.pwc,
        gamma=cfg.gamma, div_flow=cfg.div_flow,
        flownetc_weighing=cfg.flownetc_weighing, freeze_bn=cfg.freeze_bn,
        not_excluding=cfg.not_excluding)

    t_start = time.time()
    np_rng = np.random.RandomState(cfg.seed)
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
            for _ in range(cfg.inner_iteration):
                metrics = step_fn(dev_batch)
            if logger is not None:
                logger(total_steps, metrics)

            if total_steps % cfg.val_freq == cfg.val_freq - 1:  # train.py:289
                if cfg.save_checkpoints:
                    ckpt.save_checkpoint(cfg.checkpoint_dir, module,
                                         optimizer, scheduler, total_steps)
                if validate_fn is not None:
                    validate_fn(module, total_steps)

            total_steps += 1
            if total_steps > cfg.num_steps:
                should_keep_training = False
                break
            if time.time() - t_start > cfg.time_limit:
                print("time limit reached; checkpointing for resume")
                should_keep_training = False
                break

    if cfg.save_checkpoints:
        # the step is stored before its increment, like the val_freq ones
        ckpt.save_checkpoint(cfg.checkpoint_dir, module, optimizer,
                             scheduler, total_steps - 1)
        ckpt.save_weights(os.path.join(cfg.checkpoint_dir, f"{cfg.name}.pth"),
                          module)
    return total_steps
