"""Optimizer and learning-rate schedule (counterpart of
``understanding_flow_robustness_tpu/training/optim.py``; reference:
training/utils.py:225-239).

PyTorch's own ``AdamW`` and ``OneCycleLR``: the JAX package reimplements
exactly these (its ``onecycle_linear`` is held to ``OneCycleLR`` by
tests/test_training.py).  optax's ``adamw`` step p - lr*(m/(sqrt(v)+eps) +
wd*p) equals ``AdamW``'s p*(1 - lr*wd) - lr*m/(sqrt(v)+eps).  JAX indexes
the schedule by the update count before the update; here
``scheduler.step()`` follows ``optimizer.step()``, which is the same.
"""

from __future__ import annotations

import torch


def fetch_optimizer(params, lr: float = 1e-4, wdecay: float = 1e-4,
                    epsilon: float = 1e-8, num_steps: int = 100000,
                    inner_iteration: int = 1, clip: float = 1.0):
    """(AdamW, OneCycleLR) over ``params``: max_lr ``lr``, linear anneal,
    pct_start 0.05, no momentum cycling, ``num_steps * inner_iteration +
    100`` schedule steps (utils.py:231-238; the 100 spare steps cover the
    trainer's num_steps + 1 batches, past which ``OneCycleLR`` raises).

    ``clip``, the global gradient-norm bound the JAX package chains before
    AdamW (training/train.py:277-282), travels in every param group as
    ``"clip"``; ``make_train_step`` applies it."""
    optimizer = torch.optim.AdamW(params, lr=lr, weight_decay=wdecay,
                                  eps=epsilon)
    for group in optimizer.param_groups:
        group["clip"] = clip
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=lr, total_steps=num_steps * inner_iteration + 100,
        pct_start=0.05, cycle_momentum=False, anneal_strategy="linear")
    return optimizer, scheduler
