"""One optimizer step (counterpart of
``understanding_flow_robustness_tpu/training/train_step.py``; reference:
training/train.py:155-287).

Forward with the per-iteration flow list, sequence or multiscale loss,
backward, global-norm clip, the NaN guard, AdamW and the OneCycle step.

Data parallelism (``mesh``, one process per device, ``parallel.launch``)
in the JAX package's three modes (train_step.py:58-82, 154-178):

* default, its pjit path: the loss, its gradient, the metrics and the
  batch-norm statistics of the GLOBAL batch (``global_batch_norm``, the
  losses' global counts); the gradients are summed over the ranks in f32
  and clip, NaN guard and optimizer apply once, identically on every rank;
* ``explicit=True``, its ``axis_name`` (shard_map) path: each rank's own
  loss and batch norm, then the mean over the ranks of the gradients, the
  loss, the metrics and the new running statistics;
* ``explicit=True, grad_transport="bf16"``: the gradients cross as bf16
  (cast, all-reduced, divided, cast back to f32 for the optimizer).

The gradients are all-reduced in flat buckets (``reduce_gradients``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.layers import freeze_bn as _freeze_bn
from ..models.layers import global_batch_norm
from ..parallel.mesh import (
    all_reduce_mean,
    all_reduce_sum,
    reduce_gradients,
)
from .losses import multiscale_epe, sequence_loss


def make_train_step(model: torch.nn.Module, optimizer, scheduler,
                    loss_type: str = "sequence", is_raft: bool = False,
                    flownetc: bool = False, pwc: bool = False,
                    gamma: float = 0.8, div_flow: float = 1.0,
                    flownetc_weighing: bool = False, freeze_bn: bool = False,
                    not_excluding: bool = False,
                    clip: Optional[float] = None, mesh=None,
                    explicit: bool = False,
                    grad_transport: str = "f32") -> Callable:
    """``train_step(batch) -> metrics`` for ``model`` with ``optimizer`` and
    ``scheduler`` (``fetch_optimizer``).

    ``batch``: dict of tensors on the model's device, ``image1``/``image2``
    (B, H, W, 3) in [0, 1], ``flow`` (B, H, W, 2), ``valid`` (B, H, W).
    ``metrics``: the loss's metrics and ``loss``, as floats.

    ``freeze_bn`` (RAFT only, train.py:329-335) keeps every batch norm in
    eval mode: running statistics, none written.  ``clip``: the global
    gradient-norm bound; None takes the ``"clip"`` that ``fetch_optimizer``
    put in the param groups (1.0 if absent).  ``clip_grad_norm_`` divides
    by norm + 1e-6 where optax divides by norm, ~1e-6 relative apart.

    NaN guard (train.py:270-272): on a non-finite loss neither
    ``optimizer.step()`` nor ``scheduler.step()`` runs and the gradients
    are dropped, so parameters, optimizer state and schedule stay as they
    were -- the reference's ``continue``.  Batch-norm running statistics
    were already updated by that step's forward, as JAX's ``new_stats``
    are.

    ``mesh``: data parallelism (see the module's docstring); ``batch`` is
    then this rank's slice (``parallel.shard_batch``), the metrics are the
    global batch's, the NaN guard tests the global loss (every rank skips
    together), and the default mode makes the model's batch norms global
    (``global_batch_norm``, in place).  ``grad_transport="bf16"`` needs
    ``explicit``, as in the JAX package (the pjit path's all-reduce dtype
    is XLA's); on one device it rounds the gradients to bf16, as the JAX
    package's one-device shard_map does.  ``train_step.sent_bytes`` holds
    the bytes of the last step's gradient all-reduce per rank."""
    if grad_transport not in ("f32", "bf16"):
        raise ValueError(f"unknown grad_transport {grad_transport!r}")
    if grad_transport == "bf16" and not explicit:
        raise ValueError(
            "grad_transport='bf16' compresses the cross-device all-reduce: "
            "it requires explicit=True (explicit-collectives mode), as in "
            "the JAX package; the pjit path's all-reduce dtype is not "
            "controllable")
    if freeze_bn and not is_raft:
        raise ValueError(
            "freeze_bn is RAFT-only (train.py:329-335); the conv families' "
            "train flag also controls the multi-scale return structure")
    if clip is None:
        clip = optimizer.param_groups[0].get("clip", 1.0)
    loss_impl = sequence_loss if loss_type == "sequence" else multiscale_epe
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if not explicit:
        global_batch_norm(model, mesh)
    loss_mesh = None if explicit else mesh
    reduction = ("bf16_mean" if grad_transport == "bf16"
                 else "mean" if explicit else "sum")
    bn = [m for m in model.modules()
          if isinstance(m, torch.nn.BatchNorm2d) and m.track_running_stats]

    def train_step(batch: dict) -> dict:
        model.train()
        if freeze_bn:
            _freeze_bn(model)
        img1 = batch["image1"].permute(0, 3, 1, 2)
        img2 = batch["image2"].permute(0, 3, 1, 2)
        if is_raft:
            preds = model(img1 * 255.0, img2 * 255.0, test_mode=False)
        else:
            # the per-level flows the multiscale losses weigh, as JAX's
            # train=norm_train gives them (train_step.py:126-127); batch
            # norm's mode is the module's own
            preds = model(img1, img2, train=True)
        # a single-prediction model (FlowNet2) returns one flow: list() of
        # it would unpack the batch dimension (train_step.py:138-144)
        preds = list(preds) if isinstance(preds, (list, tuple)) else [preds]
        loss, metrics = loss_impl(
            [p.permute(0, 2, 3, 1) for p in preds], batch["flow"],
            batch["valid"], gamma=gamma, flownetc=flownetc, pwc=pwc,
            div_flow=div_flow, flownetc_weighing=flownetc_weighing,
            not_excluding=not_excluding, mesh=loss_mesh)

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        names = list(metrics)
        scalars = torch.stack([loss.detach().float()]
                              + [metrics[k].detach().float() for k in names])
        if mesh is not None or explicit:
            train_step.sent_bytes = reduce_gradients(mesh, params, reduction)
            # the global loss and metrics: the sum of the ranks' shares, or
            # the mean of the ranks' own values
            if explicit:
                all_reduce_mean(mesh, scalars)
                if not freeze_bn:  # the ranks' new running statistics
                    with torch.no_grad():
                        for m in bn:
                            all_reduce_mean(mesh, m.running_mean)
                            all_reduce_mean(mesh, m.running_var)
            else:
                all_reduce_sum(mesh, scalars)
        torch.nn.utils.clip_grad_norm_(params, clip)
        if torch.isfinite(scalars[0]):
            optimizer.step()
            scheduler.step()
        else:
            optimizer.zero_grad(set_to_none=True)
        values = scalars.tolist()
        out = dict(zip(names, values[1:]))
        out["loss"] = values[0]
        return out

    train_step.sent_bytes = 0
    return train_step
