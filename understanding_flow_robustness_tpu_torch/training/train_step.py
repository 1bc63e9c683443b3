"""One optimizer step (counterpart of
``understanding_flow_robustness_tpu/training/train_step.py``; reference:
training/train.py:155-287).

Forward with the per-iteration flow list, sequence or multiscale loss,
backward, global-norm clip, the NaN guard, AdamW and the OneCycle step.
The JAX package's data-parallel reduction and bf16 gradient transport
(``axis_name``, ``grad_transport``) are ROADMAP queue A item 13.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.layers import freeze_bn as _freeze_bn
from .losses import multiscale_epe, sequence_loss


def make_train_step(model: torch.nn.Module, optimizer, scheduler,
                    loss_type: str = "sequence", is_raft: bool = False,
                    flownetc: bool = False, pwc: bool = False,
                    gamma: float = 0.8, div_flow: float = 1.0,
                    flownetc_weighing: bool = False, freeze_bn: bool = False,
                    not_excluding: bool = False,
                    clip: Optional[float] = None) -> Callable:
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
    are."""
    if freeze_bn and not is_raft:
        raise ValueError(
            "freeze_bn is RAFT-only (train.py:329-335); the conv families' "
            "train flag also controls the multi-scale return structure")
    if clip is None:
        clip = optimizer.param_groups[0].get("clip", 1.0)
    loss_impl = sequence_loss if loss_type == "sequence" else multiscale_epe
    params = [p for group in optimizer.param_groups for p in group["params"]]

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
            not_excluding=not_excluding)

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, clip)
        if torch.isfinite(loss):
            optimizer.step()
            scheduler.step()
        else:
            optimizer.zero_grad(set_to_none=True)
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out["loss"] = float(loss.detach())
        return out

    return train_step
