"""Checkpoints in the reference's own PyTorch format (counterpart of
``understanding_flow_robustness_tpu/training/checkpoint.py``; reference:
training/train.py:110-124, 289-300, 349-350).

``<dir>/checkpoint.pth`` holds the model, optimizer and scheduler state
dicts and the step, for resume; ``save_weights`` writes a weights-only
state dict, the reference's ``<name>.pth``, which ``load_weights`` and
``models.load_reference_state_dict`` read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..models.convert import load_reference_state_dict

CHECKPOINT = "checkpoint.pth"


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, optimizer,
                    scheduler, total_steps: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, CHECKPOINT)
    tmp = path + ".tmp"
    torch.save({
        "total_steps": int(total_steps),
        "model_state_dict": model.state_dict(),
        "optimizer_state_dict": optimizer.state_dict(),
        "scheduler_state_dict": scheduler.state_dict(),
    }, tmp)
    os.replace(tmp, path)  # a resume never reads a half-written file


def restore_checkpoint(ckpt_dir: str) -> Optional[dict]:
    """The state ``save_checkpoint`` wrote (tensors on the CPU), or None
    when ``ckpt_dir`` holds no checkpoint."""
    path = os.path.join(ckpt_dir, CHECKPOINT)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def save_weights(path: str, model: torch.nn.Module) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict(), path)


def load_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a weights-only ``.pth`` (or a reference checkpoint) strictly."""
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    return model
