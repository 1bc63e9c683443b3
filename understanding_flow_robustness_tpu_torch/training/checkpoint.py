"""Checkpoints in the reference's own PyTorch format (counterpart of
``understanding_flow_robustness_tpu/training/checkpoint.py``; reference:
training/train.py:110-124, 289-300, 349-350).

``<dir>/checkpoint.pth`` holds the model, optimizer and scheduler state
dicts and the step, for resume; ``save_weights`` writes a weights-only
state dict, the reference's ``<name>.pth``, which ``load_weights`` and
``models.load_reference_state_dict`` read.

The JAX package's flax ``.msgpack`` files are read and written too, by the
port's own codec (``utils/msgpack.py``): ``load_variables`` restores
either flavour the JAX package writes (the full variables of
``ufr-convert``, or the params-only export of its trainer) into a port
module, and ``save_weights_msgpack`` writes the params-only flavour, as
the JAX package's ``save_weights`` does (training/checkpoint.py:51-85).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models.convert import (
    flax_shapes,
    flax_variables,
    load_reference_state_dict,
    state_dict_from_flax,
)
from ..utils import msgpack

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


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):  # a bf16 leaf
        return leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def save_weights_msgpack(path: str, model: torch.nn.Module) -> None:
    """The params-only ``.msgpack`` of ``model``: the bytes the JAX
    package's ``save_weights`` writes for the same weights (flax
    ``to_bytes`` of the params)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack.packb(flax_variables(model)["params"])
    with open(path, "wb") as f:
        f.write(data)


def load_variables(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Restore a flax ``.msgpack`` into ``model`` strictly.  Either
    flavour of the JAX package's ``load_variables`` is taken: the whole
    variables dict (``ufr-convert``'s output, with the batch-norm
    statistics) or params only (the trainer's export), which leaves the
    module's batch-norm buffers as they are, at their init for a fresh
    module (JAX's template keeps its init mean 0, var 1 alike).  Every
    leaf's path and shape must be the model's; a missing or extra one
    raises."""
    # a writable buffer: the arrays decoded from it are writable views
    data = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(data)
    tree = msgpack.unpackb(data)
    template = flax_shapes(model)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax variables tree")
    if set(tree) == set(template):
        variables = tree
    elif set(tree) == set(template["params"]):
        # the module's own batch-norm statistics fill the other collections
        variables = dict(flax_variables(model), params=tree) \
            if len(template) > 1 else {"params": tree}
    else:
        raise ValueError(
            f"{path}: top-level keys {sorted(tree)[:8]} are neither the "
            f"model's collections {sorted(template)} nor its params "
            f"{sorted(template['params'])[:8]}")
    want, got = _flatten(template), _flatten(variables)
    missing, extra = set(want) - set(got), set(got) - set(want)
    if missing or extra:
        raise ValueError(f"{path}: checkpoint mismatch: missing="
                         f"{sorted(missing)[:8]} extra={sorted(extra)[:8]}")
    for k, v in got.items():
        if tuple(v.shape) != want[k]:
            raise ValueError(f"{path}: shape mismatch at {'/'.join(k)}: "
                             f"{want[k]} vs {tuple(v.shape)}")
    variables = {coll: {} for coll in variables}
    for k, v in got.items():
        node = variables
        for p in k[:-1]:
            node = node.setdefault(p, {})
        node[k[-1]] = _f32(v)
    model.load_state_dict(state_dict_from_flax(model, variables),
                          strict=True)
    return model
