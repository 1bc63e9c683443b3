"""Weight bridge between reference checkpoints, the JAX package's flax
variables and the port (counterpart of
``understanding_flow_robustness_tpu/models/convert.py``).

Port modules carry the reference's parameter names, so a reference
checkpoint is a port ``state_dict`` once its wrappers are removed
(``load_reference_state_dict``), and the JAX package's ``convert_raft``
maps a port ``state_dict`` to flax variables.  ``raft_state_dict_from_jax``
is the inverse of ``convert_raft``.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def load_reference_state_dict(path: str) -> dict:
    """A reference checkpoint file as a plain state dict: unwraps
    ``{"state_dict": ...}`` / ``{"model_state_dict": ...}`` / ``{"model":
    ...}``, strips the DataParallel ``module.`` prefix and drops
    ``num_batches_tracked`` (``convert.py::to_numpy_state_dict``).  Load
    the result with ``load_state_dict(..., strict=True)``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model_state_dict", "model"):
        if wrapper in obj and hasattr(obj[wrapper], "items"):
            obj = obj[wrapper]
            break
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = v
    return out


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def raft_state_dict_from_jax(variables) -> dict:
    """Flax RAFT variables (nested dicts of arrays) -> reference/port
    state dict of f32 tensors; the inverse of ``convert_raft``.

    HWIO kernels go back to OIHW; batch-norm scale/bias/mean/var to
    weight/bias/running_mean/running_var; ``layerX_Y`` to ``layerX.Y``,
    ``mask_0``/``mask_2`` to ``mask.0``/``mask.2``, the residual
    ``downsample`` conv to ``downsample.0`` and its ``norm3`` to both
    ``norm3`` and ``downsample.1`` (convert.py:309-313, 328)."""
    sd = {}
    for path, val in _flatten(variables).items():
        coll, *names, leaf = path
        if (coll, leaf) not in _LEAF:
            raise KeyError(f"unmapped flax variable: {'/'.join(path)}")
        arr = np.array(val, np.float32)  # a writable copy
        if leaf == "kernel":
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        mod = ".".join(names)
        mod = re.sub(r"layer(\d)_(\d)", r"layer\1.\2", mod)
        mod = re.sub(r"mask_(\d)", r"mask.\1", mod)
        mod = re.sub(r"downsample$", "downsample.0", mod)
        attr = _LEAF[(coll, leaf)]
        sd[f"{mod}.{attr}"] = torch.from_numpy(arr)
        if mod.endswith(".norm3"):
            sd[f"{mod[:-len('norm3')]}downsample.1.{attr}"] = torch.from_numpy(arr)
    return sd
