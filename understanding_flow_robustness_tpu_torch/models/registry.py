"""Model factory and inference API (counterpart of
``understanding_flow_robustness_tpu/models/registry.py``).

Ported so far: the RAFT IDs, SpyNet and the two PWC-Net IDs.  The other
model IDs of the JAX registry raise with the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch
from torch import nn

from .convert import load_reference_state_dict, load_spynet_dir
from .layers import init_like_flax
from .pwcnet import PWCNet
from .raft_model import RAFT
from .spynet import SpyNet


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    build: Callable[..., nn.Module]
    is_raft: bool = False
    # the input's H and W must be multiples of this (registry.py:54)
    size_multiple: int = 64


_SPECS: dict = {
    # registry.py:92-95
    "SpyNet": ModelSpec(lambda **kw: SpyNet(**{"nlevels": 6, **kw}),
                        size_multiple=32),
    # registry.py:96-106: bf16 compute, f32 flow heads
    "PWCNet": ModelSpec(
        lambda **kw: PWCNet(**{"mixed_precision": True, **kw})),
    "PWCNet_adv_ifgsm_l2_002": ModelSpec(
        lambda **kw: PWCNet(**{"mixed_precision": True, **kw})),
    # registry.py:107-110: the bench's headline configuration
    "RAFT": ModelSpec(lambda **kw: RAFT(**{"mixed_precision": True, **kw}),
                      is_raft=True, size_multiple=8),
    # registry.py:119-125
    "RAFT_adv_kitti2012_ifgsm_l2_002": ModelSpec(
        lambda **kw: RAFT(**{"mixed_precision": False, **kw}),
        is_raft=True, size_multiple=8),
}

# model IDs of the JAX registry that the port does not build yet, by the
# ROADMAP item that ports them
NOT_PORTED = {
    "FlowNetS": "A7", "FlowNetC": "A7", "FlowNetC_larger_field": "A7",
    "FlowNetCFlexLarger_k3_reps3": "A7",
    "FlowNetCFlexLarger_k3_reps3_adv_ifgsm_l2_002": "A7",
    "FlowNetCFlexLarger_k5_reps0": "A7",
    "FlowNet2": "A9",
    "RAFT_FlowNetCEncoder_WoContext": "A10",
}


@dataclasses.dataclass
class FlowModel:
    """A built model on its device; ``fetch_model`` returns it in eval
    mode, and the trainer switches the module's modes."""

    name: str
    module: nn.Module
    device: torch.device
    is_raft: bool = True
    size_multiple: int = 8

    def predict(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return predict_flow(self, img1, img2)


def predict_flow(model: FlowModel, img1: torch.Tensor,
                 img2: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, H, W, 2) full-resolution flow
    (models/utils_model.py:627-681).  RAFT takes [0, 255] in test mode;
    SpyNet and PWC-Net take the [0, 1] images (JAX registry.py:182-191)."""
    with torch.inference_mode():
        a = img1.permute(0, 3, 1, 2)
        b = img2.permute(0, 3, 1, 2)
        if model.is_raft:
            _, flow = model.module(a * 255.0, b * 255.0)
        else:
            flow = model.module(a, b)
        return flow.permute(0, 2, 3, 1)


def _pretrained_state_dict(name: str, path: str) -> dict:
    if name == "SpyNet" and os.path.isdir(path):
        return load_spynet_dir(path)
    return load_reference_state_dict(path)


def fetch_model(name: str, pretrained_path: Optional[str] = None,
                device="cuda", seed: int = 0, **model_kwargs) -> FlowModel:
    """Build ``name`` on ``device`` (the card unless the caller asks for
    the CPU) with seeded random weights (``torch.Generator`` seeded with
    ``seed``, the JAX package's init distribution), or load reference
    weights strictly when ``pretrained_path`` is given: a checkpoint file,
    or for SpyNet the directory of its per-level weight files."""
    if name not in _SPECS:
        item = NOT_PORTED.get(name)
        raise KeyError(
            f"model '{name}' is not ported yet"
            + (f" (ROADMAP {item})" if item else "")
            + f"; ported: {sorted(_SPECS)}")
    spec: ModelSpec = _SPECS[name]
    module = spec.build(**model_kwargs)
    init_like_flax(module, torch.Generator().manual_seed(seed))
    if pretrained_path is not None:
        module.load_state_dict(_pretrained_state_dict(name, pretrained_path),
                               strict=True)
    device = torch.device(device)
    return FlowModel(name=name, module=module.to(device).eval(),
                     device=device, is_raft=spec.is_raft,
                     size_multiple=spec.size_multiple)
