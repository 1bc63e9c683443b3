"""Model factory and inference API (counterpart of
``understanding_flow_robustness_tpu/models/registry.py``).

Only the RAFT IDs are ported so far; the other model IDs wait on ROADMAP
queue A.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from .convert import load_reference_state_dict
from .layers import init_like_flax
from .raft_model import RAFT

_SPECS: dict = {
    # registry.py:107-110: the bench's headline configuration
    "RAFT": lambda **kw: RAFT(**{"mixed_precision": True, **kw}),
    # registry.py:119-125
    "RAFT_adv_kitti2012_ifgsm_l2_002":
        lambda **kw: RAFT(**{"mixed_precision": False, **kw}),
}


@dataclasses.dataclass
class FlowModel:
    """A built model on its device; ``fetch_model`` returns it in eval
    mode, and the trainer switches the module's modes."""

    name: str
    module: nn.Module
    device: torch.device
    is_raft: bool = True  # every ported ID is a RAFT (registry.py:136)

    def predict(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return predict_flow(self, img1, img2)


def predict_flow(model: FlowModel, img1: torch.Tensor,
                 img2: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, H, W, 2) full-resolution flow
    (models/utils_model.py:627-681; RAFT takes [0, 255] in test mode)."""
    with torch.inference_mode():
        a = img1.permute(0, 3, 1, 2) * 255.0
        b = img2.permute(0, 3, 1, 2) * 255.0
        _, flow_up = model.module(a, b)
        return flow_up.permute(0, 2, 3, 1)


def fetch_model(name: str, pretrained_path: Optional[str] = None,
                device="cpu", seed: int = 0, **model_kwargs) -> FlowModel:
    """Build ``name`` with seeded random weights (``torch.Generator``
    seeded with ``seed``, the JAX package's init distribution), or load a
    reference checkpoint file strictly when ``pretrained_path`` is given."""
    if name not in _SPECS:
        raise KeyError(
            f"model '{name}' is not ported yet (ported: {sorted(_SPECS)}); "
            "the other model IDs are ROADMAP queue A items")
    build: Callable = _SPECS[name]
    module = build(**model_kwargs)
    init_like_flax(module, torch.Generator().manual_seed(seed))
    if pretrained_path is not None:
        module.load_state_dict(load_reference_state_dict(pretrained_path),
                               strict=True)
    device = torch.device(device)
    return FlowModel(name=name, module=module.to(device).eval(), device=device)
