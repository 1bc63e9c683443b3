"""Model factory and inference API (counterpart of
``understanding_flow_robustness_tpu/models/registry.py``).

Every model ID of the JAX registry is ported: the three RAFT IDs, SpyNet,
the two PWC-Net IDs, the six FlowNet-family IDs and FlowNet2.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Optional

import torch
from torch import nn

from .convert import load_reference_state_dict, load_spynet_dir
from .flownet2 import FlowNet2, FlowNetS2
from .flownet_family import FlowNetC, FlowNetCFlex
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
    # registry.py:58-91: the FlowNet family, f32
    "FlowNetS": ModelSpec(lambda **kw: FlowNetS2(**kw)),
    "FlowNetC": ModelSpec(lambda **kw: FlowNetC(**{"div_flow": 20.0, **kw})),
    "FlowNetCFlexLarger_k3_reps3": ModelSpec(
        lambda **kw: FlowNetCFlex(**{"kernel_size": 3, "number_of_reps": 3,
                                     **kw})),
    "FlowNetCFlexLarger_k3_reps3_adv_ifgsm_l2_002": ModelSpec(
        lambda **kw: FlowNetCFlex(**{"kernel_size": 3, "number_of_reps": 3,
                                     **kw})),
    "FlowNetCFlexLarger_k5_reps0": ModelSpec(
        lambda **kw: FlowNetCFlex(**{"kernel_size": 5, "number_of_reps": 0,
                                     "stage_names": "flat", **kw})),
    # training's --larger_field variant, under its own checkpoint names
    "FlowNetC_larger_field": ModelSpec(
        lambda **kw: FlowNetCFlex(**{"kernel_size": 5, "number_of_reps": 1,
                                     "stage_names": "larger_field", **kw})),
    # registry.py:66-68: the 5-net cascade, f32 (bf16 drifts 3.57 %)
    "FlowNet2": ModelSpec(lambda **kw: FlowNet2(**kw)),
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
    # registry.py:111-118
    "RAFT_FlowNetCEncoder_WoContext": ModelSpec(
        lambda **kw: RAFT(**{"flownetc_encoder": True,
                             "no_separate_context": True,
                             "mixed_precision": True, **kw}),
        is_raft=True, size_multiple=8),
    # registry.py:119-125
    "RAFT_adv_kitti2012_ifgsm_l2_002": ModelSpec(
        lambda **kw: RAFT(**{"mixed_precision": False, **kw}),
        is_raft=True, size_multiple=8),
}

# model IDs of the JAX registry that the port does not build yet, by the
# ROADMAP item that ports them
NOT_PORTED: dict = {}

# the FlowNet-family IDs (ROADMAP A7): FlowNetS and the FlowNetC family
FLOWNET_IDS = ("FlowNetS", "FlowNetC", "FlowNetC_larger_field",
               "FlowNetCFlexLarger_k3_reps3",
               "FlowNetCFlexLarger_k3_reps3_adv_ifgsm_l2_002",
               "FlowNetCFlexLarger_k5_reps0")

# families whose feature taps the JAX package exposes and the port does not
# yet, by the ROADMAP item that ports them
_TAPS_NOT_PORTED = {"PWC": "A9"}


def get_feature_map_keys(name: str) -> list:
    """The keys of the ``return_features`` dict of model ``name``
    (registry.py:315-348).  RAFT: the fmaps, the four pyramid levels, the
    context and, for each of the 12 iterations, the lookup, the hidden
    state, the motion encoder's taps and the upsampled flow.  The FlowNetC
    family: the siamese encoder's maps, the raw correlation, conv_redir and
    conv3_1 (registry.py:329-331).  SpyNet, FlowNetS and FlowNet2 expose
    none (FlowNet2's ``return_features`` gives an empty dict).  PWC-Net raises with the ROADMAP item that ports its taps."""
    if name not in _SPECS and name not in NOT_PORTED:
        raise KeyError(f"unknown model '{name}'")
    if name.startswith("RAFT"):
        keys = ["fmap1", "fmap2"] + [f"corr_pyramid_{i}" for i in range(4)]
        keys += ["net", "inp"]
        for i in range(12):
            keys += [f"idx_corr_vol_{i}", f"net_{i}", f"motion_features_{i}",
                     f"cor1_{i}", f"cor_{i}", f"cor_flo_{i}", f"flow_pred_{i}"]
        return keys
    if "FlowNetC" in name:
        return ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                "corr", "conv_redir", "conv3_1"]
    for family, item in _TAPS_NOT_PORTED.items():
        if family in name:
            raise NotImplementedError(
                f"the feature taps of '{name}' are not ported yet (ROADMAP "
                f"{item})")
    return []


@dataclasses.dataclass
class FlowModel:
    """A built model on its device; ``fetch_model`` returns it in eval
    mode, and the trainer switches the module's modes."""

    name: str
    module: nn.Module
    device: torch.device
    is_raft: bool = True
    size_multiple: int = 8

    def predict(self, img1: torch.Tensor, img2: torch.Tensor,
                overrides: Optional[dict] = None) -> torch.Tensor:
        return predict_flow(self, img1, img2, overrides)


def _forward(model: FlowModel, img1: torch.Tensor, img2: torch.Tensor,
             overrides: Optional[dict] = None) -> torch.Tensor:
    a = img1.permute(0, 3, 1, 2)
    b = img2.permute(0, 3, 1, 2)
    if model.is_raft:  # (flow_low, flow_up), or with taps (..., feats)
        flow = model.module(a * 255.0, b * 255.0)[1]
    else:
        kw = {} if overrides is None else {"overrides": overrides}
        flow = model.module(a, b, **kw)
        if isinstance(flow, tuple):  # with taps: (flow, feats)
            flow = flow[0]
    return flow.permute(0, 2, 3, 1)


def predict_flow(model: FlowModel, img1: torch.Tensor, img2: torch.Tensor,
                 overrides: Optional[dict] = None) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, H, W, 2) flow at the model's
    output resolution (full, but H/4 x W/4 for the JAX package's FlowNetS;
    models/utils_model.py:627-681), the serving call, under
    ``torch.inference_mode()``.  RAFT takes [0, 255] in test mode; the
    others take the [0, 1] images (JAX registry.py:182-191).  ``overrides``
    (the FlowNetC family only, NCHW tensors by tap name) are injected at
    their taps, as the JAX ``FlowModel.predict(..., overrides)`` does."""
    with torch.inference_mode():
        return _forward(model, img1, img2, overrides)


def predict_flow_differentiable(model: FlowModel, img1: torch.Tensor,
                                img2: torch.Tensor,
                                overrides: Optional[dict] = None
                                ) -> torch.Tensor:
    """``predict_flow`` with autograd on, differentiable in the images: the
    attacks' forward (the JAX package's ``FlowModel.predict_fn``,
    registry.py:155-171).  The module runs in eval mode (RAFT in test mode,
    images x255) with its parameters frozen while it runs: like
    ``jax.grad(argnums=(0, 1))``, a backward then computes only the images'
    gradients and no convolution's weight gradient.  The module's mode and
    its parameters' ``requires_grad`` are restored afterwards."""
    module = model.module
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    training = module.training
    module.eval()
    try:
        for p in params:
            p.requires_grad_(False)
        with torch.enable_grad():
            return _forward(model, img1, img2, overrides)
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
        module.train(training)


def device_arg(name: str) -> str:
    """A CLI's ``--device`` as a torch device name: ``gpu`` means ``cuda``;
    any other name passes through (no fallback)."""
    return {"gpu": "cuda"}.get(name.lower(), name.lower())


def checkpoint_arg(path: Optional[str], name: str) -> Optional[str]:
    """A CLI's ``--pretrained_path`` for ``fetch_model`` (the JAX package's
    ``checkpoint_arg``): a checkpoint file (or SpyNet's weight directory)
    passes through; a missing path means seeded random weights, with a
    warning unless it is the default.  The JAX package's zoo directory with
    per-model file names is not ported: pass the file itself."""
    if path and os.path.isfile(path):
        return path
    if path and os.path.isdir(path):
        if name == "SpyNet":
            return path
        raise NotImplementedError(
            f"--pretrained_path {path!r} is a directory: pass the "
            f"checkpoint file of {name} itself")
    if path and path != "pretrained_models":
        print(f"WARNING: pretrained path '{path}' not found; using random "
              "init", file=sys.stderr)
    return None


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
    or for SpyNet the directory of its per-level weight files.
    ``model_kwargs`` go to the model, e.g. ``iters``, ``mixed_precision``,
    and for RAFT ``corr_impl`` and ``return_features``."""
    if name not in _SPECS:
        item = NOT_PORTED.get(name)
        raise KeyError(
            (f"model '{name}' is not ported yet (ROADMAP {item})" if item
             else f"unknown model '{name}'")
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
