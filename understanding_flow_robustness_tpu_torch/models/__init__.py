"""Ported model families (RAFT and its FlowNetC-encoder variant, SPyNet,
PWC-Net), NCHW ``nn.Module``s."""

from .convert import (
    load_reference_state_dict,
    load_spynet_dir,
    pwcnet_state_dict_from_jax,
    raft_state_dict_from_jax,
    spynet_state_dict_from_jax,
)
from .pwcnet import PWCNet
from .raft_model import RAFT, scale_flow_head, upsample_flow_convex
from .registry import (
    NOT_PORTED,
    FlowModel,
    fetch_model,
    get_feature_map_keys,
    predict_flow,
    predict_flow_differentiable,
)
from .spynet import SpyNet

__all__ = [
    "NOT_PORTED",
    "FlowModel",
    "PWCNet",
    "RAFT",
    "SpyNet",
    "fetch_model",
    "get_feature_map_keys",
    "load_reference_state_dict",
    "load_spynet_dir",
    "predict_flow",
    "predict_flow_differentiable",
    "pwcnet_state_dict_from_jax",
    "raft_state_dict_from_jax",
    "scale_flow_head",
    "spynet_state_dict_from_jax",
    "upsample_flow_convex",
]
