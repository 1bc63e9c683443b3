"""Ported model families (RAFT and its FlowNetC-encoder variant, SPyNet,
PWC-Net, the FlowNet family, FlowNet2 and its partial stacks), NCHW
``nn.Module``s."""

from .convert import (
    flax_variables,
    flownet_c_flex_state_dict_from_jax,
    flownet2_state_dict_from_jax,
    flownet_c_state_dict_from_jax,
    flownet_s_state_dict_from_jax,
    load_reference_state_dict,
    load_spynet_dir,
    pwcnet_state_dict_from_jax,
    raft_state_dict_from_jax,
    spynet_state_dict_from_jax,
    state_dict_from_flax,
)
from .flownet2 import (
    FlowNet2,
    FlowNet2CS,
    FlowNet2CSub,
    FlowNet2Single,
    FlowNet2SSub,
    FlowNetFusion,
    FlowNetS2,
    FlowNetSD,
)
from .flownet_family import FlowNetC, FlowNetCFlex, FlowNetS
from .pwcnet import PWCNet
from .raft_model import RAFT, scale_flow_head, upsample_flow_convex
from .registry import (
    FLOWNET_IDS,
    NOT_PORTED,
    FlowModel,
    checkpoint_arg,
    device_arg,
    fetch_model,
    get_feature_map_keys,
    predict_flow,
    predict_flow_differentiable,
    predict_flow_with_features,
)
from .spynet import SpyNet

__all__ = [
    "FLOWNET_IDS",
    "NOT_PORTED",
    "FlowModel",
    "FlowNet2",
    "FlowNet2CS",
    "FlowNet2CSub",
    "FlowNet2SSub",
    "FlowNet2Single",
    "FlowNetC",
    "FlowNetCFlex",
    "FlowNetFusion",
    "FlowNetS",
    "FlowNetS2",
    "FlowNetSD",
    "PWCNet",
    "RAFT",
    "SpyNet",
    "checkpoint_arg",
    "device_arg",
    "fetch_model",
    "flax_variables",
    "flownet2_state_dict_from_jax",
    "flownet_c_flex_state_dict_from_jax",
    "flownet_c_state_dict_from_jax",
    "flownet_s_state_dict_from_jax",
    "get_feature_map_keys",
    "load_reference_state_dict",
    "load_spynet_dir",
    "predict_flow",
    "predict_flow_differentiable",
    "predict_flow_with_features",
    "pwcnet_state_dict_from_jax",
    "raft_state_dict_from_jax",
    "scale_flow_head",
    "spynet_state_dict_from_jax",
    "state_dict_from_flax",
    "upsample_flow_convex",
]
