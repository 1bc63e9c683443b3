"""Ported model families (RAFT so far), NCHW ``nn.Module``s."""

from .convert import load_reference_state_dict, raft_state_dict_from_jax
from .raft_model import RAFT, scale_flow_head, upsample_flow_convex
from .registry import FlowModel, fetch_model, predict_flow

__all__ = [
    "FlowModel",
    "RAFT",
    "fetch_model",
    "load_reference_state_dict",
    "predict_flow",
    "raft_state_dict_from_jax",
    "scale_flow_head",
    "upsample_flow_convex",
]
