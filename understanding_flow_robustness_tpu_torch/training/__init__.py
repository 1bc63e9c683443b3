"""Training: losses, optimizer, train step, checkpoints and the loop."""

from . import checkpoint
from .losses import MAX_FLOW, multiscale_epe, sequence_loss
from .optim import fetch_optimizer
from .train_step import make_train_step
from .trainer import TrainConfig, train

__all__ = [
    "MAX_FLOW",
    "TrainConfig",
    "checkpoint",
    "fetch_optimizer",
    "make_train_step",
    "multiscale_epe",
    "sequence_loss",
    "train",
]
