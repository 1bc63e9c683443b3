"""Training: losses, optimizer, train step, checkpoints and the loop.

The JAX package's data-parallel step (``shard_train_step`` over a mesh) is
``make_train_step(..., mesh=, explicit=, grad_transport=)`` in each rank of
``parallel.launch``; ``train`` launches the ranks itself for
``TrainConfig.n_devices`` > 1 (``n_devices_for`` resolves the default)."""

from . import checkpoint
from .losses import MAX_FLOW, multiscale_epe, sequence_loss
from .optim import fetch_optimizer
from .train_step import make_train_step
from .trainer import TrainConfig, n_devices_for, train

__all__ = [
    "MAX_FLOW",
    "TrainConfig",
    "checkpoint",
    "fetch_optimizer",
    "make_train_step",
    "multiscale_epe",
    "n_devices_for",
    "sequence_loss",
    "train",
]
