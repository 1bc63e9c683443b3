"""Data parallelism, one process per device (counterpart of
``understanding_flow_robustness_tpu/parallel``): ``launch`` starts the
ranks, ``Mesh`` is a rank's view, and the helpers shard batches, replicate
modules and run the collectives.  The JAX package's spatial sharding
(``parallel/spatial.py``) is ROADMAP A13b."""

from .mesh import (
    Mesh,
    RankFailed,
    all_gather,
    all_reduce_bf16_mean,
    all_reduce_mean,
    all_reduce_sum,
    all_reduce_sum_grad,
    barrier,
    broadcast_object,
    current_mesh,
    gather_objects,
    is_rank0,
    launch,
    make_mesh,
    reduce_gradients,
    replicate,
    shard_batch,
    shard_predict,
)

__all__ = [
    "Mesh",
    "RankFailed",
    "all_gather",
    "all_reduce_bf16_mean",
    "all_reduce_mean",
    "all_reduce_sum",
    "all_reduce_sum_grad",
    "barrier",
    "broadcast_object",
    "current_mesh",
    "gather_objects",
    "is_rank0",
    "launch",
    "make_mesh",
    "reduce_gradients",
    "replicate",
    "shard_batch",
    "shard_predict",
]
