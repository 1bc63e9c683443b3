"""Data and spatial parallelism, one process per device (counterpart of
``understanding_flow_robustness_tpu/parallel``): ``launch`` starts the
ranks, ``Mesh`` is a rank's view (``make_mesh``: the data axis;
``make_2d_mesh``: data x spatial), the helpers shard batches, replicate
modules and run the collectives, and ``spatial`` splits images by height
(``spatial_predict``, ``spatial_shard``, ``shard_rows``)."""

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
    make_2d_mesh,
    make_mesh,
    reduce_gradients,
    replicate,
    shard_batch,
    shard_predict,
)
from .spatial import (
    SPATIAL_AXIS,
    check_spatial_shapes,
    gather_rows,
    shard_rows,
    spatial_context,
    spatial_predict,
    spatial_shard,
)

__all__ = [
    "Mesh",
    "RankFailed",
    "SPATIAL_AXIS",
    "all_gather",
    "all_reduce_bf16_mean",
    "all_reduce_mean",
    "all_reduce_sum",
    "all_reduce_sum_grad",
    "barrier",
    "broadcast_object",
    "check_spatial_shapes",
    "current_mesh",
    "gather_objects",
    "gather_rows",
    "is_rank0",
    "launch",
    "make_2d_mesh",
    "make_mesh",
    "reduce_gradients",
    "replicate",
    "shard_batch",
    "shard_predict",
    "shard_rows",
    "spatial_context",
    "spatial_predict",
    "spatial_shard",
]
