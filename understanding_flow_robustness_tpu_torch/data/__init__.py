"""Datasets, transforms and batch padding for evaluation (counterpart of
``understanding_flow_robustness_tpu/data/``; numpy and the port's host
library, no cv2 and no PIL).  The training augmentors, the ``DataLoader``
and ``SequenceFolder`` are not ported yet (ROADMAP A11b)."""

from .datasets import (
    HD1K,
    KITTI,
    ConcatFlowDataset,
    FlowDataset,
    FlyingChairs,
    FlyingThings3D,
    MpiSintel,
    Subset,
    fetch_dataset,
)
from .loader import pad_batch
from .transforms import (
    Compose,
    Normalize,
    RandomCrop,
    RandomHorizontalFlip,
    RandomScaleCrop,
    Scale,
    ToFloat,
    ToFloat01,
    imresize,
)
from .validation import (
    KittiPairDataset,
    ValidationFlowKitti2012,
    ValidationFlowKitti2015,
    ValidationFlowKitti2015MV,
    ValidationSet,
    ValidationSetPair,
    ValidationSintel,
    get_evaluation_set,
)

__all__ = [
    "Compose", "ConcatFlowDataset", "FlowDataset", "FlyingChairs",
    "FlyingThings3D", "HD1K", "KITTI", "KittiPairDataset", "MpiSintel",
    "Normalize", "RandomCrop", "RandomHorizontalFlip", "RandomScaleCrop",
    "Scale", "Subset", "ToFloat", "ToFloat01", "ValidationFlowKitti2012",
    "ValidationFlowKitti2015", "ValidationFlowKitti2015MV", "ValidationSet",
    "ValidationSetPair", "ValidationSintel", "fetch_dataset",
    "get_evaluation_set", "imresize", "pad_batch",
]
