"""Data pipelines: datasets, augmentors, transforms, loaders (counterpart
of ``understanding_flow_robustness_tpu/data/``; numpy and the port's host
library, no cv2 and no PIL)."""

import os

from .augmentor import ColorJitter, FlowAugmentor, SparseFlowAugmentor
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
from .loader import DataLoader, pad_batch
from .sequence_folders import SequenceFolder, crawl_folders
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
    "ColorJitter", "Compose", "ConcatFlowDataset", "DataLoader",
    "FlowAugmentor", "FlowDataset", "FlyingChairs", "FlyingThings3D",
    "HD1K", "KITTI", "KittiPairDataset", "MpiSintel", "Normalize",
    "RandomCrop", "RandomHorizontalFlip", "RandomScaleCrop", "Scale",
    "SequenceFolder", "SparseFlowAugmentor", "Subset", "ToFloat",
    "ToFloat01", "ValidationFlowKitti2012", "ValidationFlowKitti2015",
    "ValidationFlowKitti2015MV", "ValidationSet", "ValidationSetPair",
    "ValidationSintel", "crawl_folders", "fetch_dataset", "fixtures_dir",
    "get_evaluation_set", "imresize", "pad_batch",
]


def fixtures_dir(name: str) -> str:
    """The path of a committed fixture tree under ``data/fixtures/``
    (``kitti_raw_jpeg``: a prepared KITTI-raw scene of JPEG frames)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", name)
