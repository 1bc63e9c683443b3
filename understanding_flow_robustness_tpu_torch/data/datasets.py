"""Flow datasets (counterpart of
``understanding_flow_robustness_tpu/data/datasets.py``; reference:
dataset_utils/datasets.py:16-326).

Numpy-native FlowDataset + MpiSintel / FlyingChairs / FlyingThings3D /
KITTI / HD1K, read through the port's own ``flowviz.io``.  Samples are NHWC
numpy: (img1, img2 uint8->float, flow f32, valid f32), or with
``is_test`` (img1, img2, extra_info).  The training augmentors
(``aug_params``) and the stage mixes of ``fetch_dataset`` are not ported
yet (ROADMAP A11b): the datasets serve evaluation (``aug_params=None``) and
``transforms``.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob

import numpy as np

from ..flowviz import io as fio

_A11B = "the training augmentors are not ported yet (ROADMAP A11b)"


class FlowDataset:
    def __init__(self, aug_params=None, sparse=False, transforms=None):
        if aug_params is not None:
            raise NotImplementedError(f"aug_params: {_A11B}")
        self.sparse = sparse
        self.transforms = transforms
        self.is_test = False
        self.flow_list: list[str] = []
        self.image_list: list[list[str]] = []
        self.extra_info: list = []

    def __getitem__(self, index):
        if self.is_test:
            img1 = np.array(fio.read_gen(self.image_list[index][0]))
            img2 = np.array(fio.read_gen(self.image_list[index][1]))
            img1 = img1.astype(np.uint8)[..., :3].astype(np.float32)
            img2 = img2.astype(np.uint8)[..., :3].astype(np.float32)
            return img1, img2, self.extra_info[index]

        index = index % len(self.image_list)
        valid = None
        if self.sparse:
            flow, valid = fio.read_flow_png(self.flow_list[index])
        else:
            flow = fio.read_gen(self.flow_list[index])

        img1 = np.array(fio.read_gen(self.image_list[index][0])).astype(np.uint8)
        img2 = np.array(fio.read_gen(self.image_list[index][1])).astype(np.uint8)
        flow = np.array(flow).astype(np.float32)

        if img1.ndim == 2:  # grayscale tiling (datasets.py:66-72)
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]

        if self.transforms is not None:
            img1, img2 = self.transforms([img1, img2])
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
            return img1, img2, flow, valid.astype(np.float32)

        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        if valid is not None:
            valid = np.asarray(valid, np.float32)
        else:
            valid = (
                (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
            ).astype(np.float32)
        return img1, img2, flow, valid

    def __rmul__(self, v: int) -> "FlowDataset":
        self.flow_list = v * self.flow_list
        self.image_list = v * self.image_list
        return self

    def __len__(self):
        return len(self.image_list)

    def __add__(self, other: "FlowDataset") -> "ConcatFlowDataset":
        return ConcatFlowDataset([self, other])


class ConcatFlowDataset(FlowDataset):
    """torch ConcatDataset stand-in for the C+T+K+S+H training mixes."""

    def __init__(self, datasets):
        super().__init__()
        self.datasets = []
        for d in datasets:
            if isinstance(d, ConcatFlowDataset):
                self.datasets.extend(d.datasets)
            else:
                self.datasets.append(d)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, index):
        for d in self.datasets:
            if index < len(d):
                return d[index]
            index -= len(d)
        raise IndexError

    def __add__(self, other):
        return ConcatFlowDataset(self.datasets + [other])


class Subset:
    """torch.utils.data.Subset stand-in: a fixed index view of a dataset
    (used by the trainer's --online_subset, training/utils.py:275-276)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index):
        return self.dataset[self.indices[index]]


class MpiSintel(FlowDataset):
    """datasets.py:111-129."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean"):
        super().__init__(aug_params)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        if split == "test":
            self.is_test = True
        for scene in sorted(os.listdir(image_root)):
            image_list = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(image_list) - 1):
                self.image_list += [[image_list[i], image_list[i + 1]]]
                self.extra_info += [(scene, i)]
            if split != "test":
                self.flow_list += sorted(glob(osp.join(flow_root, scene, "*.flo")))


class FlyingChairs(FlowDataset):
    """datasets.py:132-147: split via the 22872-line chairs_split.txt."""

    def __init__(self, aug_params=None, split="train",
                 root="datasets/FlyingChairs_release/data",
                 split_file="datasets/chairs_split.txt"):
        super().__init__(aug_params)
        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        assert len(images) // 2 == len(flows)
        split_list = np.loadtxt(split_file, dtype=np.int32)
        for i in range(len(flows)):
            xid = split_list[i]
            if (split == "training" and xid == 1) or (
                split == "validation" and xid == 2
            ):
                self.flow_list += [flows[i]]
                self.image_list += [[images[2 * i], images[2 * i + 1]]]


class FlyingThings3D(FlowDataset):
    """datasets.py:150-177 (left cam, into_future + into_past)."""

    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass", transforms=None):
        super().__init__(aug_params, transforms=transforms)
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
                flow_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted(
                    osp.join(f, direction, cam) for f in flow_dirs
                )
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list += [[images[i], images[i + 1]]]
                            self.flow_list += [flows[i]]
                        else:
                            self.image_list += [[images[i + 1], images[i]]]
                            self.flow_list += [flows[i + 1]]


class KITTI(FlowDataset):
    """datasets.py:180-196 (sparse flow_occ GT)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI/2015"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info += [[osp.basename(img1)]]
            self.image_list += [[img1, img2]]
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    """datasets.py:199-221 — marked NotImplementedError in the reference
    (its constructor raises after globbing); kept as an explicit stub."""

    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)
        raise NotImplementedError(
            "HD1K is not supported (reference raises too, datasets.py:221)"
        )


def fetch_dataset(stage: str, image_size, trans_rot: bool = False,
                  roots: dict | None = None):
    """The training stages' augmented mixes (training/utils.py:289-398):
    not ported yet, they need the augmentors."""
    raise NotImplementedError(f"fetch_dataset('{stage}'): {_A11B}")
