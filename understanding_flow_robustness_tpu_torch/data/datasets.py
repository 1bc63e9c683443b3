"""Flow datasets (counterpart of
``understanding_flow_robustness_tpu/data/datasets.py``; reference:
dataset_utils/datasets.py:16-326).

Numpy-native FlowDataset + MpiSintel / FlyingChairs / FlyingThings3D /
KITTI / HD1K, read through the port's own ``flowviz.io``, and the training
stages' augmented mixes (``fetch_dataset``).  Samples are NHWC numpy:
(img1, img2 uint8->float, flow f32, valid f32), or with ``is_test`` (img1,
img2, extra_info).

An augmenting dataset draws from explicit generators: ``sample(index, rng,
np_rng)`` takes a ``random.Random`` and a ``np.random.RandomState`` (the
``DataLoader`` gives each sample its own); ``dataset[index]`` draws from
the dataset's ``rng`` / ``np_rng``, seeded 0 unless replaced.
"""

from __future__ import annotations

import os
import os.path as osp
import random
from glob import glob

import numpy as np

from ..flowviz import io as fio
from .augmentor import FlowAugmentor, SparseFlowAugmentor


class FlowDataset:
    def __init__(self, aug_params=None, sparse=False, transforms=None):
        self.augmentor = None
        self.sparse = sparse
        if aug_params is not None:
            if sparse:
                self.augmentor = SparseFlowAugmentor(**aug_params)
            else:
                self.augmentor = FlowAugmentor(**aug_params)
        self.rng = random.Random(0)
        self.np_rng = np.random.RandomState(0)
        self.transforms = transforms
        self.is_test = False
        self.flow_list: list[str] = []
        self.image_list: list[list[str]] = []
        self.extra_info: list = []

    def __getitem__(self, index):
        return self.sample(index)

    def sample(self, index, rng: random.Random | None = None,
               np_rng: np.random.RandomState | None = None):
        """Sample ``index``, augmented with draws from ``rng`` / ``np_rng``
        (by default the dataset's own)."""
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

        if self.augmentor is not None:
            rngs = (rng or self.rng, np_rng or self.np_rng)
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid, *rngs)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, *rngs)

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

    def sample(self, index, rng=None, np_rng=None):
        for d in self.datasets:
            if index < len(d):
                return d.sample(index, rng, np_rng)
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

    def sample(self, index, rng=None, np_rng=None):
        return self.dataset.sample(self.indices[index], rng, np_rng)


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
    """Stage -> dataset with the reference's aug params
    (training/utils.py:289-398 -- the reference's own fork of RAFT's
    datasets.py, which changed chairs' min_scale from RAFT's -0.1 to
    -0.2):

      chairs: scale [-0.2, 1.0], flips; trans_rot adds translate 10,
              rot 17 deg, diff_angle 0 (SHARED rotation between frames)
      things: scale [-0.4, 0.8], flips (clean+final passes); trans_rot
              adds translate 10, rot 17 deg, diff_angle 5
      sintel: scale [-0.2, 0.6], flips; mix 100*clean+100*final+200*KITTI
              +5*HD1K(skipped, unsupported)+things
      kitti:  sparse, scale [-0.2, 0.4], no flips
    """
    roots = roots or {}

    def r(key, default):
        return roots.get(key, default)

    def tr(aug, diff_angle):
        # training/utils.py:293-302,313-322: explicit translate/rot/diff
        if trans_rot:
            aug.update(do_trans_rot=True, translate=10, rot_angle=17,
                       diff_angle=diff_angle)
        return aug

    if stage == "chairs":
        aug = tr({"crop_size": image_size, "min_scale": -0.2,
                  "max_scale": 1.0, "do_flip": True}, diff_angle=0)
        return FlyingChairs(aug, split="training",
                            root=r("chairs", "datasets/FlyingChairs_release/data"))
    if stage == "things":
        aug = tr({"crop_size": image_size, "min_scale": -0.4,
                  "max_scale": 0.8, "do_flip": True}, diff_angle=5)
        clean = FlyingThings3D(aug, root=r("things", "datasets/FlyingThings3D"),
                               dstype="frames_cleanpass")
        final = FlyingThings3D(aug, root=r("things", "datasets/FlyingThings3D"),
                               dstype="frames_finalpass")
        return clean + final
    if stage == "sintel":
        aug = {"crop_size": image_size, "min_scale": -0.2, "max_scale": 0.6,
               "do_flip": True}
        things = FlyingThings3D(aug, root=r("things", "datasets/FlyingThings3D"),
                                dstype="frames_cleanpass")
        clean = MpiSintel(aug, split="training", dstype="clean",
                          root=r("sintel", "datasets/Sintel"))
        final = MpiSintel(aug, split="training", dstype="final",
                          root=r("sintel", "datasets/Sintel"))
        kitti = KITTI(
            {"crop_size": image_size, "min_scale": -0.3, "max_scale": 0.5,
             "do_flip": True},
            root=r("kitti", "datasets/KITTI/2015"),
        )
        return 100 * clean + 100 * final + 200 * kitti + things
    if stage == "kitti":
        aug = {"crop_size": image_size, "min_scale": -0.2, "max_scale": 0.4,
               "do_flip": False}
        return KITTI(aug, split="training", root=r("kitti", "datasets/KITTI/2015"))
    raise ValueError(f"unknown stage: {stage}")
