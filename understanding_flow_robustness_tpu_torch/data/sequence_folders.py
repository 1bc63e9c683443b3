"""3-frame sequence dataset over prepared KITTI raw (counterpart of
``understanding_flow_robustness_tpu/data/sequence_folders.py``; reference:
dataset_utils/sequence_folders.py:11-82).

The JAX package seeds and draws from the global ``random`` /
``np.random``; here a ``SequenceFolder`` owns a ``random.Random(seed)``
(``rng``: the sample shuffle, then whatever its transforms draw) and a
``np.random.RandomState(seed)`` (``np_rng``), which draw the same
sequences.  Build the transforms on ``folder.rng`` / ``folder.np_rng`` and
set ``folder.transform`` to continue the JAX package's streams.
"""

from __future__ import annotations

import os
import random
from glob import glob

import numpy as np

from ..flowviz import io as fio


def crawl_folders(folders_list, sequence_length, rng: random.Random):
    """sequence_folders.py:11-30, shuffled by ``rng``."""
    sequence_set = []
    demi = (sequence_length - 1) // 2
    for folder in folders_list:
        cam = os.path.join(folder, "cam.txt")
        intrinsics = (
            np.genfromtxt(cam, delimiter=",").astype(np.float32).reshape(3, 3)
            if os.path.exists(cam) else np.eye(3, dtype=np.float32)
        )
        imgs = sorted(glob(os.path.join(folder, "*.jpg")))
        if len(imgs) < sequence_length:
            continue
        for i in range(demi, len(imgs) - demi):
            sample = {"intrinsics": intrinsics, "tgt": imgs[i], "ref_imgs": []}
            for j in range(-demi, demi + 1):
                if j != 0:
                    sample["ref_imgs"].append(imgs[i + j])
            sequence_set.append(sample)
    rng.shuffle(sequence_set)
    return sequence_set


class SequenceFolder:
    """root/<scene>/0000000.jpg ... + cam.txt; train.txt/val.txt scene
    lists (sequence_folders.py:37-82).  Samples are (tgt, [refs],
    intrinsics) float32 frames, through ``transform`` when one is set."""

    def __init__(self, root, seed=None, train=True, sequence_length=3,
                 transform=None):
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.root = root
        list_path = os.path.join(root, "train.txt" if train else "val.txt")
        with open(list_path) as f:
            scenes = [os.path.join(root, l.strip()) for l in f if l.strip()]
        self.samples = crawl_folders(scenes, sequence_length, self.rng)
        self.transform = transform

    def __getitem__(self, index):
        sample = self.samples[index]
        tgt = fio.read_image(sample["tgt"])
        refs = [fio.read_image(p) for p in sample["ref_imgs"]]
        if self.transform is not None:
            imgs = self.transform([tgt] + refs)
            tgt, refs = imgs[0], imgs[1:]
        return tgt, refs, sample["intrinsics"]

    def __len__(self):
        return len(self.samples)
