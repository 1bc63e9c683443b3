"""Batched data loading (counterpart of
``understanding_flow_robustness_tpu/data/loader.py``): ``pad_batch`` and a
shuffled, batched ``DataLoader`` whose samples are decoded and augmented
on a thread pool.  The readers and augmentors spend their time in the
host library, whose ctypes calls release the GIL, so the threads run in
parallel.

The JAX package's loader runs ``__getitem__`` on threads that share the
global ``random`` / ``np.random``, so which draws a sample gets depends on
thread timing.  This one gives every sample of an epoch its own
``random.Random`` and ``np.random.RandomState``, seeded in batch order
from a stream of its own (``RandomState([seed, 1])``), separate from the
shuffle's ``RandomState(seed)``: the batch order stays the JAX package's,
and the batches are the same for every worker count.
"""

from __future__ import annotations

import concurrent.futures
import random
from typing import Iterator

import numpy as np

from ..native import batch_f32_pad
from ..ops.interp import compute_pad


def pad_batch(img1, img2, flow, valid, multiple: int = 8, mode: str = "kitti"):
    """Replicate-pad NHWC images (and zero-pad flow / valid) to a multiple
    of ``multiple`` -- RAFT's InputPadder (models/raft/utils/utils.py:
    7-30) on the host.  Returns (img1, img2, flow, valid, pad)."""
    h, w = img1.shape[1:3]
    t, b, l, r = compute_pad(h, w, mode=mode, multiple=multiple)
    if (t, b, l, r) == (0, 0, 0, 0):
        return img1, img2, flow, valid, (t, b, l, r)
    oh, ow = h + t + b, w + l + r
    img1 = batch_f32_pad(np.asarray(img1, np.float32), oh, ow, t, l)
    img2 = batch_f32_pad(np.asarray(img2, np.float32), oh, ow, t, l)
    if flow is not None:
        flow = batch_f32_pad(np.asarray(flow, np.float32), oh, ow, t, l,
                             zero=True)
    if valid is not None:
        valid = batch_f32_pad(
            np.asarray(valid, np.float32)[..., None], oh, ow, t, l,
            zero=True)[..., 0]
    return img1, img2, flow, valid, (t, b, l, r)


class DataLoader:
    """Shuffled, batched, threaded loader over an indexable dataset,
    yielding dict batches of stacked numpy arrays (data/loader.py:42-118)
    as the train CLI runs the JAX package's: one shuffle per epoch from
    ``RandomState(seed)`` over the loader's life, the last partial batch
    dropped, no padding, the next batch's samples decoding while the
    current one is consumed."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 4,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.rng = np.random.RandomState(seed)
        self.aug_rng = np.random.RandomState([seed, 1])

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _collate(self, samples):
        # divided on the host, in numpy, as the JAX package does (a CUDA
        # division by a Python number multiplies by its reciprocal)
        return {
            "image1": np.stack([s[0] for s in samples]) / 255.0,
            "image2": np.stack([s[1] for s in samples]) / 255.0,
            "flow": np.stack([s[2] for s in samples]),
            "valid": np.stack([s[3] for s in samples]),
        }

    def _get(self, index, seed):
        sample = getattr(self.dataset, "sample", None)
        if sample is None:
            return self.dataset[index]
        return sample(index, random.Random(seed), np.random.RandomState(seed))

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        self.rng.shuffle(order)
        seeds = self.aug_rng.randint(0, 2 ** 32, size=len(order),
                                     dtype=np.uint64)
        batches = [
            [(int(i), int(s)) for i, s in zip(order[k : k + self.batch_size],
                                              seeds[k : k + self.batch_size])]
            for k in range(0, len(self) * self.batch_size, self.batch_size)
        ]

        if self.num_workers <= 0:
            for batch in batches:
                yield self._collate([self._get(i, s) for i, s in batch])
            return

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            # double-buffered prefetch: per-sample futures (no nested pool
            # usage -- a batch-level task map()ing on the same pool
            # deadlocks)
            def submit(batch):
                return [pool.submit(self._get, i, s) for i, s in batch]

            pending = submit(batches[0]) if batches else None
            for batch in batches[1:]:
                nxt = submit(batch)
                yield self._collate([f.result() for f in pending])
                pending = nxt
            if pending is not None:
                yield self._collate([f.result() for f in pending])
