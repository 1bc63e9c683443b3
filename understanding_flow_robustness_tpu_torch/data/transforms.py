"""List-coherent transforms (counterpart of
``understanding_flow_robustness_tpu/data/transforms.py``; reference:
dataset_utils/custom_transforms.py).

These operate on lists of numpy HWC images so that random parameters stay
coherent across the frames of a sample.  ``imresize`` is PIL's bilinear
resize computed by the port's host library, bit for bit, without PIL.  The
random transforms take an explicit generator and draw from it in the order
in which the JAX package draws from the global ``random`` / ``np.random``.
"""

from __future__ import annotations

import random

import numpy as np

from ..native import resize_pil_bilinear_u8


def imresize(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL bilinear resize on uint8 (data_utils.py:26-31): (H, W) or
    (H, W, 3), cast to uint8 first."""
    h, w = size
    return resize_pil_bilinear_u8(arr.astype("uint8"), h, w)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, images):
        for t in self.transforms:
            images = t(images)
        return images


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, images):
        return [(im - self.mean) / self.std for im in images]


class ToFloat01:
    """ArrayToTensor semantics: float / 255, NHWC layout kept."""

    def __call__(self, images):
        return [np.asarray(im, np.float32) / 255.0 for im in images]


class ToFloat:
    """ArrayToTensorWoNorm: float without normalization."""

    def __call__(self, images):
        return [np.asarray(im, np.float32) for im in images]


class RandomHorizontalFlip:
    def __init__(self, rng: random.Random):
        self.rng = rng

    def __call__(self, images):
        if self.rng.random() < 0.5:
            return [np.copy(np.fliplr(im)) for im in images]
        return images


class RandomScaleCrop:
    """Zoom up to 15% then random-crop to (h, w)
    (custom_transforms.py:71-90)."""

    def __init__(self, h, w, rng: np.random.RandomState):
        self.h = h
        self.w = w
        self.rng = rng

    def __call__(self, images):
        in_h, in_w = images[0].shape[:2]
        x_scaling, y_scaling = self.rng.uniform(1, 1.15, 2)
        scaled_h, scaled_w = int(in_h * y_scaling), int(in_w * x_scaling)
        scaled = [imresize(im, (scaled_h, scaled_w)) for im in images]
        oy = self.rng.randint(scaled_h - self.h + 1)
        ox = self.rng.randint(scaled_w - self.w + 1)
        return [im[oy : oy + self.h, ox : ox + self.w] for im in scaled]


class RandomCrop:
    def __init__(self, h, w, rng: np.random.RandomState):
        self.h = h
        self.w = w
        self.rng = rng

    def __call__(self, images):
        in_h, in_w = images[0].shape[:2]
        oy = self.rng.randint(in_h - self.h + 1)
        ox = self.rng.randint(in_w - self.w + 1)
        return [im[oy : oy + self.h, ox : ox + self.w] for im in images]


class Scale:
    def __init__(self, h, w):
        self.h = h
        self.w = w

    def __call__(self, images):
        return [imresize(im, (self.h, self.w)) for im in images]
