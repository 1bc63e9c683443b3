"""Training augmentors (counterpart of
``understanding_flow_robustness_tpu/data/augmentor.py``; reference:
dataset_utils/augmentor.py).

``FlowAugmentor`` (dense flow) and ``SparseFlowAugmentor`` (KITTI sparse
flow) with ``ColorJitter``, on u8 HWC numpy frames.  The JAX package does
the colour work with PIL and the resizes with cv2; here the port's host
library does both, bit for bit (``native.pil_color_op``,
``native.resize_cv2_linear_u8`` / ``resize_cv2_linear_flow``), so the
card's machine needs neither.  The translation/rotation branch uses
``scipy.ndimage.rotate`` as the JAX package does.

Every random draw comes from the two generators a call is given, a
``random.Random`` (the JAX package's global ``random``) and a
``np.random.RandomState`` (its global ``np.random``), in the JAX package's
order: seeded alike, both give the same sample.
"""

from __future__ import annotations

import random

import numpy as np

from ..native import (
    pil_color_op,
    resize_cv2_linear_flow,
    resize_cv2_linear_u8,
    resize_sparse_flow,
)


class ColorJitter:
    """torchvision.transforms.ColorJitter with the PIL backend: brightness,
    contrast and saturation factors from [max(0, 1 - v), 1 + v], a hue
    factor from [-hue, hue], drawn in that order, then applied in an order
    shuffled by the same generator."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = self._range(brightness)
        self.contrast = self._range(contrast)
        self.saturation = self._range(saturation)
        self.hue = (-hue, hue) if hue else None

    @staticmethod
    def _range(v):
        return (max(0.0, 1.0 - v), 1.0 + v) if v else None

    def __call__(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        ops = []
        for name in ("brightness", "contrast", "saturation"):
            bounds = getattr(self, name)
            if bounds:
                ops.append((name, rng.uniform(*bounds)))
        if self.hue:
            ops.append(("hue", rng.uniform(*self.hue)))
        rng.shuffle(ops)
        for name, f in ops:
            if name == "hue":
                # augmentor.py:52-58: H + int(f * 255) mod 256
                img = pil_color_op(img, "hue", shift=int(f * 255))
            else:
                img = pil_color_op(img, name, f)
        return img


def _eraser(img2, rng: np.random.RandomState, bounds=(50, 100)):
    """Up to two rectangles of img2 set to its mean colour."""
    ht, wd = img2.shape[:2]
    mean_color = np.mean(img2.reshape(-1, 3), axis=0)
    img2 = img2.copy()
    for _ in range(rng.randint(1, 3)):
        x0 = rng.randint(0, wd)
        y0 = rng.randint(0, ht)
        dx = rng.randint(bounds[0], bounds[1])
        dy = rng.randint(bounds[0], bounds[1])
        img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
    return img2


def _jitter_stack(photo_aug, img1, img2, rng):
    """One jitter over the frames stacked vertically (symmetric)."""
    stack = photo_aug(np.concatenate([img1, img2], axis=0), rng)
    return np.split(stack, 2, axis=0)


def _resize_flow(flow, fx, fy):
    return resize_cv2_linear_flow(flow, fx, fy) * [fx, fy]


class FlowAugmentor:
    """augmentor.py:13-249: photometric (asymmetric p=0.2) + eraser (p=0.5,
    bounds [50,100]) + optional translation/rotation + random scale/stretch
    + flips + crop."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 do_trans_rot=False, translate=10, rot_angle=17, diff_angle=5):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_trans_rot = do_trans_rot
        self.translate = (int(translate), int(translate))
        self.trans_prob = 0.7
        self.angle = rot_angle
        self.diff_angle = diff_angle
        self.rot_prob = 0.7
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng, np_rng):
        if np_rng.rand() < self.asymmetric_color_aug_prob:
            return self.photo_aug(img1, rng), self.photo_aug(img2, rng)
        return _jitter_stack(self.photo_aug, img1, img2, rng)

    def eraser_transform(self, img1, img2, np_rng):
        if np_rng.rand() < self.eraser_aug_prob:
            img2 = _eraser(img2, np_rng)
        return img1, img2

    def rotation(self, img1, img2, flow, rng):
        """Differential-rotation aug with flow-field correction
        (augmentor.py:88-132)."""
        import scipy.ndimage as ndimage

        applied_angle = rng.uniform(-self.angle, self.angle)
        diff = rng.uniform(-self.diff_angle, self.diff_angle)
        angle1 = applied_angle - diff / 2
        angle2 = applied_angle + diff / 2
        angle1_rad = angle1 * np.pi / 180
        diff_rad = diff * np.pi / 180

        h, w, _ = flow.shape
        warped = np.mgrid[:w, :h].T + flow
        warped = warped - np.array([w / 2, h / 2])
        rot = np.zeros_like(flow)
        rot[..., 0] = (np.cos(diff_rad) - 1) * warped[..., 0] + np.sin(
            diff_rad
        ) * warped[..., 1]
        rot[..., 1] = -np.sin(diff_rad) * warped[..., 0] + (
            np.cos(diff_rad) - 1
        ) * warped[..., 1]
        flow = flow + rot

        img1 = ndimage.rotate(img1, angle1, reshape=False, order=2)
        img2 = ndimage.rotate(img2, angle2, reshape=False, order=2)
        flow = ndimage.rotate(flow, angle1, reshape=False, order=2)
        flow_ = np.copy(flow)
        flow[:, :, 0] = (
            np.cos(angle1_rad) * flow_[:, :, 0]
            + np.sin(angle1_rad) * flow_[:, :, 1]
        )
        flow[:, :, 1] = (
            -np.sin(angle1_rad) * flow_[:, :, 0]
            + np.cos(angle1_rad) * flow_[:, :, 1]
        )
        return img1, img2, flow

    def translation(self, img1, img2, flow, np_rng):
        """augmentor.py:134-149 (incl. the reference's tw-on-both-axes
        flow-offset quirk at :148)."""
        h, w = img1.shape[:2]
        th, tw = self.translate
        tw = np_rng.randint(-tw, tw)
        th = np_rng.randint(-th, th)
        if tw == 0 and th == 0:
            return img1, img2, flow
        x1, x2, x3, x4 = max(0, tw), min(w + tw, w), max(0, -tw), min(w - tw, w)
        y1, y2, y3, y4 = max(0, th), min(h + th, h), max(0, -th), min(h - th, h)
        img1 = img1[y1:y2, x1:x2]
        img2 = img2[y3:y4, x3:x4]
        flow = flow[y1:y2, x1:x2].copy()
        flow[..., 0] += tw
        flow[..., 1] += tw
        return img1, img2, flow

    def spatial_transform(self, img1, img2, flow, rng, np_rng):
        if self.do_trans_rot:
            if np_rng.rand() < self.trans_prob:
                img1, img2, flow = self.translation(img1, img2, flow, np_rng)
            nan_exist = (
                np.any(np.isnan(img1)) or np.any(np.isnan(img2))
                or np.any(np.isnan(flow))
            )
            if np_rng.rand() < self.rot_prob and not nan_exist:
                img1, img2, flow = self.rotation(img1, img2, flow, rng)

        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 8) / float(ht),
            (self.crop_size[1] + 8) / float(wd),
        )
        scale = 2 ** np_rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if np_rng.rand() < self.stretch_prob:
            scale_x *= 2 ** np_rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** np_rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        if np_rng.rand() < self.spatial_aug_prob:
            img1 = resize_cv2_linear_u8(img1, scale_x, scale_y)
            img2 = resize_cv2_linear_u8(img2, scale_x, scale_y)
            flow = _resize_flow(flow, scale_x, scale_y)

        if self.do_flip:
            if np_rng.rand() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if np_rng.rand() < self.v_flip_prob:
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]

        if (img1.shape[0] <= self.crop_size[0]
                or img1.shape[1] <= self.crop_size[1]):
            scale_x = self.crop_size[1] / img1.shape[1]
            scale_y = self.crop_size[0] / img1.shape[0]
            img1 = resize_cv2_linear_u8(img1, scale_x, scale_y)
            img2 = resize_cv2_linear_u8(img2, scale_x, scale_y)
            flow = _resize_flow(flow, scale_x, scale_y)
        else:
            y0 = np_rng.randint(0, img1.shape[0] - self.crop_size[0])
            x0 = np_rng.randint(0, img1.shape[1] - self.crop_size[1])
            img1 = img1[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
            img2 = img2[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
            flow = flow[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, rng: random.Random,
                 np_rng: np.random.RandomState):
        img1, img2 = self.color_transform(img1, img2, rng, np_rng)
        img1, img2 = self.eraser_transform(img1, img2, np_rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng,
                                                  np_rng)
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow.astype(np.float32)),
        )


class SparseFlowAugmentor:
    """augmentor.py:251-382 (KITTI sparse flow, scatter-based resize)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.photo_aug = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)
        self.eraser_aug_prob = 0.5

    def eraser_transform(self, img1, img2, np_rng):
        if np_rng.rand() < self.eraser_aug_prob:
            img2 = _eraser(img2, np_rng)
        return img1, img2

    def spatial_transform(self, img1, img2, flow, valid, np_rng):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 1) / float(ht),
            (self.crop_size[1] + 1) / float(wd),
        )
        scale = 2 ** np_rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if np_rng.rand() < self.spatial_aug_prob:
            img1 = resize_cv2_linear_u8(img1, scale_x, scale_y)
            img2 = resize_cv2_linear_u8(img2, scale_x, scale_y)
            flow, valid = resize_sparse_flow(flow, valid, fx=scale_x,
                                             fy=scale_y)

        if self.do_flip and np_rng.rand() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        margin_y, margin_x = 20, 50
        y0 = np_rng.randint(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = np_rng.randint(
            -margin_x, img1.shape[1] - self.crop_size[1] + margin_x
        )
        y0 = np.clip(y0, 0, img1.shape[0] - self.crop_size[0])
        x0 = np.clip(x0, 0, img1.shape[1] - self.crop_size[1])
        img1 = img1[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        img2 = img2[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        flow = flow[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        valid = valid[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid, rng: random.Random,
                 np_rng: np.random.RandomState):
        img1, img2 = _jitter_stack(self.photo_aug, img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, np_rng)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid, np_rng)
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow.astype(np.float32)),
            np.ascontiguousarray(valid),
        )
