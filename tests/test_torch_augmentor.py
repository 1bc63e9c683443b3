"""The port's training augmentors and the host-library operations under them
against PIL, cv2 and the JAX package's ``data/augmentor.py``, on the CPU.

* PIL's colour operations (``native.pil_color_op``, ``pil_hsv_convert``):
  the HSV conversions over all 2^24 colours, ``ImageEnhance``'s
  Brightness / Contrast / Color over 50 seeds with factors below and above
  1, the hue roll at +-0.5/pi, bit for bit;
* cv2's ``INTER_LINEAR`` resize by factors (``native.resize_cv2_linear_u8``,
  ``resize_cv2_linear_flow``): u8 images and float32 / float64 flows, the
  exact 2x reduction (cv2's area path) included, bit for bit;
* ``ColorJitter``, ``FlowAugmentor`` and ``SparseFlowAugmentor`` seeded
  alike (the port's ``random.Random(s)`` / ``RandomState(s)`` against the
  JAX package's global ``random.seed(s)`` / ``np.random.seed(s)``): the
  same images, flow and valid, bit for bit, over seeds that take every
  branch (asymmetric jitter, the eraser, stretch, each flip, the resize to
  the crop and the crop, translation and rotation).
"""

import random

import cv2
import numpy as np
import pytest
from PIL import Image, ImageEnhance

from understanding_flow_robustness_tpu.data import augmentor as jaug
from understanding_flow_robustness_tpu_torch import native
from understanding_flow_robustness_tpu_torch.data import augmentor as taug


def test_hsv_conversions_match_pil_on_every_colour():
    px = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                              indexing="ij"), -1).astype(np.uint8)
    px = px.reshape(4096, 4096, 3)
    assert np.array_equal(native.pil_hsv_convert(px, True),
                          np.array(Image.fromarray(px).convert("HSV")))
    assert np.array_equal(native.pil_hsv_convert(px, False),
                          np.array(Image.fromarray(px, "HSV").convert("RGB")))


ENHANCERS = {"brightness": ImageEnhance.Brightness,
             "contrast": ImageEnhance.Contrast,
             "saturation": ImageEnhance.Color}


def test_enhancers_match_pil():
    rng = np.random.RandomState(0)
    for seed in range(50):
        h, w = rng.randint(1, 40, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        # below 1, above 1 (PIL clips), and the bounds
        for f in (rng.uniform(0, 1), rng.uniform(1, 2), 0.0, 1.0):
            for op, cls in ENHANCERS.items():
                want = np.array(cls(Image.fromarray(img)).enhance(f))
                assert np.array_equal(native.pil_color_op(img, op, f), want), \
                    (seed, op, f)


@pytest.mark.parametrize("factor", [0.5 / 3.14, -0.5 / 3.14, 0.3 / 3.14,
                                    -0.01, 0.0])
def test_hue_matches_the_jax_package(factor):
    img = np.random.RandomState(1).randint(0, 256, (23, 31, 3)).astype(
        np.uint8)
    want = np.array(jaug.ColorJitter._adjust_hue(Image.fromarray(img),
                                                 factor))
    assert np.array_equal(
        native.pil_color_op(img, "hue", shift=int(factor * 255)), want)


def test_color_jitter_matches_the_jax_package():
    rng = np.random.RandomState(2)
    for seed in range(30):
        img = rng.randint(0, 256, (17, 29, 3)).astype(np.uint8)
        for args in ((0.4, 0.4, 0.4, 0.5 / 3.14), (0.3, 0.3, 0.3, 0.3 / 3.14),
                     (0.0, 0.2, 0.0, 0.0)):
            random.seed(seed)
            want = np.array(jaug.ColorJitter(*args)(Image.fromarray(img)))
            got = taug.ColorJitter(*args)(img, random.Random(seed))
            assert np.array_equal(got, want), (seed, args)


def _factors(rng):
    return 2 ** rng.uniform(-0.6, 1.2, 2)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_by_factors_matches_cv2_u8(channels):
    rng = np.random.RandomState(channels)
    for k in range(40):
        h, w = rng.randint(2, 90, 2)
        img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
        fx, fy = (0.5, 0.5) if k % 8 == 0 else _factors(rng)
        want = cv2.resize(img, None, fx=fx, fy=fy,
                          interpolation=cv2.INTER_LINEAR)
        got = native.resize_cv2_linear_u8(img, fx, fy)
        assert np.array_equal(got.reshape(want.shape), want), (h, w, fx, fy)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resize_by_factors_matches_cv2_flow(dtype):
    """Bit-equal (PR 12's f32 resize-to-a-size bar, <= 2 ulps in 0.2 % of
    the samples, is not needed here: by factors cv2 blends without FMA)."""
    rng = np.random.RandomState(7)
    for k in range(40):
        h, w = rng.randint(2, 90, 2)
        flow = (rng.randn(h, w, 2) * 20).astype(dtype)
        fx, fy = ((0.5, 0.5) if k % 8 == 0 and dtype == np.float32
                  else _factors(rng))
        want = cv2.resize(flow, None, fx=fx, fy=fy,
                          interpolation=cv2.INTER_LINEAR)
        got = native.resize_cv2_linear_flow(flow, fx, fy)
        assert got.dtype == dtype and np.array_equal(got, want), (h, w, fx, fy)


class _Recorder:
    """A RandomState that records what each of its draws returned."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.log = []

    def __getattr__(self, name):
        fn = getattr(self.rs, name)

        def draw(*a, **k):
            out = fn(*a, **k)
            self.log.append((name, out))
            return out
        return draw


def _dense_branches(log, do_flip, trans_rot):
    """The branches a FlowAugmentor call took, from its numpy draws."""
    it = iter(log)
    seen = set()
    if next(it)[1] < 0.2:
        seen.add("asymmetric")
    if next(it)[1] < 0.5:
        seen.add("eraser")
        for _ in range(4 * next(it)[1]):
            next(it)
    if trans_rot:
        if next(it)[1] < 0.7:
            seen.add("translate")
            next(it), next(it)
        if next(it)[1] < 0.7:
            seen.add("rotate")
    next(it)  # scale
    if next(it)[1] < 0.8:
        seen.add("stretch")
        next(it), next(it)
    if next(it)[1] < 0.8:
        seen.add("spatial")
    if do_flip:
        if next(it)[1] < 0.5:
            seen.add("hflip")
        if next(it)[1] < 0.1:
            seen.add("vflip")
    seen.add("crop" if next(it, None) is not None else "crop_resize")
    return seen


def _sparse_branches(log, do_flip):
    it = iter(log)
    seen = set()
    if next(it)[1] < 0.5:
        seen.add("eraser")
        for _ in range(4 * next(it)[1]):
            next(it)
    next(it)  # scale
    if next(it)[1] < 0.8:
        seen.add("spatial")
    if do_flip and next(it)[1] < 0.5:
        seen.add("hflip")
    return seen


def _frames(rng, h, w):
    img1 = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img2 = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return img1, img2


@pytest.mark.parametrize("trans_rot", [False, True])
def test_flow_augmentor_matches_the_jax_package(trans_rot):
    crop = (40, 56)
    kw = dict(crop_size=crop, min_scale=-0.2, max_scale=0.5, do_flip=True)
    if trans_rot:
        kw.update(do_trans_rot=True, translate=10, rot_angle=17,
                  diff_angle=5)
    j, t = jaug.FlowAugmentor(**kw), taug.FlowAugmentor(**kw)
    rng = np.random.RandomState(3)
    seen = set()
    for seed in range(60 if trans_rot else 45):
        # frames of the crop's size take the resize to the crop whenever
        # the spatial resize is skipped
        h, w = crop if seed % 3 == 0 else (60, 90)
        img1, img2 = _frames(rng, h, w)
        flow = (rng.randn(h, w, 2) * 5).astype(np.float32)
        random.seed(seed)
        np.random.seed(seed)
        want = j(img1, img2, flow)
        rec = _Recorder(seed)
        got = t(img1, img2, flow, random.Random(seed), rec)
        seen |= _dense_branches(rec.log, True, trans_rot)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), seed
    want = {"asymmetric", "eraser", "stretch", "spatial", "hflip", "vflip",
            "crop", "crop_resize"}
    if trans_rot:
        want |= {"translate", "rotate"}
    assert seen == want


@pytest.mark.parametrize("do_flip", [False, True])
def test_sparse_flow_augmentor_matches_the_jax_package(do_flip):
    kw = dict(crop_size=(40, 56), min_scale=-0.2, max_scale=0.4,
              do_flip=do_flip)
    j, t = jaug.SparseFlowAugmentor(**kw), taug.SparseFlowAugmentor(**kw)
    rng = np.random.RandomState(4)
    seen = set()
    for seed in range(20):
        img1, img2 = _frames(rng, 61, 83)
        flow = (rng.randn(61, 83, 2) * 5).astype(np.float32)
        valid = (rng.rand(61, 83) > 0.4).astype(np.float32)
        random.seed(seed)
        np.random.seed(seed)
        want = j(img1, img2, flow, valid)
        rec = _Recorder(seed)
        got = t(img1, img2, flow, valid, random.Random(seed), rec)
        seen |= _sparse_branches(rec.log, do_flip)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), seed
    assert seen == ({"eraser", "spatial"} | ({"hflip"} if do_flip else set()))
