"""The host library's OpenCV and Pillow operations (``native/cv.py`` over
``native/src/ufr_cv.cpp``) against cv2 and PIL on the CPU, and the digest
fixture that ``chip_smoke.py`` checks them by on the machine without cv2.

Bit-equal: cvtColor RGB<->HSV (f32), the Gaussian kernel and GaussianBlur
(the disk kernels included), warpAffine given the same matrix, INTER_CUBIC
of float64 and of 3-channel uint8 (Intel IPP's float code in the pip
OpenCV, OpenCV's own below 4 pixels a side), Canny, distanceTransform,
threshold, blur, equalizeHist, filter2D of uint8, the circle, cv2.imread,
PIL's BOX and NEAREST.  Bounded: filter2D of float64 (OpenCV takes a DFT
for the defocus kernels: within 5 ulp of 1.0, ~83 % of the samples
differ) and getAffineTransform (OpenCV solves through LAPACK: within 3 ulp
of max(|M|, 1), and the warp's coordinate table is the same).  cv2 runs at
its defaults throughout.
"""

import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))

from cv_digests import Cv2Ops, reference_digests  # noqa: E402
from understanding_flow_robustness_tpu_torch.attacks.corruptions import (  # noqa: E402
    disk,
    liquid_layer,
    water_stages,
)
from understanding_flow_robustness_tpu_torch.attacks.patch import circle_rings  # noqa: E402
from understanding_flow_robustness_tpu_torch.native import cv as C  # noqa: E402
from understanding_flow_robustness_tpu_torch.native import cv_cases  # noqa: E402

DISKS = cv_cases.DISKS


def water_liquid(h, w, sigma, seed):
    """spatter's uint8 liquid layer at its water severities' level."""
    c = (0.65, 0.3, sigma, 0.68)
    return (liquid_layer((h, w), c, np.random.RandomState(seed))
            * 255).astype(np.uint8)


def _f32_image(h, w, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(h, w, 3).astype(np.float32)
    # u8-derived rows as the corruptions feed them
    x[::2] = (rng.randint(0, 256, x[::2].shape) / 255.0).astype(np.float32)
    return x


@pytest.mark.parametrize("w", [1, 7, 20, 83, 1280])
def test_hsv_round_trip_bit_equal(w):
    """RGB2HSV (OpenCV's AVX2 body and its scalar tail of w % 8 columns)
    and HSV2RGB after brightness/saturate-style edits."""
    x = _f32_image(31, w, seed=w)
    hsv = C.rgb2hsv(x)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(x, cv2.COLOR_RGB2HSV))
    for ch, f in ((1, lambda s: s * 2 + 0.1), (2, lambda v: v + 0.3)):
        mod = hsv.copy()
        mod[..., ch] = np.clip(f(mod[..., ch]), 0, 1)
        np.testing.assert_array_equal(
            C.hsv2rgb(mod), cv2.cvtColor(mod, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("n,sigma", [(3, 0.1), (3, 0.5), (5, 0.5), (5, 1.1),
                                     (7, 2.0)])
def test_gaussian_kernel_bit_equal(n, sigma):
    np.testing.assert_array_equal(
        C.get_gaussian_kernel(n, sigma),
        cv2.getGaussianKernel(n, sigma, cv2.CV_32F)[:, 0])


@pytest.mark.parametrize("radius,alias", DISKS)
def test_disk_kernel_bit_equal(radius, alias):
    """defocus_blur's disk(): the float32 GaussianBlur of the aliased disk,
    against the JAX copy's cv2 call."""
    from understanding_flow_robustness_tpu.attacks import corruptions as J

    np.testing.assert_array_equal(disk(radius, alias), J.disk(radius, alias))


@pytest.mark.parametrize("ksize,sigma", [(3, 0.5), (5, 1.1)])
def test_gaussian_blur_bit_equal_any_width(ksize, sigma):
    """Every width 2-39 and a few wide ones (OpenCV's row pass rounds its
    last column differently when the width is odd, its 5-tap column pass
    its last w % 8 columns)."""
    for w in list(range(2, 40)) + [64, 67, 71, 1280]:
        for h in (2, 5, 17):
            a = np.random.RandomState(h * 1000 + w).rand(h, w).astype(
                np.float32)
            np.testing.assert_array_equal(
                C.gaussian_blur(a, ksize, sigma),
                cv2.GaussianBlur(a, (ksize, ksize), sigmaX=sigma),
                err_msg=f"{h}x{w}")
    with pytest.raises(ValueError, match="single-row"):
        C.gaussian_blur(np.zeros((1, 9), np.float32), 3, 0.5)


def test_filter2d_f64_within_5_ulp():
    """defocus_blur's filter2D: a direct correlation in double; OpenCV's
    DFT for these kernel sizes agrees to 5 ulp of 1.0 on [0, 1] planes,
    not to the bit (the share of differing samples is reported)."""
    shares = []
    for radius, alias in DISKS:
        k = disk(radius, alias)
        for seed in range(2):
            x = np.random.RandomState(seed).rand(48, 80)
            d = C.filter2d(x, k) - cv2.filter2D(x, -1, k)
            assert np.abs(d).max() <= 5 * np.spacing(1.0)
            shares.append((d != 0).mean())
    print(f"filter2D f64: {100 * np.mean(shares):.1f} % of samples differ "
          f"(max {100 * max(shares):.1f} %), all within 5 ulp of 1.0")
    assert max(shares) < 0.95


def test_affine_transform_and_warp():
    """getAffineTransform within 3 ulp of max(|M|, 1) of cv2's; warpAffine
    bit-equal given the same matrix, and with the port's own matrix (the
    1/1024 coordinate table does not move) at elastic_transform's
    geometry."""
    for seed in range(200):
        rng = np.random.RandomState(seed)
        h, w = rng.randint(20, 400), rng.randint(20, 1300)
        center = np.float32((h, w)) // 2
        sq = min(h, w) // 3
        pts1 = np.float32([center + sq, [center[0] + sq, center[1] - sq],
                           center - sq])
        c2 = h * rng.choice([0.1, 0.2, 0.02, 0.7])
        pts2 = pts1 + rng.uniform(-c2, c2, pts1.shape).astype(np.float32)
        ref = cv2.getAffineTransform(pts1, pts2)
        got = C.get_affine_transform(pts1, pts2)
        assert np.abs(got - ref).max() <= 3 * np.spacing(
            max(np.abs(ref).max(), 1.0)), seed
        if seed % 40 == 0:
            x = rng.rand(h, w, 3)
            want = cv2.warpAffine(x, ref, (w, h),
                                  borderMode=cv2.BORDER_REFLECT_101)
            np.testing.assert_array_equal(C.warp_affine(x, ref, (w, h)),
                                          want)
            np.testing.assert_array_equal(C.warp_affine(x, got, (w, h)),
                                          want)


def test_resize_cubic_f64_bit_equal():
    rng = np.random.RandomState(0)
    for (h, w, oh, ow) in ((512, 512, 512, 640), (90, 120, 99, 132),
                           (33, 47, 70, 101), (40, 60, 13, 17)):
        x = rng.rand(h, w, 3) * 255
        np.testing.assert_array_equal(
            C.resize_cubic(x, (ow, oh)),
            cv2.resize(x, (ow, oh), interpolation=cv2.INTER_CUBIC))


@pytest.mark.parametrize("kind", ["random", "binary", "smooth", "flat"])
def test_resize_cubic_u8_bit_equal(kind):
    """uint8 (H, W, 3) at cv2's defaults, bit for bit: Intel IPP's float
    code from 4 pixels a side, OpenCV's own fixed point below; up- and
    downscales, 1 to 12x, of random, 0/255, smooth and flat images.  One
    or four channels are refused (the frost photos have three)."""
    rng = np.random.RandomState(["random", "binary", "smooth",
                                 "flat"].index(kind))
    for i in range(40):
        h, w = rng.randint(1, 160), rng.randint(1, 240)
        scale = (rng.uniform(0.2, 1), rng.uniform(1, 3), 1.1,
                 rng.uniform(3, 12))[i % 4]
        ow, oh = max(1, int(np.ceil(w * scale))), max(1, int(np.ceil(
            h * scale)))
        if kind == "random":
            x = rng.randint(0, 256, (h, w, 3))
        elif kind == "binary":
            x = np.where(rng.rand(h, w, 3) < 0.5, 0, 255)
        elif kind == "smooth":
            x = np.clip(rng.randn(h, w, 3).cumsum(1) * 8 + 128, 0, 255)
        else:
            x = np.full((h, w, 3), rng.choice([0, 128, 255]))
            x[: h // 2, : w // 3] = 255 - x[0, 0]
        x = x.astype(np.uint8)
        np.testing.assert_array_equal(
            C.resize_cubic(x, (ow, oh)),
            cv2.resize(x, (ow, oh), interpolation=cv2.INTER_CUBIC),
            err_msg=f"{(h, w)} -> {(oh, ow)}")
    for c in (1, 4):
        with pytest.raises(ValueError, match="uint8"):
            C.resize_cubic(np.zeros((8, 8, c), np.uint8), (9, 9))


@pytest.mark.parametrize("seed", range(4))
def test_spatter_chain_bit_equal(seed):
    """Canny, distanceTransform, threshold, blur (f32 and u8),
    equalizeHist and filter2D(CV_8U): spatter's ``water_stages`` on the
    host library and on cv2, stage by stage."""
    h, w = ((96, 320), (61, 83), (384, 1280), (17, 9))[seed]
    liquid = water_liquid(h, w, sigma=(4, 3, 2, 1)[seed], seed=seed)
    got = water_stages(liquid)
    want = water_stages(liquid, ops=Cv2Ops)
    assert len(got) == len(want) == 7
    for k, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r, err_msg=f"stage {k}")


def test_equalize_hist_and_distance_edge_cases():
    """A constant image (equalizeHist: all that level) and one without a
    zero pixel (distanceTransform: FLT_MAX), as cv2 gives them."""
    for v in (0, 7, 255):
        x = np.full((5, 6), v, np.uint8)
        np.testing.assert_array_equal(C.equalize_hist(x),
                                      cv2.equalizeHist(x))
    x = np.full((5, 6), 255, np.uint8)
    np.testing.assert_array_equal(C.distance_transform_l2_5(x),
                                  cv2.distanceTransform(x, cv2.DIST_L2, 5))


@pytest.mark.parametrize("c", cv_cases.PIXELATE)
def test_pil_box_and_nearest_bit_equal(c):
    """pixelate's two resizes at each factor, on random sizes and on a
    grey image."""
    rng = np.random.RandomState(int(c * 100))
    for _ in range(4):
        h, w = rng.randint(5, 400), rng.randint(5, 700)
        x = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        small = Image.fromarray(x).resize((int(w * c), int(h * c)), Image.BOX)
        got = C.pil_resize(x, (int(w * c), int(h * c)), "box")
        np.testing.assert_array_equal(got, np.asarray(small))
        np.testing.assert_array_equal(
            C.pil_resize(got, (w, h), "nearest"),
            np.asarray(small.resize((w, h), Image.NEAREST)))
    g = rng.randint(0, 256, (37, 53)).astype(np.uint8)
    np.testing.assert_array_equal(
        C.pil_resize(g, (20, 30), "box"),
        np.asarray(Image.fromarray(g).resize((20, 30), Image.BOX)))


@pytest.mark.parametrize("first", range(1, 401, 50))
def test_circle_rings_bit_equal(first):
    """create_correlated_patch's rings, n = first .. first + 49: thickness
    max(n // 48, 1), the integer circle at 1, the thick polyline above."""
    for n in range(first, first + 50):
        np.testing.assert_array_equal(circle_rings(n),
                                      circle_rings(n, ops=Cv2Ops),
                                      err_msg=f"n = {n}")


def test_circle_clipped():
    """Circles that leave the canvas, thin and thick; a filled circle
    (thickness < 0), which no caller draws, is refused."""
    rng = np.random.RandomState(3)
    for _ in range(40):
        h, w = rng.randint(5, 60), rng.randint(5, 60)
        ref = np.zeros((h, w, 3), np.uint8)
        got = ref.copy()
        centre = (int(rng.randint(-10, w + 10)), int(rng.randint(-10, h + 10)))
        r, t = int(rng.randint(0, 40)), int(rng.choice([1, 2, 3, 5]))
        cv2.circle(ref, centre, r, (255, 128, 7), t)
        C.circle(got, centre, r, (255, 128, 7), t)
        np.testing.assert_array_equal(got, ref, err_msg=str((centre, r, t)))
    with pytest.raises(ValueError, match="thickness"):
        C.circle(ref, (5, 5), 3, (0, 0, 0), -1)


def test_imread_bgr_matches_cv2(tmp_path):
    """Frost photos as cv2.imread gives them: RGB, grey, RGBA and 16-bit
    PNG and baseline JPEG, as BGR uint8."""
    rng = np.random.RandomState(4)
    rgb = rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)
    files = {"rgb.png": rgb, "grey.png": rgb[..., 0],
             "rgba.png": np.dstack([rgb, rgb[..., :1]]),
             "deep.png": rng.randint(0, 65536, (23, 31, 3)).astype(np.uint16)}
    for name, img in files.items():
        cv2.imwrite(str(tmp_path / name), img)
    cv2.imwrite(str(tmp_path / "photo.jpg"), rgb)
    cv2.imwrite(str(tmp_path / "grey.jpg"), rgb[..., 1])
    for name in list(files) + ["photo.jpg", "grey.jpg"]:
        path = str(tmp_path / name)
        np.testing.assert_array_equal(C.imread_bgr(path), cv2.imread(path),
                                      err_msg=name)


def test_cv_digests_fixture_is_current():
    """data/fixtures/cv_digests.json is what tests/cv_digests.py computes
    with this cv2 and PIL."""
    assert reference_digests() == cv_cases.load_fixture()


def test_port_reproduces_cv_digests():
    """The host library gives the fixture's bits (the check chip_smoke.py
    repeats on the machine without cv2)."""
    got = cv_cases.port_digests()
    want = cv_cases.load_fixture()
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
