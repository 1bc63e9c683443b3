"""Image corruptions on the host (numpy, scipy and cv2), severity 1-5: the
port's own copy of ``understanding_flow_robustness_tpu/attacks/corruptions.py``
(reference: PerturbationsModel.__image_corruptions, perturb_model.py:384-418,
the ``imagecorruptions`` 1.1.2 package and its deterministic-frost fork,
global_attacks/imagecorruptions_frost/corruption.py:9-190).

The same 19 Hendrycks & Dietterich ImageNet-C corruptions with the same
deliberate divergences from the pip package as the JAX package's copy
(glass_blur's vectorised pixel shuffle, cv2's HSV in brightness and
saturate, cv2's JPEG encoder), and ``frost`` on a texture directory or,
without one, on a procedural plasma-fractal texture.

Random draws: every corruption takes ``rng``, an ``np.random.RandomState``,
and makes the JAX copy's draws in the same order from it; without one it
draws from numpy's global state, as the JAX copy does.  So
``np.random.seed(s)`` before the JAX copy and ``RandomState(s)`` here give
bit-equal images.

``cv2`` is imported inside the corruptions that need it (defocus_blur,
frost, brightness, saturate, elastic_transform, jpeg_compression,
spatter); ``pixelate`` needs PIL.  The noise corruptions, gaussian_blur,
glass_blur, motion_blur, zoom_blur, snow, fog and contrast need only numpy
and scipy and run without ``cv2``; a ``cv2`` one raises an ``ImportError``
that names it.

API: ``corrupt(image_uint8_hwc, corruption_name, severity, rng=None)``,
``corrupt_pair`` and ``get_corruption_names()``, as in the pip package.
"""

from __future__ import annotations

import os

import numpy as np


def _cv2():
    """cv2, or an ImportError that names it."""
    try:
        import cv2
    except ImportError as err:
        raise ImportError(
            "this corruption needs cv2 (OpenCV), which cannot be imported; "
            "the numpy/scipy corruptions run without it") from err
    return cv2


def _state(rng):
    """``rng``, or numpy's global state (the JAX copy's draws)."""
    return np.random if rng is None else rng


def get_corruption_names(subset: str = "common") -> list[str]:
    common = [
        "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
        "glass_blur", "motion_blur", "zoom_blur", "snow", "frost", "fog",
        "brightness", "contrast", "elastic_transform", "pixelate",
        "jpeg_compression",
    ]
    extra = ["speckle_noise", "gaussian_blur", "spatter", "saturate"]
    if subset == "common":
        return common
    if subset == "all":
        return common + extra
    raise ValueError(subset)


# ---------------------------------------------------------------------------
# helpers (corruption.py:9-130 of the reference's frost fork)
# ---------------------------------------------------------------------------


def disk(radius, alias_blur=0.1, dtype=np.float32):
    cv2 = _cv2()

    if radius <= 8:
        L = np.arange(-8, 8 + 1)
        ksize = (3, 3)
    else:
        L = np.arange(-radius, radius + 1)
        ksize = (5, 5)
    X, Y = np.meshgrid(L, L)
    aliased = np.array((X ** 2 + Y ** 2) <= radius ** 2, dtype=dtype)
    aliased /= np.sum(aliased)
    return cv2.GaussianBlur(aliased, ksize=ksize, sigmaX=alias_blur)


def plasma_fractal(mapsize=256, wibbledecay=3, rng=None):
    """Diamond-square heightmap in [0, 1]."""
    rng = rng or np.random
    assert mapsize & (mapsize - 1) == 0
    maparray = np.empty((mapsize, mapsize), dtype=np.float64)
    maparray[0, 0] = 0
    stepsize = mapsize
    wibble = 100.0

    def wibbledmean(array):
        return array / 4 + wibble * rng.uniform(-wibble, wibble, array.shape)

    while stepsize >= 2:
        corner = maparray[0:mapsize:stepsize, 0:mapsize:stepsize]
        sq = corner + np.roll(corner, -1, axis=0)
        sq += np.roll(sq, -1, axis=1)
        maparray[stepsize // 2 : mapsize : stepsize,
                 stepsize // 2 : mapsize : stepsize] = wibbledmean(sq)

        drgrid = maparray[stepsize // 2 : mapsize : stepsize,
                          stepsize // 2 : mapsize : stepsize]
        ulgrid = maparray[0:mapsize:stepsize, 0:mapsize:stepsize]
        ltsum = (drgrid + np.roll(drgrid, 1, axis=0)) + (
            ulgrid + np.roll(ulgrid, -1, axis=1)
        )
        maparray[0:mapsize:stepsize,
                 stepsize // 2 : mapsize : stepsize] = wibbledmean(ltsum)
        ttsum = (drgrid + np.roll(drgrid, 1, axis=1)) + (
            ulgrid + np.roll(ulgrid, -1, axis=0)
        )
        maparray[stepsize // 2 : mapsize : stepsize,
                 0:mapsize:stepsize] = wibbledmean(ttsum)
        stepsize //= 2
        wibble /= wibbledecay

    maparray -= maparray.min()
    return maparray / maparray.max()


def clipped_zoom(img, zoom_factor):
    """corruption.py:81-95 verbatim semantics: center-crop then scizoom;
    the result may be a pixel or two off the input size -- consumers
    top-left crop ``[:h, :w]`` and add into the overlapping region, exactly
    like pip 1.1.2's zoom_blur/snow."""
    from scipy.ndimage import zoom as scizoom

    ch0 = int(np.ceil(img.shape[0] / float(zoom_factor)))
    top0 = (img.shape[0] - ch0) // 2
    ch1 = int(np.ceil(img.shape[1] / float(zoom_factor)))
    top1 = (img.shape[1] - ch1) // 2
    return scizoom(img[top0 : top0 + ch0, top1 : top1 + ch1],
                   (zoom_factor, zoom_factor, 1), order=1)


def motion_blur_kernel(width, sigma):
    """getMotionBlurKernel (corruption.py:105-108): a HALF-gaussian over
    [0, width) -- tap i weights the i-th step along the motion direction."""
    k = np.exp(-(np.arange(width) ** 2) / (2.0 * sigma ** 2)) / (
        np.sqrt(2 * np.pi) * sigma
    )
    return k / np.sum(k)


def shift_replicate(image, dx, dy):
    """shift (corruption.py:111-130): roll + edge-replicate the wrapped
    band.  Works on (H, W) and (H, W, C)."""
    if dx < 0:
        shifted = np.roll(image, shift=image.shape[1] + dx, axis=1)
        shifted[:, dx:] = shifted[:, dx - 1 : dx]
    elif dx > 0:
        shifted = np.roll(image, shift=dx, axis=1)
        shifted[:, :dx] = shifted[:, dx : dx + 1]
    else:
        shifted = image
    if dy < 0:
        shifted = np.roll(shifted, shift=image.shape[0] + dy, axis=0)
        shifted[dy:, :] = shifted[dy - 1 : dy, :]
    elif dy > 0:
        shifted = np.roll(shifted, shift=dy, axis=0)
        shifted[:dy, :] = shifted[dy : dy + 1, :]
    return shifted


def _directional_blur(img, radius, sigma, angle):
    """pip 1.1.2's motion-blur core: accumulate half-gaussian-weighted
    edge-replicated shifts along the motion direction (the loop in
    imagecorruptions' motion_blur/snow, built on the fork's
    getMotionBlurKernel/shift helpers, corruption.py:97-130)."""
    import math

    width = radius * 2 + 1
    kernel = motion_blur_kernel(width, sigma)
    point = (width * np.sin(np.deg2rad(angle)),
             width * np.cos(np.deg2rad(angle)))
    hypot = math.hypot(point[0], point[1])
    blurred = np.zeros_like(img, dtype=np.float32)
    for i in range(width):
        dy = -math.ceil(((i * point[0]) / hypot) - 0.5)
        dx = -math.ceil(((i * point[1]) / hypot) - 0.5)
        if abs(dy) >= img.shape[0] or abs(dx) >= img.shape[1]:
            break
        blurred = blurred + kernel[i] * shift_replicate(img, dx, dy)
    return blurred


def rgb2gray(rgb):
    return np.dot(rgb[..., :3], [0.2989, 0.5870, 0.1140])


# ---------------------------------------------------------------------------
# corruptions (x: uint8 HWC RGB)
# ---------------------------------------------------------------------------


def gaussian_noise(x, severity=1, rng=None):
    rng = _state(rng)
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    return np.clip(x + rng.normal(size=x.shape, scale=c), 0, 1) * 255


def shot_noise(x, severity=1, rng=None):
    rng = _state(rng)
    c = [60, 25, 12, 5, 3][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    return np.clip(rng.poisson(x * c) / float(c), 0, 1) * 255


def impulse_noise(x, severity=1, rng=None):
    """skimage random_noise(mode='s&p', amount=c) semantics (what pip
    1.1.2 calls): salt/pepper decided ELEMENTWISE over the full (H, W, C)
    array -- colored impulses, not white/black pixels."""
    rng = _state(rng)
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    flipped = rng.rand(*x.shape) < c
    salted = rng.rand(*x.shape) < 0.5
    x[flipped & salted] = 1.0
    x[flipped & ~salted] = 0.0
    return np.clip(x, 0, 1) * 255


def speckle_noise(x, severity=1, rng=None):
    rng = _state(rng)
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    return np.clip(x + x * rng.normal(size=x.shape, scale=c), 0, 1) * 255


def gaussian_blur(x, severity=1, rng=None):
    from scipy.ndimage import gaussian_filter

    c = [1, 2, 3, 4, 6][severity - 1]
    x = gaussian_filter(np.asarray(x, np.float64) / 255.0, sigma=(c, c, 0),
                        mode="nearest")
    return np.clip(x, 0, 1) * 255


def glass_blur(x, severity=1, rng=None):
    rng = _state(rng)
    from scipy.ndimage import gaussian_filter

    sigma, max_delta, iterations = [
        (0.7, 1, 2), (0.9, 2, 1), (1, 2, 3), (1.1, 3, 2), (1.5, 4, 2)
    ][severity - 1]
    x = np.uint8(
        gaussian_filter(np.asarray(x, np.float64) / 255.0,
                        sigma=(sigma, sigma, 0), mode="nearest") * 255
    )
    h, w = x.shape[:2]
    for _ in range(iterations):
        dy = rng.randint(-max_delta, max_delta + 1, (h - 2 * max_delta,
                                                           w - 2 * max_delta))
        dx = rng.randint(-max_delta, max_delta + 1, dy.shape)
        ys, xs = np.mgrid[max_delta : h - max_delta, max_delta : w - max_delta]
        yp, xp = ys + dy, xs + dx
        tmp = x[ys, xs].copy()
        x[ys, xs] = x[yp, xp]
        x[yp, xp] = tmp
    return np.clip(
        gaussian_filter(x / 255.0, sigma=(sigma, sigma, 0), mode="nearest"), 0, 1
    ) * 255


def defocus_blur(x, severity=1, rng=None):
    cv2 = _cv2()

    radius, alias = [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5)][
        severity - 1
    ]
    x = np.asarray(x, np.float64) / 255.0
    kernel = disk(radius=radius, alias_blur=alias)
    channels = [cv2.filter2D(x[:, :, d], -1, kernel) for d in range(3)]
    return np.clip(np.stack(channels, -1), 0, 1) * 255


def motion_blur(x, severity=1, rng=None):
    """pip 1.1.2 motion_blur: shifted-accumulation along a random angle in
    [-45, 45] with the half-gaussian kernel (NOT a rotated symmetric line
    filter -- the weights decay with distance along the streak)."""
    rng = _state(rng)
    radius, sigma = [(10, 3), (15, 5), (15, 8), (15, 12), (20, 15)][
        severity - 1
    ]
    x = np.asarray(x, np.float32)
    angle = rng.uniform(-45, 45)
    return np.clip(_directional_blur(x, radius, sigma, angle), 0, 255)


def zoom_blur(x, severity=1, rng=None):
    c = [
        np.arange(1, 1.11, 0.01), np.arange(1, 1.16, 0.01),
        np.arange(1, 1.21, 0.02), np.arange(1, 1.26, 0.02),
        np.arange(1, 1.31, 0.03),
    ][severity - 1]
    x = (np.asarray(x) / 255.0).astype(np.float32)
    h, w = x.shape[:2]
    out = np.zeros_like(x)
    for zf in c:
        layer = clipped_zoom(x, zf)[:h, :w, :]
        # pip 1.1.2: top-left crop; a short layer adds into its region
        out[: layer.shape[0], : layer.shape[1]] += layer
    x = (x + out) / (len(c) + 1)
    return np.clip(x, 0, 1) * 255


def fog(x, severity=1, rng=None):
    rng = _state(rng)
    c = [(1.5, 2), (2.0, 2), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4)][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    max_val = x.max()
    h, w = x.shape[:2]
    mapsize = 1 << int(np.ceil(np.log2(max(h, w))))
    fog_layer = c[0] * plasma_fractal(mapsize=mapsize, wibbledecay=c[1],
                                      rng=rng)[:h, :w][..., None]
    x += fog_layer
    return np.clip(x * max_val / (max_val + c[0]), 0, 1) * 255


_FROST_CACHE: dict = {}


def _frost_texture(idx: int, frost_dir: str | None):
    """Frost photo from ``frost_dir`` if available (upstream package
    assets), else a cached procedural icy texture (plasma fractal with
    directional streaks)."""
    cv2 = _cv2()

    key = (idx, frost_dir)
    if key in _FROST_CACHE:
        return _FROST_CACHE[key]
    tex = None
    if frost_dir:
        names = ["frost1.png", "frost2.png", "frost3.png", "frost4.jpg",
                 "frost5.jpg", "frost6.jpg"]
        path = os.path.join(frost_dir, names[idx % len(names)])
        if os.path.exists(path):
            # keep the raw uint8 BGR image: the fork resizes in uint8
            # (quantized) and only reorders channels after the crop
            # (corruption.py:149-186)
            tex = cv2.imread(path)
    if tex is None:
        rng = np.random.RandomState(1234 + idx)
        base = plasma_fractal(mapsize=512, wibbledecay=2.2, rng=rng)
        streaks = plasma_fractal(mapsize=512, wibbledecay=4, rng=rng)
        tex = np.clip(0.6 * base + 0.6 * streaks ** 2, 0, 1)
        tex = cv2.resize(tex, (640, 512), interpolation=cv2.INTER_CUBIC)
        tex = (np.stack([tex, tex, np.minimum(tex * 1.1, 1)], -1) * 255)
    _FROST_CACHE[key] = tex
    return tex


def frost(x, severity=1, idx=None, frost_dir=None, rng=None):
    """corruption.py:134-186 (deterministic-idx variant used with
    perturb_mode='same', perturb_model.py:392-417).

    Quirk parity: the fork's ``idx = idx if idx else np.random.randint(5)``
    treats idx=0 as falsy -- a 0 is redrawn, and the redraw can only reach
    textures 0-4.  The same holds here so trajectories match."""
    rng = _state(rng)
    cv2 = _cv2()

    c = [(1, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75)][
        severity - 1
    ]
    idx = idx if idx else int(rng.randint(5))
    tex = _frost_texture(idx, frost_dir)
    x = np.asarray(x, np.float64)
    xh, xw = x.shape[:2]
    th, tw = tex.shape[:2]
    # the fork's scaling-factor cases collapse to max(ratios, 1) * 1.1
    # (corruption.py:151-170)
    scale = max(xh / th, xw / tw, 1.0) * 1.1
    tex = cv2.resize(tex, (int(np.ceil(tw * scale)), int(np.ceil(th * scale))),
                     interpolation=cv2.INTER_CUBIC)
    # exclusive-high randint exactly like the fork (corruption.py:176-179):
    # the bottom/right-most crop start is unreachable
    ys = rng.randint(0, tex.shape[0] - xh)
    xs = rng.randint(0, tex.shape[1] - xw)
    tex = tex[ys : ys + xh, xs : xs + xw]
    if tex.dtype == np.uint8:  # photo texture: BGR -> RGB after the crop
        tex = tex[..., [2, 1, 0]].astype(np.float64)
    return np.clip(c[0] * x + c[1] * tex, 0, 255)


def snow(x, severity=1, rng=None):
    """pip 1.1.2 snow: gaussian flake field -> clipped_zoom -> threshold ->
    clip -> directional shifted-accumulation blur at a random angle in
    [-135, -45] -> additive double-exposure (layer + its 180° rotation)."""
    rng = _state(rng)
    c = [
        (0.1, 0.3, 3, 0.5, 10, 4, 0.8),
        (0.2, 0.3, 2, 0.5, 12, 4, 0.7),
        (0.55, 0.3, 4, 0.9, 12, 8, 0.7),
        (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
        (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55),
    ][severity - 1]
    x = np.asarray(x, np.float32) / 255.0
    h, w = x.shape[:2]
    layer = rng.normal(size=(h, w), loc=c[0], scale=c[1])
    layer = clipped_zoom(layer[..., None], c[2]).squeeze()
    layer[layer < c[3]] = 0
    layer = np.clip(layer, 0, 1)

    angle = rng.uniform(-135, -45)
    # pip 1.1.2 order: blur the FULL zoomed layer, round it to uint8
    # steps ("the snow layer is rounded and cropped to the img dims"),
    # THEN crop; cropping first would blend different replicated columns
    # within a streak length of the right edge, and skipping the rounding
    # shifts final uint8 pixels by 1
    layer = _directional_blur(layer, c[4], c[5], angle)
    layer = np.round(layer * 255.0).astype(np.uint8) / 255.0
    layer = layer[:h, :w]
    if layer.shape != (h, w):   # clipped_zoom off-by-one (pip's fallback)
        layer = np.pad(layer, ((0, h - layer.shape[0]),
                               (0, w - layer.shape[1])), mode="edge")
    layer = layer[..., None]

    x = c[6] * x + (1 - c[6]) * np.maximum(
        x, rgb2gray(x)[..., None] * 1.5 + 0.5
    )
    return np.clip(x + layer + np.rot90(layer, k=2), 0, 1) * 255


def brightness(x, severity=1, rng=None):
    cv2 = _cv2()

    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    hsv = cv2.cvtColor(np.float32(x), cv2.COLOR_RGB2HSV)
    hsv[:, :, 2] = np.clip(hsv[:, :, 2] + c, 0, 1)
    return np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), 0, 1) * 255


def saturate(x, severity=1, rng=None):
    cv2 = _cv2()

    c = [(0.3, 0), (0.1, 0), (2, 0), (5, 0.1), (20, 0.2)][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    hsv = cv2.cvtColor(np.float32(x), cv2.COLOR_RGB2HSV)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] * c[0] + c[1], 0, 1)
    return np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), 0, 1) * 255


def contrast(x, severity=1, rng=None):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    means = np.mean(x, axis=(0, 1), keepdims=True)
    return np.clip((x - means) * c + means, 0, 1) * 255


def elastic_transform(x, severity=1, rng=None):
    rng = _state(rng)
    cv2 = _cv2()
    from scipy.ndimage import gaussian_filter, map_coordinates

    x = np.asarray(x, np.float64) / 255.0
    shape = x.shape
    c = [
        (shape[0] * 2, shape[0] * 0.7, shape[0] * 0.1),
        (shape[0] * 2, shape[0] * 0.08, shape[0] * 0.2),
        (shape[0] * 0.05, shape[0] * 0.01, shape[0] * 0.02),
        (shape[0] * 0.07, shape[0] * 0.01, shape[0] * 0.02),
        (shape[0] * 0.12, shape[0] * 0.01, shape[0] * 0.02),
    ][severity - 1]

    center = np.float32(shape[:2]) // 2
    sq_size = min(shape[:2]) // 3
    pts1 = np.float32([
        center + sq_size,
        [center[0] + sq_size, center[1] - sq_size],
        center - sq_size,
    ])
    pts2 = pts1 + rng.uniform(-c[2], c[2], size=pts1.shape).astype(
        np.float32
    )
    M = cv2.getAffineTransform(pts1, pts2)
    x = cv2.warpAffine(x, M, shape[1::-1], borderMode=cv2.BORDER_REFLECT_101)

    dx = (gaussian_filter(rng.uniform(-1, 1, size=shape[:2]), c[1],
                          mode="reflect", truncate=3) * c[0]).astype(np.float32)
    dy = (gaussian_filter(rng.uniform(-1, 1, size=shape[:2]), c[1],
                          mode="reflect", truncate=3) * c[0]).astype(np.float32)
    xg, yg, zg = np.meshgrid(np.arange(shape[1]), np.arange(shape[0]),
                             np.arange(shape[2]))
    indices = (np.reshape(yg + dy[..., None], (-1, 1)),
               np.reshape(xg + dx[..., None], (-1, 1)),
               np.reshape(zg, (-1, 1)))
    out = map_coordinates(x, indices, order=1, mode="reflect").reshape(shape)
    return np.clip(out, 0, 1) * 255


def pixelate(x, severity=1, rng=None):
    # pip 1.1.2 uses PIL Image.BOX down + Image.NEAREST up; cv2's
    # INTER_NEAREST maps dst->src indices differently (shifts the
    # pixelation grid by whole blocks -- measured 92% of pixels differing
    # at severity 5), so PIL is required for value parity
    from PIL import Image

    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    img = Image.fromarray(np.asarray(x, np.uint8))
    w, h = img.size
    img = img.resize((int(w * c), int(h * c)), Image.BOX)
    img = img.resize((w, h), Image.NEAREST)
    return np.asarray(img).astype(np.float64)


def jpeg_compression(x, severity=1, rng=None):
    cv2 = _cv2()

    c = [25, 18, 15, 10, 7][severity - 1]
    x = np.asarray(x, np.uint8)
    _, enc = cv2.imencode(".jpg", x[..., ::-1],
                          [int(cv2.IMWRITE_JPEG_QUALITY), c])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float64)


def spatter(x, severity=1, rng=None):
    rng = _state(rng)
    cv2 = _cv2()
    from scipy.ndimage import gaussian_filter

    c = [
        (0.65, 0.3, 4, 0.69, 0.6, 0), (0.65, 0.3, 3, 0.68, 0.6, 0),
        (0.65, 0.3, 2, 0.68, 0.5, 0), (0.65, 0.3, 1, 0.65, 1.5, 1),
        (0.67, 0.4, 1, 0.65, 1.5, 1),
    ][severity - 1]
    x = np.asarray(x, np.float64) / 255.0
    liquid = rng.normal(size=x.shape[:2], loc=c[0], scale=c[1])
    liquid = gaussian_filter(liquid, sigma=c[2], mode="nearest")
    liquid[liquid < c[3]] = 0
    if c[5] == 0:  # water
        liquid = (liquid * 255).astype(np.uint8)
        dist = 255 - cv2.Canny(liquid, 50, 150)
        dist = cv2.distanceTransform(dist, cv2.DIST_L2, 5)
        _, dist = cv2.threshold(dist, 20, 20, cv2.THRESH_TRUNC)
        dist = cv2.blur(dist, (3, 3)).astype(np.uint8)
        dist = cv2.equalizeHist(dist)
        ker = np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]])
        dist = cv2.filter2D(dist, cv2.CV_8U, ker)
        dist = cv2.blur(dist, (3, 3)).astype(np.float32)
        m = cv2.cvtColor(liquid * dist, cv2.COLOR_GRAY2RGBA)
        m /= np.max(m, axis=(0, 1)) + 1e-8
        m *= c[4]
        color = np.concatenate(
            (175 / 255.0 * np.ones_like(m[..., :1]),
             238 / 255.0 * np.ones_like(m[..., :1]),
             238 / 255.0 * np.ones_like(m[..., :1])), axis=2)
        color = cv2.cvtColor(color.astype(np.float32), cv2.COLOR_RGB2RGBA)
        xa = cv2.cvtColor(np.float32(x), cv2.COLOR_RGB2RGBA)
        out = cv2.cvtColor(np.clip(xa + m * color, 0, 1),
                           cv2.COLOR_RGBA2RGB) * 255
        return out
    # mud
    m = np.where(liquid > c[3], 1, 0).astype(np.float32)
    m = gaussian_filter(m.astype(np.float32), sigma=c[4], mode="nearest")
    m[m < 0.8] = 0
    color = np.stack([63 / 255.0 * np.ones_like(x[..., 0]),
                      42 / 255.0 * np.ones_like(x[..., 0]),
                      20 / 255.0 * np.ones_like(x[..., 0])], -1) * m[..., None]
    x *= (1 - m[..., None])
    return np.clip(x + color, 0, 1) * 255


_CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "speckle_noise": speckle_noise,
    "gaussian_blur": gaussian_blur,
    "glass_blur": glass_blur,
    "defocus_blur": defocus_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "fog": fog,
    "frost": frost,
    "snow": snow,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "spatter": spatter,
    "saturate": saturate,
}


def corrupt(image: np.ndarray, corruption_name: str, severity: int = 1,
            rng=None, **kwargs) -> np.ndarray:
    """Apply a corruption to a uint8 HWC RGB image; returns uint8.  Draws
    from ``rng`` (numpy's global state without one); ``severity`` is 1-5
    (the JAX copy takes a 0 silently as 5)."""
    if corruption_name not in _CORRUPTIONS:
        raise ValueError(
            f"unknown corruption {corruption_name}; "
            f"choices: {sorted(_CORRUPTIONS)}"
        )
    check_severity(severity)
    out = _CORRUPTIONS[corruption_name](image, severity, rng=rng, **kwargs)
    return np.uint8(np.clip(out, 0, 255))


def check_severity(severity) -> None:
    """Raise unless ``severity`` is one of the corruptions' 1-5."""
    if severity not in (1, 2, 3, 4, 5):
        raise ValueError(f"corruption severity must be 1-5, got {severity!r}")


def corrupt_pair(image0_01: np.ndarray, image1_01: np.ndarray,
                 corruption_name: str, severity: int,
                 mode: str = "both", frost_idx=None, rng=None) -> tuple:
    """PerturbationsModel.__image_corruptions semantics
    (perturb_model.py:384-418): float [0,1] NHWC pair -> corrupted pair,
    with perturb_mode='same' using the deterministic frost index for both
    frames.  Returns float [0,1] arrays.  Draws from ``rng`` (numpy's
    global state without one) in the JAX copy's order: the frost index,
    then frame 0's batch elements, then frame 1's."""
    rng = _state(rng)

    def apply(im01, idx):
        # per batch element (the reference only ever sees batch 1,
        # perturb_main.py:189)
        kwargs = {}
        if corruption_name == "frost" and idx is not None:
            kwargs["idx"] = idx
        outs = []
        for b in range(im01.shape[0]):
            img = np.uint8(np.clip(im01[b] * 255.0, 0, 255))
            out = corrupt(img, corruption_name, severity, rng=rng, **kwargs)
            outs.append(out.astype(np.float32) / 255.0)
        return np.stack(outs)

    if mode == "same" and corruption_name == "frost":
        # perturb_model.py:393 draws randint(5) (textures 0-4 only); a
        # drawn 0 is then redrawn inside frost() via its falsy-idx quirk
        idx = frost_idx if frost_idx is not None else rng.randint(5)
        return apply(image0_01, idx), apply(image1_01, idx)
    # BOTH frames are always corrupted (perturb_model.py:384-418 applies
    # the corruption to image0 and image1 unconditionally); perturb_mode
    # only selects the shared frost index above -- it never gates which
    # frame gets corrupted, unlike the gradient attacks' left/right masks.
    return apply(image0_01, None), apply(image1_01, None)
