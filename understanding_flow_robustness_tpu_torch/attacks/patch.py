"""Adversarial patch construction and placement, host-side numpy, NHWC (the
port's own copy of ``understanding_flow_robustness_tpu/attacks/patch.py``,
which imports no JAX; numpy and scipy only).

Reference: patch_attacks/utils_patch.py.  Patches are (1, h, w, 3) float
arrays in [0, 1] with (1, h, w, 3) masks; placement produces full-image
canvases (patch, mask, init) plus the location, as the reference does
(utils_patch.py:257-358) -- the canvases then feed the attack loop of
``patch_attack.py`` on the device.  Every random draw comes from the global
``np.random`` stream, in the reference's order, so a seeded run places
patches exactly where the JAX package's does.  Patches and masks read
from image files go through the port's own readers and resizes
(``flowviz.io``, ``native.resize_bilinear_u8``, ``data.transforms.imresize``).
"""

from __future__ import annotations

import re

import numpy as np
from scipy.ndimage import rotate, zoom


def create_circular_mask(h: int, w: int, center=None, radius=None) -> np.ndarray:
    """utils_patch.py:760-766 (default radius leaves a 2px rim)."""
    if center is None:
        center = [int(w / 2), int(h / 2)]
    if radius is None:
        radius = min(center[0], center[1], w - center[0], h - center[1]) - 2
    Y, X = np.ogrid[:h, :w]
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    return dist <= radius


def init_patch_square(image_size: int, patch_size: float):
    """utils_patch.py:769-775: random uniform patch with side
    image_size * patch_size."""
    dim = int(image_size * patch_size)
    patch = np.random.rand(1, dim, dim, 3)
    return patch, patch.shape


def init_patch_circle(image_size: int, patch_size: float):
    """utils_patch.py:250-254: square noise + circular mask."""
    patch, shape = init_patch_square(image_size, patch_size)
    mask = create_circular_mask(shape[1], shape[2]).astype("float32")
    mask = np.tile(mask[None, :, :, None], (1, 1, 1, 3))
    return patch, mask, patch.shape


def init_patch_from_image(image_path: str, mask_path: str,
                          image_size: int, patch_size: float):
    """utils_patch.py:769-778: initialize the patch from an image file.

    Side = floor(image_size * sqrt(patch_size)); the patch image maps to
    [-1, 1) via /128 - 1, the mask image to [0, 1) via /256.  NHWC
    (1, d, d, 3) instead of the reference's NCHW.
    """
    from ..flowviz.io import read_image
    from ..native import resize_bilinear_u8

    def _rgb(img):
        # a grey file -> 3 channels, alpha stripped (as the JAX package)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img[..., :3]

    dim = int(np.floor(image_size * np.sqrt(patch_size)))
    patch_img = _rgb(read_image(image_path))
    patch = resize_bilinear_u8(
        patch_img.astype(np.uint8), dim, dim
    ).astype(np.float32) / 128.0 - 1.0
    mask_img = _rgb(read_image(mask_path))
    mask = resize_bilinear_u8(
        mask_img.astype(np.uint8), dim, dim
    ).astype(np.float32) / 256.0
    return patch[None], mask[None], (1, dim, dim, 3)


def create_random_patch(patch_type: str, patch_size: int) -> np.ndarray:
    """utils_patch.py:38-59: gaussian/uniform/black/white/red/gray."""
    if patch_type == "gaussian":
        patch = np.random.normal(0.5, 0.5 ** 0.5, (patch_size, patch_size, 3))
    elif patch_type == "uniform":
        patch = np.random.uniform(0, 1, (patch_size, patch_size, 3))
    elif patch_type == "black":
        patch = np.zeros((patch_size, patch_size, 3))
    elif patch_type == "white":
        patch = np.ones((patch_size, patch_size, 3))
    elif patch_type == "red":
        patch = np.zeros((patch_size, patch_size, 3))
        patch[..., 0] = 1
    elif patch_type == "gray":
        patch = 0.5 * np.ones((patch_size, patch_size, 3))
    else:
        raise ValueError(patch_type)
    return patch[None]


def get_self_correlated_patches() -> list[str]:
    return [
        "hstripes", "vstripes", "vstripes_greenWhite", "vstripes_redBlack",
        "vstripes_redBlue", "vstripes_greenViolett", "vstripes_violettOrange",
        "checkered", "sin", "circle",
    ]


def create_correlated_patch(patch_type: str, patch_size: int) -> np.ndarray:
    """Handcrafted self-correlated patches (utils_patch.py:77-233): stripe
    families (incl. rotated / parameterized thickness / colored), checkers,
    sinusoid stripes, concentric circles."""
    n = patch_size

    def stripes(axis, fg=None, bg=None, thickness=2, alt=None):
        patch = np.zeros((n, n, 3)) if bg is None else np.ones((n, n, 3)) * bg
        for s in range(0, n, 2 * thickness):
            sl = (slice(s, s + thickness), slice(None)) if axis == 0 else (
                slice(None), slice(s, s + thickness))
            patch[sl] = fg if fg is not None else 1
        if alt is not None:
            for s in range(thickness, n, 2 * thickness):
                patch[:, s : s + thickness] = alt
        return patch

    if patch_type == "hstripes":
        patch = stripes(0, fg=1)
    elif "vstripes_greenWhite" in patch_type:
        patch = np.ones((n, n, 3))
        for s in range(0, n, 4):
            patch[:, s : s + 2, 0] = 0
            patch[:, s : s + 2, 2] = 0
    elif "vstripes_redBlack" in patch_type:
        patch = stripes(1, fg=[1, 0, 0])
    elif "vstripes_redBlue" in patch_type:
        patch = stripes(1, fg=[1, 0, 0], alt=[0, 0, 1])
    elif "vstripes_violettOrange" in patch_type:
        patch = stripes(1, fg=[0.9, 0.7, 0.3], alt=[0.8, 0.1, 0.8])
    elif "vstripes_greenViolett" in patch_type:
        patch = stripes(1, fg=[0.7, 0.8, 0.1], alt=[0.6, 0.0, 0.6])
    elif "vstripes_strip" in patch_type:
        t = int(re.findall(r"\d+", patch_type)[0])
        patch = stripes(1, fg=1, thickness=t)
    elif "vstripes_rot" in patch_type:
        big = np.zeros((2 * n, 2 * n, 3))
        for s in range(0, 2 * n, 4):
            big[:, s : s + 2] = 1
        angle = int(re.findall(r"\d+", patch_type)[0])
        big = rotate(big, angle=angle, reshape=False, order=1)
        patch = big[n // 2 : n // 2 + n, n // 2 : n // 2 + n]
    elif "vstripes_Bcol" in patch_type and "_col" in patch_type:
        nums = re.findall(r"[-+]?\d*\.\d+|\d+", patch_type)
        patch = stripes(1, fg=float(nums[1]), bg=float(nums[0]))
    elif "vstripes_Bcol" in patch_type:
        bg = float(re.findall(r"\d+\.\d+", patch_type)[0])
        patch = stripes(1, fg=1, bg=bg)
    elif "vstripes_col" in patch_type:
        col = float(re.findall(r"\d+\.\d+", patch_type)[0])
        patch = stripes(1, fg=col)
    elif "vstripes" in patch_type:
        patch = stripes(1, fg=1)
    elif patch_type == "checkered":
        t = max(n // 48, 1)
        patch = np.ones((n, n, 3))
        for s in range(0, n, 2 * t):
            patch[s : s + t, :, :] = 0
            patch[:, s : s + t, :] = 0
    elif patch_type == "sin":
        t = max(n // 24, 1)
        patch = np.zeros((n, n, 3))
        sin_offset = 5 * np.sin(2 * np.pi * np.arange(n) / (0.25 * n)) + 5
        for strip in range(0, n, 2 * t):
            # the reference draws an always-true gate THEN the width
            # (utils_patch.py:201-203); both draws must happen to keep
            # the global np.random stream aligned for seeded parity
            if np.random.randint(0, 2) >= 0:
                green = np.random.randint(1, 2)
                patch[strip : strip + green, :, :] = 1
            for i, y in enumerate(sin_offset):
                y = int(y)
                if y + strip > n:
                    continue
                if n < y + strip + t:
                    patch[y + strip :, :, :] = 0
                patch[y + strip : y + strip + t, i, 2] = 1
                patch[y + strip : y + strip + t, i, 0] = 0
    elif patch_type == "circle":
        import cv2

        patch = np.ones((n, n, 3)) * 255
        t = max(n // 48, 1)
        for radius in range(0, n // 2, 2 * t):
            cv2.circle(patch, center=(n // 2, n // 2), radius=radius,
                       color=(0, 0, 0), thickness=t)
        patch = patch / 255
    else:
        raise ValueError(f"self-correlation type not implemented: {patch_type}")
    return patch[None]


def get_patch_and_mask(patch_size=None, patch_type="circle",
                       self_correlated=None, random_type=None,
                       patch_path=None, mask_path=None):
    """utils_patch.py:13-35 (patch selection + default mask)."""
    if self_correlated:
        patch = create_correlated_patch(self_correlated, patch_size)
    elif random_type:
        patch = create_random_patch(random_type, patch_size)
    elif patch_path:
        patch = np.load(patch_path)
    else:
        raise ValueError("need one of self_correlated/random_type/patch_path")
    shape = patch.shape
    if mask_path:
        from ..data.transforms import imresize
        from ..flowviz import io as fio

        mask_img = imresize(fio.read_image(mask_path), shape[1:3]) / 256.0
        mask = mask_img[None]
    elif patch_type == "circle":
        m = create_circular_mask(shape[1], shape[2]).astype("float32")
        mask = np.tile(m[None, :, :, None], (1, 1, 1, 3))
    else:
        mask = np.ones(shape, np.float32)
    return patch, shape, mask


def circle_transform(patch, mask, patch_init, data_shape, patch_shape,
                     margin=0, center=False, norotate=False,
                     fixed_loc=(-1, -1), moving=False):
    """Random jitter/zoom/rotate + placement into a full-image canvas
    (utils_patch.py:257-358).  data_shape is the NHWC image batch shape.
    Returns (canvas, mask_canvas, init_canvas, rx, ry, patch_shape)."""
    if not moving:
        patch = patch + np.random.random() * 0.1 - 0.05
    patch = np.clip(patch, 0.0, 1.0)
    patch = patch * mask

    B, image_h, image_w = data_shape[0], data_shape[1], data_shape[2]
    x = np.zeros(data_shape)
    xm = np.zeros(data_shape)
    xp = np.zeros(data_shape)

    if not moving:
        zf = 1 + 0.05 * (np.random.random() - 0.5)
        patch = zoom(patch, zoom=(1, zf, zf, 1), order=1)
        mask = zoom(mask, zoom=(1, zf, zf, 1), order=0)
        patch_init = zoom(patch_init, zoom=(1, zf, zf, 1), order=1)
    patch_shape = patch.shape
    m_size = patch.shape[2]

    rx = ry = 0
    for i in range(B):
        if not norotate:
            rot = 10 * (np.random.random() - 0.5)
            patch[i] = rotate(patch[i], angle=rot, axes=(0, 1),
                              reshape=False, order=1)
            patch_init[i] = rotate(patch_init[i], angle=rot, axes=(0, 1),
                                   reshape=False, order=1)
        if fixed_loc[0] < 0 or fixed_loc[1] < 0:
            if center:
                rx = (image_w - m_size) // 2
                ry = (image_h - m_size) // 2
            else:
                rx = m_size + margin + np.random.choice(
                    image_w - 2 * m_size - 2 * margin - 2
                )
                ry = m_size + np.random.choice(image_h - 2 * m_size - 2)
        else:
            rx, ry = fixed_loc

        ph, pw = patch_shape[1], patch_shape[2]
        x[i, ry : ry + ph, rx : rx + pw] = patch[i]
        xm[i, ry : ry + ph, rx : rx + pw] = mask[i]
        xp[i, ry : ry + ph, rx : rx + pw] = patch_init[i]

    return x, xm, xp, rx, ry, patch_shape


def circle_transform_two_patches(patches, mask, patch_inits, data_shape,
                                 patch_shape, margin=0, center=False,
                                 norotate=False, fixed_loc=(-1, -1)):
    """Place TWO patches with identical jitter/zoom/rotation/location
    (utils_patch.py:361-496) — used by the feature-replacement analysis to
    compare a uniform patch against the test patch at the same spot.
    Returns (canvas1, canvas2, mask_canvas, init1, init2, rx, ry, shape)."""
    noise = np.random.random() * 0.1 - 0.05
    patches = [np.clip(p + noise, 0.0, 1.0) * mask for p in patches]

    B, image_h, image_w = data_shape[0], data_shape[1], data_shape[2]
    canvases = [np.zeros(data_shape), np.zeros(data_shape)]
    xm = np.zeros(data_shape)
    inits = [np.zeros(data_shape), np.zeros(data_shape)]

    zf = 1 + 0.05 * (np.random.random() - 0.5)
    patches = [zoom(p, zoom=(1, zf, zf, 1), order=1) for p in patches]
    mask = zoom(mask, zoom=(1, zf, zf, 1), order=0)
    patch_inits = [zoom(p, zoom=(1, zf, zf, 1), order=1) for p in patch_inits]
    patch_shape = patches[0].shape
    m_size = patch_shape[2]

    rx = ry = 0
    for i in range(B):
        if not norotate:
            rot = 10 * (np.random.random() - 0.5)
            for k in range(2):
                patches[k][i] = rotate(patches[k][i], angle=rot, axes=(0, 1),
                                       reshape=False, order=1)
                patch_inits[k][i] = rotate(patch_inits[k][i], angle=rot,
                                           axes=(0, 1), reshape=False, order=1)
        if fixed_loc[0] < 0 or fixed_loc[1] < 0:
            if center:
                rx = (image_w - m_size) // 2
                ry = (image_h - m_size) // 2
            else:
                rx = m_size + margin + np.random.choice(
                    image_w - 2 * m_size - 2 * margin - 2)
                ry = m_size + np.random.choice(image_h - 2 * m_size - 2)
        else:
            rx, ry = fixed_loc
        ph, pw = patch_shape[1], patch_shape[2]
        for k in range(2):
            canvases[k][i, ry : ry + ph, rx : rx + pw] = patches[k][i]
            inits[k][i, ry : ry + ph, rx : rx + pw] = patch_inits[k][i]
        xm[i, ry : ry + ph, rx : rx + pw] = mask[i]

    return canvases[0], canvases[1], xm, inits[0], inits[1], rx, ry, patch_shape


def circle_transform_different(patch, mask, patch_init, data_shape,
                               patch_shape, margin=0, center=False,
                               norotate=False, fixed_loc=(-1, -1)):
    """Independent per-frame patch transforms with GT synthesized from the
    composed transform (utils_patch.py:499-757).

    The target and reference frames each get their own brightness jitter,
    zoom and rotation; the reference frame additionally gets a large random
    translation.  The returned GT flow canvas encodes the patch's apparent
    motion: the rot_ref rotation field about the patch centre, plus the
    translation, all scaled by zoom_ref/zoom_tgt — the reference's exact
    formula, including its quirks (the mask is zoomed but never rotated;
    the rotation field is evaluated on the TARGET patch grid; the
    translation is scaled by the zoom ratio too).

    np.random draw order matches the reference exactly, so seeding
    np.random gives bit-identical placements (held against the JAX
    package's copy in tests/test_torch_patch.py).

    Returns ([x_tgt, x_ref], [xm_tgt, xm_ref], out_flow_canvas,
    [xp_tgt, xp_ref], [rx, rx_ref], [ry, ry_ref], patch_shape) — all NHWC.
    """
    # ---- target frame (draws 1-2: jitter, zoom) ----
    patch_tgt = patch + np.random.random() * 0.1 - 0.05
    patch_tgt = np.clip(patch_tgt, 0.0, 1.0) * mask
    B, image_h, image_w = data_shape[0], data_shape[1], data_shape[2]
    x_tgt = np.zeros(data_shape)
    xm_tgt = np.zeros(data_shape)
    xp_tgt = np.zeros(data_shape)

    zoom_factor_tgt = 1 + 0.05 * (np.random.random() - 0.5)
    patch_tgt = zoom(patch_tgt, zoom=(1, zoom_factor_tgt, zoom_factor_tgt, 1),
                     order=1)
    mask_tgt = zoom(mask, zoom=(1, zoom_factor_tgt, zoom_factor_tgt, 1),
                    order=0)
    patch_init_tgt = zoom(patch_init,
                          zoom=(1, zoom_factor_tgt, zoom_factor_tgt, 1),
                          order=1)
    patch_tgt_shape = patch_tgt.shape
    m_size = patch.shape[2]
    rx = ry = 0
    for i in range(B):
        if not norotate:  # draw 3: rotation (mask intentionally NOT rotated)
            rot_tgt = 10 * (np.random.random() - 0.5)
            patch_tgt[i] = rotate(patch_tgt[i], angle=rot_tgt, axes=(0, 1),
                                  reshape=False, order=1)
            patch_init_tgt[i] = rotate(patch_init_tgt[i], angle=rot_tgt,
                                       axes=(0, 1), reshape=False, order=1)
        if fixed_loc[0] < 0 or fixed_loc[1] < 0:  # draws 4-5: location
            if center:
                rx = (image_w - m_size) // 2
                ry = (image_h - m_size) // 2
            else:
                rx = m_size + margin + np.random.choice(
                    image_w - 2 * m_size - 2 * margin - 2
                )
                ry = m_size + np.random.choice(image_h - 2 * m_size - 2)
        else:
            rx, ry = fixed_loc
        ph, pw = patch_tgt_shape[1], patch_tgt_shape[2]
        x_tgt[i, ry : ry + ph, rx : rx + pw] = patch_tgt[i]
        xm_tgt[i, ry : ry + ph, rx : rx + pw] = mask_tgt[i]
        xp_tgt[i, ry : ry + ph, rx : rx + pw] = patch_init_tgt[i]

    # patch-local GT flow: (u, v, valid) on the TARGET patch grid
    flow = np.zeros_like(patch_tgt)
    flow[..., -1] = 1

    # ---- reference frame (draws 6-7: jitter, zoom) ----
    patch_ref = patch + np.random.random() * 0.1 - 0.05
    patch_ref = np.clip(patch_ref, 0.0, 1.0) * mask
    zoom_factor_ref = 1 + 0.05 * (np.random.random() - 0.5)
    patch_ref = zoom(patch_ref, zoom=(1, zoom_factor_ref, zoom_factor_ref, 1),
                     order=1)
    mask_ref = zoom(mask, zoom=(1, zoom_factor_ref, zoom_factor_ref, 1),
                    order=0)
    patch_init_ref = zoom(patch_init,
                          zoom=(1, zoom_factor_ref, zoom_factor_ref, 1),
                          order=1)
    patch_ref_shape = patch_ref.shape

    i = B - 1  # the reference leaks the loop index (utils_patch.py:640)
    if not norotate:  # draw 8: ref rotation + rotational flow field
        rot_ref = 360 * (np.random.random() - 0.5)
        patch_ref[i] = rotate(patch_ref[i], angle=rot_ref, axes=(0, 1),
                              reshape=False, order=1)
        patch_init_ref[i] = rotate(patch_init_ref[i], angle=rot_ref,
                                   axes=(0, 1), reshape=False, order=1)

        target = flow[i, :, :, :2]
        diff_rad = rot_ref * np.pi / 180
        h, w = target.shape[:2]
        warped = np.mgrid[:w, :h].T.astype(float) + target
        warped -= np.array([w / 2, h / 2])
        rot_field = np.zeros_like(target)
        rot_field[..., 0] = (
            (np.cos(diff_rad) - 1) * warped[..., 0]
            + np.sin(diff_rad) * warped[..., 1]
        )
        rot_field[..., 1] = (
            -np.sin(diff_rad) * warped[..., 0]
            + (np.cos(diff_rad) - 1) * warped[..., 1]
        )
        flow[i, :, :, :2] = target + rot_field

    # draws 9-10: translation, pushed back in-bounds
    patch_translation_u = round(100 * ((np.random.random() - 0.5) / 0.5))
    while patch_translation_u + rx < 0:
        patch_translation_u += 1
    while patch_translation_u + rx + patch_ref_shape[2] > image_w:
        patch_translation_u -= 1
    rx_ref = rx + patch_translation_u

    patch_translation_v = round(100 * ((np.random.random() - 0.5) / 0.5))
    while patch_translation_v + ry < 0:
        patch_translation_v += 1
    while patch_translation_v + ry + patch_ref_shape[1] > image_h:
        patch_translation_v -= 1
    ry_ref = ry + patch_translation_v

    flow[..., 0] += patch_translation_u
    flow[..., 1] += patch_translation_v
    flow[..., :2] *= zoom_factor_ref / zoom_factor_tgt

    x_ref = np.zeros(data_shape)
    xm_ref = np.zeros(data_shape)
    xp_ref = np.zeros(data_shape)
    for i in range(B):
        ph, pw = patch_ref_shape[1], patch_ref_shape[2]
        x_ref[i, ry_ref : ry_ref + ph, rx_ref : rx_ref + pw] = patch_ref[i]
        xm_ref[i, ry_ref : ry_ref + ph, rx_ref : rx_ref + pw] = mask_ref[i]
        xp_ref[i, ry_ref : ry_ref + ph, rx_ref : rx_ref + pw] = (
            patch_init_ref[i]
        )

    out_flow = np.zeros_like(x_tgt)
    ph, pw = patch_tgt_shape[1], patch_tgt_shape[2]
    out_flow[0, ry : ry + ph, rx : rx + pw, :] = flow[0] * mask_tgt[0]

    return (
        [x_tgt, x_ref], [xm_tgt, xm_ref], out_flow, [xp_tgt, xp_ref],
        [rx, rx_ref], [ry, ry_ref], patch_shape,
    )


def square_transform(patch, mask, patch_init, data_shape, patch_shape,
                     norotate=False):
    """utils_patch.py:781-846: random 90-degree rotation + placement."""
    B, image_h, image_w = data_shape[0], data_shape[1], data_shape[2]
    x = np.zeros(data_shape)
    xm = np.zeros(data_shape)
    xp = np.zeros(data_shape)
    m_size = patch_shape[2]
    rx = ry = 0
    for i in range(B):
        if not norotate:
            rot = np.random.choice(4)
            patch[i] = np.rot90(patch[i], rot, axes=(0, 1))
            mask[i] = np.rot90(mask[i], rot, axes=(0, 1))
            patch_init[i] = np.rot90(patch_init[i], rot, axes=(0, 1))
        rx = np.random.choice(image_w - m_size - 1)
        ry = np.random.choice(image_h - m_size - 1)
        ph, pw = patch_shape[1], patch_shape[2]
        x[i, ry : ry + ph, rx : rx + pw] = patch[i]
        xm[i, ry : ry + ph, rx : rx + pw] = mask[i]
        xp[i, ry : ry + ph, rx : rx + pw] = patch_init[i]
    return x, xm, xp, rx, ry


def extract_patch(canvas, rx, ry, patch_shape) -> np.ndarray:
    """Extract the patch region back out of a full-image canvas
    (patch_attacks/main.py:408-430)."""
    ph, pw = patch_shape[1], patch_shape[2]
    return np.array(canvas[:, ry : ry + ph, rx : rx + pw, :])


def rezoom_to(patch, mask, patch_init, patch_shape, orig_shape):
    """Re-zoom the extracted patch back to the original patch size
    (patch_attacks/main.py:432-462)."""
    fy = orig_shape[1] / patch_shape[1]
    fx = orig_shape[2] / patch_shape[2]
    patch = zoom(patch, zoom=(1, fy, fx, 1), order=1)
    mask = zoom(mask, zoom=(1, fy, fx, 1), order=0)
    patch_init = zoom(patch_init, zoom=(1, fy, fx, 1), order=1)
    return patch, mask, patch_init, patch.shape
