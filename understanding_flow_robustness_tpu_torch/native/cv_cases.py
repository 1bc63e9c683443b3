"""Seeded inputs for the host library's OpenCV / Pillow operations and the
SHA-256 digests of what they compute on them.

Each case is ``(name, op, args)``; ``run(op, *args, ops=...)`` computes it
with a set of operations named as in ``native/cv.py`` (``OPS``), through
the corruptions' and patches' own helpers where they chain several calls,
and ``digest`` hashes the outputs with their dtypes and shapes.
``port_digests()`` runs the cases on the host library alone, so a machine
without cv2 or PIL (the one with the card) checks that its compiler and
maths library give the same bits as the fixture
``data/fixtures/cv_digests.json``, which ``tests/cv_digests.py`` writes by
running the same cases on cv2 and PIL.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import cv

FIXTURE = (Path(__file__).resolve().parents[1] / "data" / "fixtures"
           / "cv_digests.json")
JPEG_QUALITIES = (25, 18, 15, 10, 7, 75)  # jpeg_compression's and PIL's
CIRCLE_SIZES = (40, 96, 153, 400)
DISKS = ((3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5))
PIXELATE = (0.6, 0.5, 0.4, 0.3, 0.25)
# the operations run() calls, by native/cv.py's names
OPS = ("rgb2hsv", "hsv2rgb", "gaussian_blur", "get_affine_transform",
       "warp_affine", "resize_cubic", "canny", "distance_transform_l2_5",
       "threshold_trunc", "blur3", "equalize_hist", "filter2d_u8_3x3",
       "circle", "pil_resize", "encode_jpeg", "decode_jpeg")


def port_ops() -> SimpleNamespace:
    """``OPS`` on the host library: ``native/cv.py`` and the JPEG codec
    (``encode_jpeg(rgb_u8, quality) -> bytes``, ``decode_jpeg(bytes)``)."""
    from ..flowviz.jpeg import decode_jpeg, encode_jpeg

    return SimpleNamespace(
        encode_jpeg=encode_jpeg, decode_jpeg=decode_jpeg,
        **{n: getattr(cv, n) for n in OPS if n not in ("encode_jpeg",
                                                       "decode_jpeg")})


def _image(h, w, seed):
    """A u8 RGB frame with smooth structure and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 17.0 + c) * np.cos(yy / 11.0)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


def cases():
    """The digest cases in a fixed order."""
    out = []
    for size in ((384, 1280), (37, 53), (17, 9)):
        img = _image(*size, seed=size[1])
        for q in JPEG_QUALITIES:
            out.append((f"jpeg/{size[0]}x{size[1]}/q{q}", "jpeg", (img, q)))
    for w in (1280, 83):
        x = np.random.RandomState(w).rand(48, w, 3).astype(np.float32)
        out.append((f"hsv/48x{w}", "hsv", (x,)))
    img = _image(97, 131, seed=5)
    for c in PIXELATE:
        out.append((f"pixelate/{c}", "pixelate", (img, c)))
    for n in CIRCLE_SIZES:
        out.append((f"circle/{n}", "circle", (n,)))
    for r, a in DISKS:
        out.append((f"disk/{r}/{a}", "disk", (r, a)))
    for h, w in ((384, 1280), (97, 131)):
        x = np.random.RandomState(h).rand(h, w, 3)
        out.append((f"warp/{h}x{w}", "warp", (x, h * 0.1, w)))
    tex = np.random.RandomState(7).rand(512, 512, 3) * 255
    out.append(("cubic/f64/512x512->512x640", "cubic", (tex, (640, 512))))
    tex8 = _image(90, 120, seed=9)[..., ::-1].copy()
    photo = _image(512, 768, seed=11)[..., ::-1].copy()
    for name, t, frame in (("90x120/64x96", tex8, (64, 96)),
                           ("90x120/384x1280", tex8, (384, 1280)),
                           ("512x768/384x1280", photo, (384, 1280))):
        out.append((f"frost_texture/u8/{name}", "frost_texture", (t, frame)))
    for h, w in ((384, 1280), (61, 83)):
        out.append((f"spatter/{h}x{w}", "spatter", ((h, w), h)))
    return out


def run(op, *args, ops):
    """One case's outputs, computed with ``ops``."""
    from ..attacks import corruptions, patch

    if op == "jpeg":
        data = ops.encode_jpeg(*args)
        return [data, ops.decode_jpeg(data)]
    if op == "hsv":
        hsv, sat = corruptions.hsv_edit(args[0], 1, 2, 0.1, ops=ops)
        return [hsv, sat, corruptions.hsv_edit(args[0], 2, 1, 0.3, ops=ops)[1]]
    if op == "pixelate":
        return list(corruptions.pixelate_steps(*args, ops=ops))
    if op == "circle":
        return [patch.circle_rings(*args, ops=ops)]
    if op == "disk":
        return [corruptions.disk(*args, ops=ops)]
    if op == "warp":
        x, jitter, seed = args
        return [corruptions.affine_jitter(x, jitter,
                                          np.random.RandomState(seed),
                                          ops=ops)]
    if op == "cubic":
        return [ops.resize_cubic(*args)]
    if op == "frost_texture":
        return [corruptions.fit_texture(*args, ops=ops)]
    if op == "spatter":
        shape, seed = args
        liquid = corruptions.liquid_layer(shape, (0.65, 0.3, 3, 0.68),
                                          np.random.RandomState(seed))
        return corruptions.water_stages((liquid * 255).astype(np.uint8),
                                        ops=ops)
    raise ValueError(f"unknown case op {op!r}")


def digest(outputs) -> str:
    h = hashlib.sha256()
    for o in outputs:
        if isinstance(o, (bytes, bytearray)):
            h.update(b"bytes")
            h.update(bytes(o))
        else:
            a = np.ascontiguousarray(o)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def digests(ops) -> dict:
    """Every case's digest, computed with ``ops``."""
    return {name: digest(run(op, *args, ops=ops))
            for name, op, args in cases()}


def port_digests() -> dict:
    return digests(port_ops())


def load_fixture() -> dict:
    return json.loads(FIXTURE.read_text())["digests"]
