"""The port's JPEG encoder (``flowviz/jpeg.py`` over
``native/src/ufr_jpeg_enc.cpp``) against libjpeg-turbo as cv2.imencode and
PIL's save run it, on the CPU: at every quality jpeg_compression and the
viz panels use and at the ends of the range, on sizes that are not
multiples of 16, on flat, smooth and noisy images.

The port's file decodes (by cv2.imdecode and by the port's own decoder) to
the same samples as cv2's and PIL's files; its entropy-coded segment is
byte for byte cv2's and PIL's, and the whole file is cv2's.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from understanding_flow_robustness_tpu_torch.flowviz.jpeg import (
    decode_jpeg,
    encode_jpeg,
)

QUALITIES = (1, 7, 10, 15, 18, 25, 50, 75, 95, 100)
SIZES = ((37, 53), (1, 1), (17, 9), (8, 31), (16, 16), (384, 1280))


def _image(kind, h, w, seed):
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), 128, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 3) % 256, (yy * 5) % 256, (xx + yy) % 256],
                    -1).astype(np.uint8)


def _entropy_coded(data: bytes) -> bytes:
    i = data.index(b"\xff\xda")
    return data[i + 2 + int.from_bytes(data[i + 2:i + 4], "big"):]


@pytest.mark.parametrize("kind", ["noise", "flat", "smooth"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_encoder_matches_libjpeg_turbo(quality, kind):
    for h, w in SIZES:
        img = _image(kind, h, w, seed=quality * 7 + h)
        ours = encode_jpeg(img, quality)
        _, enc = cv2.imencode(".jpg", img[..., ::-1],
                              [cv2.IMWRITE_JPEG_QUALITY, quality])
        theirs = enc.tobytes()
        bio = io.BytesIO()
        Image.fromarray(img).save(bio, "JPEG", quality=quality)
        pil = bio.getvalue()
        msg = f"{kind} {h}x{w} q{quality}"
        assert _entropy_coded(ours) == _entropy_coded(theirs), msg
        assert _entropy_coded(ours) == _entropy_coded(pil), msg
        assert ours == theirs, msg
        want = cv2.imdecode(enc, cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_COLOR),
            want, err_msg=msg)
        np.testing.assert_array_equal(decode_jpeg(ours), want[..., ::-1],
                                      err_msg=msg)
        np.testing.assert_array_equal(
            decode_jpeg(ours), np.asarray(Image.open(io.BytesIO(pil))),
            err_msg=msg)


def test_encoder_refuses_bad_input():
    with pytest.raises(ValueError, match="quality"):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8), 0)
    with pytest.raises(ValueError, match="u8"):
        encode_jpeg(np.zeros((8, 8, 3), np.float32), 75)
    with pytest.raises(ValueError, match="u8"):
        encode_jpeg(np.zeros((8, 8, 4), np.uint8), 75)
    with pytest.raises(ValueError, match="u8"):
        encode_jpeg(np.zeros((8, 8), np.uint8), 75)
