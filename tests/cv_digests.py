"""The reference side of ``understanding_flow_robustness_tpu_torch/data/
fixtures/cv_digests.json``: the seeded cases of the port's
``native/cv_cases.py`` run on cv2 and PIL (``Cv2Ops``, the calls that
``native/cv.py`` replaces, under its names), and their SHA-256 digests.
``python tests/cv_digests.py`` rewrites the fixture (run it where cv2 and
PIL are installed); ``tests/test_torch_cv_ops.py`` checks that it is
current and that the port reproduces it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from understanding_flow_robustness_tpu_torch.native import cv_cases  # noqa: E402


class Cv2Ops:
    """``cv_cases.OPS`` as the cv2 and PIL calls themselves, at their
    defaults."""

    @staticmethod
    def rgb2hsv(x):
        import cv2

        return cv2.cvtColor(x, cv2.COLOR_RGB2HSV)

    @staticmethod
    def hsv2rgb(x):
        import cv2

        return cv2.cvtColor(x, cv2.COLOR_HSV2RGB)

    @staticmethod
    def gaussian_blur(plane, ksize, sigma):
        import cv2

        return cv2.GaussianBlur(plane, ksize=(ksize, ksize), sigmaX=sigma)

    @staticmethod
    def get_affine_transform(src, dst):
        import cv2

        return cv2.getAffineTransform(src, dst)

    @staticmethod
    def warp_affine(img, m, dsize):
        import cv2

        return cv2.warpAffine(img, m, dsize,
                              borderMode=cv2.BORDER_REFLECT_101)

    @staticmethod
    def resize_cubic(img, dsize):
        import cv2

        return cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC)

    @staticmethod
    def canny(img, low, high):
        import cv2

        return cv2.Canny(img, low, high)

    @staticmethod
    def distance_transform_l2_5(img):
        import cv2

        return cv2.distanceTransform(img, cv2.DIST_L2, 5)

    @staticmethod
    def threshold_trunc(img, thresh):
        import cv2

        return cv2.threshold(img, thresh, thresh, cv2.THRESH_TRUNC)[1]

    @staticmethod
    def blur3(img):
        import cv2

        return cv2.blur(img, (3, 3))

    @staticmethod
    def equalize_hist(img):
        import cv2

        return cv2.equalizeHist(img)

    @staticmethod
    def filter2d_u8_3x3(img, kernel):
        import cv2

        return cv2.filter2D(img, cv2.CV_8U, kernel)

    @staticmethod
    def circle(img, center, radius, color, thickness):
        import cv2

        return cv2.circle(img, center=center, radius=radius, color=color,
                          thickness=thickness)

    @staticmethod
    def pil_resize(img, size, resample):
        from PIL import Image

        filt = {"box": Image.BOX, "nearest": Image.NEAREST}[resample]
        return np.asarray(Image.fromarray(img).resize(size, filt))

    @staticmethod
    def encode_jpeg(img, quality):
        import cv2

        _, enc = cv2.imencode(".jpg", img[..., ::-1],
                              [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        return enc.tobytes()

    @staticmethod
    def decode_jpeg(data):
        import cv2

        return cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR)[..., ::-1]


def reference_digests() -> dict:
    return cv_cases.digests(Cv2Ops)


def fixture_text(digests: dict) -> str:
    import cv2
    import PIL

    return json.dumps({
        "generated_by": "tests/cv_digests.py",
        "opencv": cv2.__version__, "pillow": PIL.__version__,
        "digests": digests}, indent=1, sort_keys=True) + "\n"


if __name__ == "__main__":
    cv_cases.FIXTURE.write_text(fixture_text(reference_digests()))
    print(f"wrote {cv_cases.FIXTURE}")
