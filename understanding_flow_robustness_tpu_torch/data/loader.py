"""Batch padding (counterpart of
``understanding_flow_robustness_tpu/data/loader.py:19-39``).  The JAX
package's shuffled, threaded ``DataLoader`` is not ported yet (ROADMAP
A11b)."""

from __future__ import annotations

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
