"""SPyNet, inference (counterpart of
``understanding_flow_robustness_tpu/models/spynet.py``; reference:
models/spynet.py:9-281).

Coarse-to-fine residual pyramid of 6 levels.  Each level warps the second
image by the upsampled flow (``ops.warp_backward``, mode "spynet": the CUDA
kernel ``csrc/warp_fwd.cu`` on the card) and a 5-conv G-unit predicts the
residual from (first image, warped second image, upsampled flow).  NCHW
modules named after the reference's ``Basic`` (``moduleBasic``, a
Sequential of 7x7 convs and ReLUs), so ``moduleBasic.{level}.moduleBasic.
{0,2,4,6,8}`` are the convs of one level; the reference ships them as
per-level weight files (``convert.load_spynet_dir``).  f32 only, as the
JAX registry runs it.  The JAX package's 2x2 space-to-depth G-units are
TPU layout machinery and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interp import avg_pool2, resize_bilinear
from ..ops.warp import warp_backward
from ..parallel.spatial import row_mesh

# ImageNet statistics (models/spynet.py:39-45)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
_CHANNELS = (8, 32, 64, 32, 16, 2)


def spynet_preprocess(im: torch.Tensor) -> torch.Tensor:
    """(im - mean) / std per RGB channel, NCHW."""
    mean = torch.tensor(_MEAN, dtype=im.dtype, device=im.device)[:, None, None]
    std = torch.tensor(_STD, dtype=im.dtype, device=im.device)[:, None, None]
    return (im - mean) / std


class SpyNetBasic(nn.Module):
    """One level's G-unit: 7x7 convs 8->32->64->32->16->2, ReLU between
    (none after the last); models/spynet.py:51-130."""

    def __init__(self):
        super().__init__()
        layers = []
        for i, (cin, cout) in enumerate(zip(_CHANNELS[:-1], _CHANNELS[1:])):
            if i:
                layers.append(nn.ReLU(inplace=False))
            layers.append(nn.Conv2d(cin, cout, 7, 1, 3))
        self.moduleBasic = nn.Sequential(*layers)

    def forward(self, x):
        return self.moduleBasic(x)


class SpyNet(nn.Module):
    """models/spynet.py:183-281 (``Network``).  Images (B, 3, H, W) RGB in
    [0, 1] -> flow (B, 2, H, W) at the finest level, which is the input's
    size; ``train=True`` returns every level's flow, finest first.
    ``plain_warp`` runs the warps' plain version also on the card, to hold
    the kernel against it."""

    def __init__(self, nlevels: int = 6, plain_warp: bool = False):
        super().__init__()
        self.nlevels = nlevels
        self.plain_warp = plain_warp
        self.moduleBasic = nn.ModuleList(SpyNetBasic() for _ in range(nlevels))

    def forward(self, im1, im2, train: bool = False):
        x1 = [spynet_preprocess(im1)]
        x2 = [spynet_preprocess(im2)]
        for _ in range(self.nlevels - 1):
            x1.insert(0, avg_pool2(x1[0]))
            x2.insert(0, avg_pool2(x2[0]))

        B, _, h0, w0 = x1[0].shape
        flow = im1.new_zeros((B, 2, h0 // 2, w0 // 2), dtype=torch.float32)
        flows = []
        for level in range(self.nlevels):
            h, w = x1[level].shape[2:]
            # x2 bilinear upsample, align_corners=False, values doubled
            # (models/spynet.py:232-238)
            up = 2.0 * resize_bilinear(flow, 2 * flow.shape[2],
                                       2 * flow.shape[3], align_corners=False)
            # replicate-pad one row / column when the finer level is odd
            # (models/spynet.py:240-247): the image's last row, which a
            # spatial mesh's blocks (H a multiple of 64) never need
            if h != up.shape[2] and row_mesh() is not None:
                raise ValueError(f"SpyNet level {level}: {h}-row blocks "
                                 "from odd coarser ones")
            up = F.pad(up, (0, w - up.shape[3], 0, h - up.shape[2]),
                       mode="replicate")
            warped = warp_backward(x2[level], up, mode="spynet",
                                   plain=self.plain_warp)
            flow = self.moduleBasic[level](
                torch.cat([x1[level], warped, up], dim=1)) + up
            flows.append(flow)
        return flows[::-1] if train else flow
