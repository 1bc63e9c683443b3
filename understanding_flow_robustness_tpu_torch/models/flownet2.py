"""FlowNet2's S sub-network and the registry's standalone "FlowNetS", NCHW
(counterpart of ``understanding_flow_robustness_tpu/models/flownet2.py``;
reference: models/flownet2/FlowNetS.py:14-93, models/FlowNet2S.py).
The FlowNet2 cascade itself is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import torch

from .flownet_family import _FlowNetBase, _up4
from .layers import conv_block

# FlowNet2S's RGB mean (models/FlowNet2S.py:63-69)
FLOWNET2S_RGB_MEAN = (0.4114511, 0.43205959, 0.45015125)


class FlowNet2SSub(_FlowNetBase):
    """models/flownet2/FlowNetS.py:14-93 (flownet2.py:110-166): FlowNetS on
    an already-concatenated ``in_ch``-channel input (12 in the cascade),
    flow heads and deconvs with a bias, bias-free flow upsamplers, no
    crop.  Returns the flows of levels 2..6 (``train=True``) or
    ``(flow2,)``."""

    def __init__(self, in_ch: int = 12, batch_norm: bool = False):
        super().__init__()
        for name, cin, cout, k, stride in (
                ("conv1", in_ch, 64, 7, 2), ("conv2", 64, 128, 5, 2),
                ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1)):
            setattr(self, name, conv_block(cin, cout, k, stride,
                                           batch_norm=batch_norm))
        self._add_tail(batch_norm)
        self._add_decoder(True, False, True)

    def forward(self, x: torch.Tensor, train: bool = False) -> tuple:
        out_conv2 = self.conv2(self.conv1(x))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4, out_conv5, out_conv6 = self._tail(out_conv3)
        flows = self._decode(out_conv6, {5: out_conv5, 4: out_conv4,
                                         3: out_conv3, 2: out_conv2})
        return tuple(flows) if train else (flows[0],)


class FlowNetS2(FlowNet2SSub):
    """The registry's "FlowNetS" (flownet2.py:347-383): models/__init__.py:3
    aliases FlowNetS to FlowNet2S, a 6-channel FlowNet2SSub after
    FLOWNET2S_RGB_MEAN subtraction.  Eval output: the x4 bilinear upsample
    of 20 x flow2; ``train=True``: the raw flows of levels 2..6.  Its
    layers sit at the top level, as in FlowNet2-S_checkpoint.pth.tar (the
    JAX package nests them under ``net``)."""

    def __init__(self, batch_norm: bool = False,
                 return_features: bool = False):
        super().__init__(6, batch_norm)
        self.return_features = return_features

    def forward(self, im1, im2, train: bool = False):
        mean = torch.tensor(FLOWNET2S_RGB_MEAN, dtype=im1.dtype,
                            device=im1.device).view(1, 3, 1, 1)
        flows = super().forward(torch.cat([im1 - mean, im2 - mean], dim=1),
                                train)
        if train:
            return flows
        out = _up4(flows[0], 20.0)
        return (out, {}) if self.return_features else out
