"""PWC-Net (PWC-DC, md=4), inference (counterpart of
``understanding_flow_robustness_tpu/models/pwcnet.py``; reference:
models/PWCNet.py:53-402).

6-level siamese feature pyramid; per level from 5 to 2: warp the second
image's features by the upsampled flow (``ops.warp_backward``, mode
"zeros_mask": the CUDA kernel ``csrc/warp_fwd.cu`` on the card), an
81-channel correlation (patch 9, divided by C; the CUDA kernel
``csrc/spatial_corr_fwd.cu`` on the card, its backward
``csrc/spatial_corr_bwd.cu`` in an attack), a DenseNet decoder and
learned-deconv upsampling of flow and features; a dilated context network
on level 2.  Images are RGB in [0, 1], flipped to BGR at entry; the eval
output is 20 x the x4 bilinear upsample of the level-2 flow.

NCHW modules with the reference's parameter names: the conv blocks are
``nn.Sequential(conv, LeakyReLU)`` (``conv1a.0.weight``), ``predict_flow*``
and ``dc_conv7`` plain convs, ``deconv*`` and ``upfeat*`` transposed convs;
the reference's ``deconv2`` is kept although ``forward`` never uses it, so
a reference checkpoint loads with ``strict=True``.

Mixed precision (the JAX package's ``mixed_precision=True``): bf16 autocast
around the network, with the flow heads -- ``predict_flow*``, the flow
deconvs ``deconv6..3`` and ``dc_conv7`` -- run outside autocast on f32
inputs, so flows stay f32 (pwcnet.py:58-62).  The JAX package's
``split_decoder`` is a TPU scheduling knob and is not ported.

Feature taps (pwcnet.py:38, 190): with ``return_features`` the eval
forward returns ``(flow, feats)``, ``feats`` the NCHW taps of
``get_feature_map_keys("PWCNet")`` in its order: the two pyramids, per
level the raw correlation, the decoder's convs, the flow head and the
upsamplers, then the context network.  As in the reference, the tap
``corr2`` holds corr5 again (PWCNet.py:336).  The taps are capture-only:
PWC-Net takes no ``overrides``.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops.correlation import spatial_correlation
from ..ops.interp import resize_bilinear
from ..ops.warp import warp_backward
from .layers import conv, conv_block, deconv

_DD = (128, 256, 352, 416, 448)  # cumsum([128, 128, 96, 64, 32])
_DECODER = (128, 128, 96, 64, 32)
_WARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
# the pyramid: (level, channels, names of its stride-2 and two stride-1 convs)
_PYRAMID = ((1, 16, ("conv1a", "conv1aa", "conv1b")),
            (2, 32, ("conv2a", "conv2aa", "conv2b")),
            (3, 64, ("conv3a", "conv3aa", "conv3b")),
            (4, 96, ("conv4a", "conv4aa", "conv4b")),
            (5, 128, ("conv5a", "conv5aa", "conv5b")),
            (6, 196, ("conv6aa", "conv6a", "conv6b")))
# the context network: (channels, dilation) of dc_conv1..6
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


def _tap_keys() -> list:
    """The taps in the reference's capture order (utils_model.py:345-409;
    the JAX registry's get_feature_map_keys, registry.py:332-347)."""
    keys = []
    for i in range(6):
        keys += [f"c1{i + 1}", f"c2{i + 1}"]
    for lvl in (6, 5, 4, 3):
        keys += [f"corr{lvl}"] + [f"conv{lvl}_{i}" for i in range(5)]
        keys += [f"predict_flow{lvl}", f"deconv{lvl}", f"upfeat{lvl}"]
    keys += ["corr2"] + [f"conv2_{i}" for i in range(5)]
    return keys + [f"dc_conv{i}" for i in range(1, 8)] + ["predict_flow2"]


TAP_KEYS = tuple(_tap_keys())


def correlate_pwc(f1: torch.Tensor, f2: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
    """models/PWCNet.py:42-50: patch 9, divided by C, no activation; the
    kernel ``csrc/spatial_corr_fwd.cu`` on the card, or with ``plain`` its
    plain version."""
    return spatial_correlation(f1, f2, patch_size=9, plain=plain) \
        / f1.shape[1]


class PWCNet(nn.Module):
    """PWCDCNet(md=4).  Images (B, 3, H, W) RGB in [0, 1], H and W
    multiples of 64 -> flow (B, 2, H, W); ``train=True`` returns the x4
    upsampled flows of levels 2..6 (without the x20); with
    ``return_features`` the eval output is ``(flow, feats)``.  ``plain_warp`` runs
    the warps' plain version also on the card, and ``plain_corr`` the
    correlations', to hold the kernels against them."""

    def __init__(self, md: int = 4, mixed_precision: bool = False,
                 return_features: bool = False, plain_warp: bool = False,
                 plain_corr: bool = False):
        super().__init__()
        self.mixed_precision = mixed_precision
        self.return_features = return_features
        self.plain_warp = plain_warp
        self.plain_corr = plain_corr
        nd = (2 * md + 1) ** 2
        cin = 3
        for _, ch, names in _PYRAMID:
            for i, name in enumerate(names):
                setattr(self, name, conv_block(cin, ch, 3, 2 if i == 0 else 1))
                cin = ch
        for lvl, od in ((6, nd), (5, nd + 128 + 4), (4, nd + 96 + 4),
                        (3, nd + 64 + 4), (2, nd + 32 + 4)):
            for i, ch in enumerate(_DECODER):
                setattr(self, f"conv{lvl}_{i}",
                        conv_block(od + (_DD[i - 1] if i else 0), ch, 3))
            setattr(self, f"predict_flow{lvl}", conv(od + _DD[4], 2, 3))
            # deconv2 is dead in the reference (PWCNet.py:143): kept for
            # strict loading, never called
            setattr(self, f"deconv{lvl}", deconv(2, 2))
            if lvl > 2:
                setattr(self, f"upfeat{lvl}", deconv(od + _DD[4], 2))
        cin = nd + 32 + 4 + _DD[4]
        for i, (ch, dil) in enumerate(_CONTEXT):
            setattr(self, f"dc_conv{i + 1}", conv_block(cin, ch, 3,
                                                        dilation=dil))
            cin = ch
        self.dc_conv7 = conv(32, 2, 3)

    def _head(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A flow head: f32 inputs outside autocast under mixed precision."""
        if not self.mixed_precision:
            return layer(x)
        with torch.autocast(x.device.type, enabled=False):
            return layer(x.float())

    def _pyramid(self, x):
        feats = []
        for _, _, names in _PYRAMID:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats  # levels 1..6 (stride 2..64)

    def _decoder(self, x, lvl, tap):
        """DenseNet chain: each conv's output goes in front of its input,
        torch.cat((y, x), 1) (pwcnet.py:116-124)."""
        for i in range(len(_DECODER)):
            y = getattr(self, f"conv{lvl}_{i}")(x)
            tap(f"conv{lvl}_{i}", y)
            x = torch.cat([y, x], dim=1)
        flow = self._head(getattr(self, f"predict_flow{lvl}"), x)
        tap(f"predict_flow{lvl}", flow)
        return x, flow

    def forward(self, im1, im2, train: bool = False):
        ctx = (torch.autocast(im1.device.type, dtype=torch.bfloat16)
               if self.mixed_precision else contextlib.nullcontext())
        # the taps are kept only when asked for: each holds a map alive
        feats = {}
        tap = (feats.__setitem__ if self.return_features and not train
               else lambda name, value: None)
        with ctx:
            flows = self._forward(im1, im2, tap)
        if train:
            return tuple(self._up4(flows[lvl]) for lvl in (2, 3, 4, 5, 6))
        flow = 20.0 * self._up4(flows[2])
        if self.return_features:
            return flow, {k: feats[k] for k in TAP_KEYS}
        return flow

    @staticmethod
    def _up4(f):
        return resize_bilinear(f, 4 * f.shape[2], 4 * f.shape[3],
                               align_corners=False)

    def _forward(self, im1, im2, tap):
        """The flows of levels 2..6 by level; ``tap(name, map)`` sees every
        tap."""
        # RGB -> BGR (models/PWCNet.py:230-231); weights shared by both
        c1 = self._pyramid(im1.flip(1))
        c2 = self._pyramid(im2.flip(1))
        for i in range(6):
            tap(f"c1{i + 1}", c1[i])
            tap(f"c2{i + 1}", c2[i])
        flows = {}
        corr = correlate_pwc(c1[5], c2[5], self.plain_corr)
        tap("corr6", corr)
        x, flows[6] = self._decoder(nn.functional.leaky_relu(corr, 0.1), 6,
                                    tap)
        up_flow = self._head(self.deconv6, flows[6])
        up_feat = self.upfeat6(x)
        tap("deconv6", up_flow)
        tap("upfeat6", up_feat)
        for lvl in (5, 4, 3, 2):
            i = lvl - 1
            warped = warp_backward(c2[i], up_flow * _WARP_SCALE[lvl],
                                   mode="zeros_mask", plain=self.plain_warp)
            corr = correlate_pwc(c1[i], warped, self.plain_corr)
            if lvl == 5:
                corr5 = corr
            # the reference's capture at the corr2 site appends corr5 again
            # (PWCNet.py:336)
            tap(f"corr{lvl}", corr5 if lvl == 2 else corr)
            x, flows[lvl] = self._decoder(torch.cat(
                [nn.functional.leaky_relu(corr, 0.1), c1[i], up_flow,
                 up_feat], dim=1), lvl, tap)
            if lvl > 2:
                up_flow = self._head(getattr(self, f"deconv{lvl}"), flows[lvl])
                up_feat = getattr(self, f"upfeat{lvl}")(x)
                tap(f"deconv{lvl}", up_flow)
                tap(f"upfeat{lvl}", up_feat)
        # context network (models/PWCNet.py:145-154)
        for i in range(len(_CONTEXT)):
            x = getattr(self, f"dc_conv{i + 1}")(x)
            tap(f"dc_conv{i + 1}", x)
        residual = self._head(self.dc_conv7, x)
        tap("dc_conv7", residual)
        flows[2] = flows[2] + residual
        return flows
