"""FlowNetS, FlowNetC and the flexible larger-field FlowNetC ("Robust
FlowNetC"), NCHW (counterpart of
``understanding_flow_robustness_tpu/models/flownet_family.py``; reference:
models/FlowNetS.py:56-144, models/FlowNetC.py:11-197,
models/FlowNetC_flexible_larger_field.py:90-329).

Images are (B, 3, H, W) RGB in [0, 1], H and W multiples of 64.  FlowNetC
and FlowNetCFlex subtract ``FLOWNETC_RGB_MEAN``, run a siamese encoder to
conv3, correlate the two conv3 maps (``correlate_flownetc``: patch 21,
patch dilation 2, divided by C -- the CUDA kernel
``csrc/spatial_corr_fwd.cu`` on the card, its backward
``csrc/spatial_corr_bwd.cu`` in an attack), and decode with learned
transposed-conv upsampling; the eval output is the x4 bilinear upsample of
flow2 x div_flow.  Modules carry the reference's parameter names
(``conv1.0.weight``, ``deconv5.0.weight``, ``predict_flow6.weight``,
``upsampled_flow6_to_5.weight``; the flexible variant's stages
``convs1.0.0.weight``), so a reference checkpoint loads with
``strict=True``.

Feature taps and injection (models/FlowNetC.py:118-155): with
``return_features`` the forward returns ``(flow, feats)``, ``feats`` the
NCHW taps ``conv1a .. conv3_1`` of ``get_feature_map_keys``; ``overrides``
(a dict of NCHW tensors) replaces conv3a and conv3b (only as a pair), the
raw correlation ``corr``, ``conv_redir`` or ``conv3_1`` where they are made.
``plain_corr`` runs the correlation's plain version also on the card, to
hold the kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.correlation import spatial_correlation
from ..ops.interp import resize_bilinear
from .layers import conv, conv_block, crop_like, deconv, deconv_block

# RGB mean of the FlowNetC family's input normalisation
# (models/FlowNetC.py:73-79)
FLOWNETC_RGB_MEAN = (0.40066648, 0.39482617, 0.3784785)

# the decoder: (level, channels of out_conv{level}, deconv output channels)
_DECODER = ((5, 512, 512), (4, 512, 256), (3, 256, 128), (2, 128, 64))


def flownetc_normalize(im: torch.Tensor) -> torch.Tensor:
    """im - FLOWNETC_RGB_MEAN per channel, NCHW (flownet_family.py:47)."""
    mean = torch.tensor(FLOWNETC_RGB_MEAN, dtype=im.dtype, device=im.device)
    return im - mean.view(1, 3, 1, 1)


def correlate_flownetc(f1: torch.Tensor, f2: torch.Tensor,
                       plain: bool = False) -> torch.Tensor:
    """models/submodules.py:124-138: patch 21, patch dilation 2, divided by
    C; the raw (pre-activation) 441-channel cost volume
    (flownet_family.py:52-56).  ``plain``: the plain version."""
    return spatial_correlation(f1, f2, patch_size=21, dilation_patch=2,
                               plain=plain) / f1.shape[1]


def _maybe(overrides: Optional[dict], key: str,
           value: torch.Tensor) -> torch.Tensor:
    """``overrides[key]`` in value's dtype where given (flownet_family.py:59)."""
    if overrides is not None and key in overrides:
        return overrides[key].to(value.dtype)
    return value


class _FlowNetBase(nn.Module):
    """What the FlowNet family shares: the encoder's tail from conv4 to
    conv6_1 and the decoder from conv6 to flow2 (flownet_family.py:99-137,
    202-236, 352-386), under the reference's names.  Per level the decoder
    has a 3x3 flow head, a learned 2x flow upsampler and a deconv of the
    features, concatenated as (encoder map, deconv, upsampled flow)."""

    def _add_tail(self, batch_norm: bool) -> None:
        cin = 256
        for name, cout, stride in (("conv4", 512, 2), ("conv4_1", 512, 1),
                                   ("conv5", 512, 2), ("conv5_1", 512, 1),
                                   ("conv6", 1024, 2), ("conv6_1", 1024, 1)):
            setattr(self, name, conv_block(cin, cout, 3, stride,
                                           batch_norm=batch_norm))
            cin = cout

    def _add_decoder(self, head_bias: bool, up_bias: bool,
                     deconv_bias: bool) -> None:
        """``head_bias`` / ``up_bias`` / ``deconv_bias``: whether the flow
        heads, the flow upsamplers and the deconvs have a bias (FlowNetS
        none, FlowNetC all, the flexible variant and FlowNet2's S the heads
        only)."""
        cin = 1024
        self.predict_flow6 = conv(cin, 2, 3, bias=head_bias)
        for lvl, enc, dec in _DECODER:
            setattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}",
                    deconv(2, 2, bias=up_bias))
            setattr(self, f"deconv{lvl}", deconv_block(cin, dec, deconv_bias))
            cin = enc + dec + 2
            setattr(self, f"predict_flow{lvl}",
                    conv(cin, 2, 3, bias=head_bias))

    def _tail(self, x: torch.Tensor) -> tuple:
        """conv4, conv5 and conv6 from the conv3-level map."""
        out4 = self.conv4_1(self.conv4(x))
        out5 = self.conv5_1(self.conv5(out4))
        return out4, out5, self.conv6_1(self.conv6(out5))

    def _decode(self, out_conv6: torch.Tensor, skips: dict,
                crop: bool = False) -> list:
        """The flows of levels 2..6, finest first, from conv6 and the
        encoder maps ``skips[level]``; ``crop``: FlowNetS's crop_like of
        the upsampled maps to the encoder's."""
        x = out_conv6
        flow = self.predict_flow6(x)
        flows = [flow]
        for lvl, _, _ in _DECODER:
            skip = skips[lvl]
            up = getattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}")(flow)
            dec = getattr(self, f"deconv{lvl}")(x)
            if crop:
                up, dec = crop_like(up, skip), crop_like(dec, skip)
            x = torch.cat([skip, dec, up], dim=1)
            flow = self._head(lvl, x)
            flows.append(flow)
        return flows[::-1]

    def _head(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        """The flow of decoder level ``lvl`` from its concatenation x."""
        return getattr(self, f"predict_flow{lvl}")(x)


def _up4(flow: torch.Tensor, scale: float) -> torch.Tensor:
    """x4 bilinear upsample of flow * scale (align_corners=False)."""
    return resize_bilinear(flow * scale, 4 * flow.shape[2],
                           4 * flow.shape[3], align_corners=False)


class FlowNetS(_FlowNetBase):
    """models/FlowNetS.py:56-144 (flownet_family.py:65-144): the two images
    concatenated into 6 channels, no normalisation, bias-free flow heads,
    upsamplers and deconvs, crop_like in the decoder.  Eval output: 5 x
    flow2 at H/4 x W/4; ``train=True``: 5 x the flows of levels 2..6."""

    def __init__(self, batch_norm: bool = False,
                 return_features: bool = False):
        super().__init__()
        self.return_features = return_features
        for name, cin, cout, k, stride in (
                ("conv1", 6, 64, 7, 2), ("conv2", 64, 128, 5, 2),
                ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1)):
            setattr(self, name, conv_block(cin, cout, k, stride,
                                           batch_norm=batch_norm))
        self._add_tail(batch_norm)
        self._add_decoder(False, False, False)

    def forward(self, im1, im2, train: bool = False):
        out_conv2 = self.conv2(self.conv1(torch.cat([im1, im2], dim=1)))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4, out_conv5, out_conv6 = self._tail(out_conv3)
        flows = self._decode(out_conv6, {5: out_conv5, 4: out_conv4,
                                         3: out_conv3, 2: out_conv2},
                             crop=True)
        if train:
            return tuple(5 * f for f in flows)
        return (5 * flows[0], {}) if self.return_features else 5 * flows[0]


class _FlowNetCBase(_FlowNetBase):
    """The FlowNetC family's forward (flownet_family.py:160-254, 296-399):
    a siamese encoder (``_encode``, the subclass's) to conv3, the
    correlation, conv_redir and conv3_1, the shared tail and decoder."""

    # train=True returns the flows upsampled x4 (FlowNetCFlex: raw)
    _train_upsampled = True

    def __init__(self, div_flow: float, return_features: bool,
                 plain_corr: bool):
        super().__init__()
        self.div_flow = div_flow
        self.return_features = return_features
        self.plain_corr = plain_corr

    def _add_head(self, batch_norm: bool) -> None:
        """conv_redir, conv3_1 on (redir, 441-channel correlation), tail."""
        self.conv_redir = conv_block(256, 32, 1, batch_norm=batch_norm)
        self.conv3_1 = conv_block(32 + 21 * 21, 256, 3,
                                  batch_norm=batch_norm)
        self._add_tail(batch_norm)

    def forward(self, im1, im2, train: bool = False,
                overrides: Optional[dict] = None):
        out_conv1a, out_conv2a, out_conv3a = self._encode(
            flownetc_normalize(im1))
        out_conv1b, out_conv2b, out_conv3b = self._encode(
            flownetc_normalize(im2))
        # conv3a/conv3b are replaced only when BOTH keys are present
        # (FlowNetC.py:121-130 requires the pair; a singleton is a no-op)
        if overrides is not None and "conv3a" in overrides \
                and "conv3b" in overrides:
            out_conv3a = overrides["conv3a"].to(out_conv3a.dtype)
            out_conv3b = overrides["conv3b"].to(out_conv3b.dtype)

        out_corr = correlate_flownetc(out_conv3a, out_conv3b, self.plain_corr)
        feats = {"conv1a": out_conv1a, "conv2a": out_conv2a,
                 "conv3a": out_conv3a, "conv1b": out_conv1b,
                 "conv2b": out_conv2b, "conv3b": out_conv3b,
                 "corr": out_corr}
        out_corr = nn.functional.leaky_relu(
            _maybe(overrides, "corr", out_corr), 0.1)
        out_conv_redir = self.conv_redir(out_conv3a)
        feats["conv_redir"] = out_conv_redir
        out_conv_redir = _maybe(overrides, "conv_redir", out_conv_redir)
        out_conv3_1 = self.conv3_1(torch.cat([out_conv_redir, out_corr], 1))
        feats["conv3_1"] = out_conv3_1
        out_conv3_1 = _maybe(overrides, "conv3_1", out_conv3_1)

        out_conv4, out_conv5, out_conv6 = self._tail(out_conv3_1)
        flows = self._decode(out_conv6, {5: out_conv5, 4: out_conv4,
                                         3: out_conv3_1, 2: out_conv2a})
        if train:
            return tuple(_up4(f, self.div_flow) if self._train_upsampled
                         else f for f in flows)
        flow = _up4(flows[0], self.div_flow)
        return (flow, feats) if self.return_features else flow


class FlowNetC(_FlowNetCBase):
    """models/FlowNetC.py:11-197 (flownet_family.py:147-254).  Eval output:
    the x4 bilinear upsample of flow2 x div_flow at full resolution;
    ``train=True``: those of the flows of levels 2..6."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 return_features: bool = False, plain_corr: bool = False):
        super().__init__(div_flow, return_features, plain_corr)
        for name, cin, cout, k in (("conv1", 3, 64, 7), ("conv2", 64, 128, 5),
                                   ("conv3", 128, 256, 5)):
            setattr(self, name, conv_block(cin, cout, k, 2,
                                           batch_norm=batch_norm))
        self._add_head(batch_norm)
        self._add_decoder(True, True, True)

    def _encode(self, x: torch.Tensor) -> tuple:
        """The siamese encoder's conv1, conv2 and conv3 maps."""
        c1 = self.conv1(x)
        c2 = self.conv2(c1)
        return c1, c2, self.conv3(c2)


class FlowNetCFlex(_FlowNetCBase):
    """models/FlowNetC_flexible_larger_field.py:90-329, "Robust FlowNetC"
    (flownet_family.py:257-399): each encoder stage is an entry conv (7x7
    / kernel_size, stride 2, ``dilation``) and ``number_of_reps``
    kernel_size convs; bias-free upsamplers and deconvs; div_flow 1;
    ``train=True`` returns the raw flows of levels 2..6.

    ``stage_names`` picks the checkpoint's names of the stage convs:
    "convs" (``convs1.0``, ``convs1.1``, ...; FlowNetC_flexible_larger_field),
    "flat" (the JAX package's ``flat_entry_names=True``: entries ``conv1``,
    repetitions ``convs1.1``, ...; FlowNetC_predict_bias, k5_reps0) or
    "larger_field" (``conv1``, ``conv11``, ...; FlowNetC_larger_field,
    models/FlowNetC_larger_field.py:87-227, which the JAX package renames
    into the flexible layout, convert.py:201-218)."""

    _train_upsampled = False

    def __init__(self, kernel_size: int = 3, number_of_reps: int = 3,
                 dilation: int = 1, div_flow: float = 1.0,
                 batch_norm: bool = False, stage_names: str = "convs",
                 return_features: bool = False, plain_corr: bool = False):
        super().__init__(div_flow, return_features, plain_corr)
        if stage_names not in ("convs", "flat", "larger_field"):
            raise ValueError(f"unknown stage_names {stage_names!r}")
        self.stage_names = stage_names
        self._stage_paths = []
        cin = 3
        for idx, (cout, entry_k) in enumerate(
                ((64, 7), (128, kernel_size), (256, kernel_size)), start=1):
            blocks = [conv_block(cin, cout, entry_k, 2, dilation,
                                 batch_norm=batch_norm)]
            blocks += [conv_block(cout, cout, kernel_size,
                                  batch_norm=batch_norm)
                       for _ in range(number_of_reps)]
            cin = cout
            if stage_names == "convs":
                setattr(self, f"convs{idx}", nn.Sequential(*blocks))
                self._stage_paths.append((f"convs{idx}",))
                continue
            setattr(self, f"conv{idx}", blocks[0])
            paths = [f"conv{idx}"]
            if stage_names == "flat" and number_of_reps:
                setattr(self, f"convs{idx}", nn.ModuleDict(
                    {str(r): b for r, b in enumerate(blocks[1:], start=1)}))
                paths += [f"convs{idx}.{r}"
                          for r in range(1, number_of_reps + 1)]
            elif stage_names == "larger_field":
                for r, b in enumerate(blocks[1:], start=1):
                    setattr(self, f"conv{idx}{r}", b)
                    paths.append(f"conv{idx}{r}")
            self._stage_paths.append(tuple(paths))
        self._add_head(batch_norm)
        self._add_decoder(True, False, False)

    def _encode(self, x: torch.Tensor) -> tuple:
        outs = []
        for paths in self._stage_paths:
            for path in paths:
                x = self.get_submodule(path)(x)
            outs.append(x)
        return tuple(outs)
