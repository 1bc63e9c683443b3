"""FlowNet2, its sub-networks, its partial stacks and the registry's
standalone "FlowNetS", NCHW (counterpart of
``understanding_flow_robustness_tpu/models/flownet2.py``; reference:
models/flownet2_models.py:14-600, models/flownet2/FlowNetC.py,
FlowNetS.py, FlowNetSD.py, FlowNetFusion.py, models/FlowNet2S.py).

The sub-networks take an already-concatenated input, as the reference
passes ``cat(x1, x2)``, and return the flows of their levels (finest
first) with ``train=True`` or the finest alone.  The cascade's Resample2d
and ChannelNorm CUDA ops are ``ops.warp_backward(mode="border")`` (the
CUDA kernel ``csrc/warp_fwd.cu`` on the card) and ``ops.channel_norm``;
FlowNetC's correlation is ``correlate_flownetc`` (``csrc/spatial_corr_fwd.cu``
and, in an attack, ``csrc/spatial_corr_bwd.cu``).  Modules carry the
reference's parameter names (``flownetc.conv1.0.weight``,
``flownets_d.inter_conv5.0.weight``, ``flownetfusion.predict_flow0.weight``),
so a reference checkpoint loads with ``strict=True``.  ``plain_warp`` and
``plain_corr`` run the warps' and the correlation's plain versions also on
the card, to hold the kernels against them.  All of it runs in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.correlation import channel_norm
from ..ops.interp import (
    resize_bilinear,
    upsample_nearest,
    warp_backward_reference,
)
from ..ops.warp import warp_backward
from .flownet_family import (
    _DECODER,
    FlowNetC,
    _FlowNetBase,
    _up4,
    correlate_flownetc,
    flownetc_normalize,
)
from .layers import conv, conv_block, deconv, deconv_block

# FlowNet2S's RGB mean (models/FlowNet2S.py:63-69)
FLOWNET2S_RGB_MEAN = (0.4114511, 0.43205959, 0.45015125)


def _iconv(in_ch: int, out_ch: int, batch_norm: bool) -> nn.Sequential:
    """The reference's ``i_conv`` (models/submodules.py:46-68; JAX
    ``ConvBlock(act=None)``): a 3x3 conv (+ BatchNorm2d, and then no conv
    bias) without an activation, named ``<name>.0`` and ``<name>.1``."""
    layers = [conv(in_ch, out_ch, 3, bias=not batch_norm)]
    if batch_norm:
        layers.append(nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1))
    return nn.Sequential(*layers)


class FlowNet2CSub(FlowNetC):
    """models/flownet2/FlowNetC.py:10-131 (flownet2.py:38-107): FlowNetC's
    layers on a 6-channel input (the two frames, normalised by the
    caller), without its own normalisation, taps or overrides."""

    def __init__(self, batch_norm: bool = False, plain_corr: bool = False):
        super().__init__(batch_norm, plain_corr=plain_corr)

    def forward(self, x: torch.Tensor, train: bool = False) -> tuple:
        out_conv1a, out_conv2a, out_conv3a = self._encode(x[:, :3])
        out_conv3b = self._encode(x[:, 3:])[2]
        out_corr = nn.functional.leaky_relu(correlate_flownetc(
            out_conv3a, out_conv3b, self.plain_corr), 0.1)
        out_conv3_1 = self.conv3_1(torch.cat([self.conv_redir(out_conv3a),
                                              out_corr], 1))
        out_conv4, out_conv5, out_conv6 = self._tail(out_conv3_1)
        flows = self._decode(out_conv6, {5: out_conv5, 4: out_conv4,
                                         3: out_conv3_1, 2: out_conv2a})
        return tuple(flows) if train else (flows[0],)


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


class FlowNetSD(_FlowNetBase):
    """models/flownet2/FlowNetSD.py:11-103 (flownet2.py:169-260): the
    small-displacement net, stride-1 conv0 then 3x3 stages, every decoder
    layer with a bias, and an ``inter_conv`` (conv without activation)
    before each flow head but the coarsest.  The JAX package's
    space-to-depth head is a TPU layout and is not ported."""

    def __init__(self, in_ch: int = 6, batch_norm: bool = False):
        super().__init__()
        for name, cin, cout, stride in (
                ("conv0", in_ch, 64, 1), ("conv1", 64, 64, 2),
                ("conv1_1", 64, 128, 1), ("conv2", 128, 128, 2),
                ("conv2_1", 128, 128, 1), ("conv3", 128, 256, 2),
                ("conv3_1", 256, 256, 1)):
            setattr(self, name, conv_block(cin, cout, 3, stride,
                                           batch_norm=batch_norm))
        self._add_tail(batch_norm)
        self._add_decoder(True, True, True)
        for lvl, enc, dec in _DECODER:
            setattr(self, f"inter_conv{lvl}",
                    _iconv(enc + dec + 2, dec, batch_norm))
            setattr(self, f"predict_flow{lvl}", conv(dec, 2, 3))

    def _head(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        return super()._head(lvl, getattr(self, f"inter_conv{lvl}")(x))

    def forward(self, x: torch.Tensor, train: bool = False) -> tuple:
        out_conv1 = self.conv1_1(self.conv1(self.conv0(x)))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4, out_conv5, out_conv6 = self._tail(out_conv3)
        flows = self._decode(out_conv6, {5: out_conv5, 4: out_conv4,
                                         3: out_conv3, 2: out_conv2})
        return tuple(flows) if train else (flows[0],)


class FlowNetFusion(nn.Module):
    """models/flownet2/FlowNetFusion.py:10-65 (flownet2.py:263-344): the
    11-channel fusion net, three stages down to 1/4 and a decoder back to
    full resolution with ``inter_conv`` heads; returns the full-resolution
    flow0.  The JAX package's space-to-depth island is a TPU layout and is
    not ported."""

    def __init__(self, in_ch: int = 11, batch_norm: bool = False):
        super().__init__()
        for name, cin, cout, stride in (
                ("conv0", in_ch, 64, 1), ("conv1", 64, 64, 2),
                ("conv1_1", 64, 128, 1), ("conv2", 128, 128, 2),
                ("conv2_1", 128, 128, 1)):
            setattr(self, name, conv_block(cin, cout, 3, stride,
                                           batch_norm=batch_norm))
        self.predict_flow2 = conv(128, 2, 3)
        # (level, deconv input channels, encoder channels, deconv channels)
        for lvl, cin, enc, dec in ((1, 128, 128, 32), (0, 162, 64, 16)):
            setattr(self, f"deconv{lvl}", deconv_block(cin, dec))
            setattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}", deconv(2, 2))
            setattr(self, f"inter_conv{lvl}",
                    _iconv(enc + dec + 2, dec, batch_norm))
            setattr(self, f"predict_flow{lvl}", conv(dec, 2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        flow = self.predict_flow2(out_conv2)
        x = out_conv2
        for lvl, skip in ((1, out_conv1), (0, out_conv0)):
            x = torch.cat([skip, getattr(self, f"deconv{lvl}")(x),
                           getattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}")(
                               flow)], 1)
            flow = getattr(self, f"predict_flow{lvl}")(
                getattr(self, f"inter_conv{lvl}")(x))
        return flow


class _CascadeBase(nn.Module):
    """What the cascades share: FlowNetC first, the plain-version switches,
    the warp and the stage input of a FlowNet S stage."""

    def __init__(self, div_flow: float, return_features: bool,
                 plain_warp: bool, plain_corr: bool, batch_norm: bool):
        super().__init__()
        self.div_flow = div_flow
        self.return_features = return_features
        self.plain_warp = plain_warp
        self.flownetc = FlowNet2CSub(batch_norm, plain_corr)

    @property
    def plain_corr(self) -> bool:
        return self.flownetc.plain_corr

    @plain_corr.setter
    def plain_corr(self, value: bool) -> None:
        self.flownetc.plain_corr = value

    def _warp(self, img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        warp = warp_backward_reference if self.plain_warp else warp_backward
        return warp(img, flow, "border")

    def _stage_input(self, x, img0, img1, flow) -> tuple:
        """A FlowNet S stage's 12 channels: both frames, the second warped
        by ``flow``, ``flow / div_flow`` and the channel norm of the
        brightness error (flownet2_models.py:135-141)."""
        resampled = self._warp(img1, flow)
        return torch.cat([x, resampled, flow / self.div_flow,
                          channel_norm(img0 - resampled)], 1)

    def _out(self, flow: torch.Tensor):
        return (flow, {}) if self.return_features else flow


def _rgb_mean_normalize(im1: torch.Tensor, im2: torch.Tensor) -> tuple:
    """The partial stacks' normalisation (flownet2_models.py:459-475): each
    image pair less its per-channel mean over both frames."""
    mean = torch.stack([im1, im2], 1).mean(dim=(1, 3, 4), keepdim=True)[:, 0]
    return im1 - mean, im2 - mean


class FlowNet2(_CascadeBase):
    """models/flownet2_models.py:14-205 (flownet2.py:462-540): the 5-net
    cascade.  Two (B, 3, H, W) RGB images in [0, 1], H and W multiples of
    64, FLOWNETC_RGB_MEAN subtracted; FlowNetC -> FlowNetS1 -> FlowNetS2
    (each S stage on the second frame warped by the previous flow) and the
    FlowNetSD branch, fused by FlowNetFusion into the full-resolution flow
    (B, 2, H, W).  Four border-mode warps and one correlation per forward.
    ``return_features=True`` gives ``(flow, {})``: FlowNet2 has no taps.
    ``train`` changes nothing: the cascade trains on its one fused flow,
    as the JAX package's does (flownet2.py:475)."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 return_features: bool = False, plain_warp: bool = False,
                 plain_corr: bool = False):
        super().__init__(div_flow, return_features, plain_warp, plain_corr,
                         batch_norm)
        self.flownets_1 = FlowNet2SSub(12, batch_norm)
        self.flownets_2 = FlowNet2SSub(12, batch_norm)
        self.flownets_d = FlowNetSD(6, batch_norm)
        self.flownetfusion = FlowNetFusion(11, batch_norm)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor,
                train: bool = False):
        img0, img1 = flownetc_normalize(im1), flownetc_normalize(im2)
        x = torch.cat([img0, img1], 1)
        H, W = x.shape[2:]
        div = self.div_flow
        flow = self.flownetc(x)[0]
        flow = resize_bilinear(flow * div, H, W)
        flow = self.flownets_1(self._stage_input(x, img0, img1, flow))[0]
        flow = resize_bilinear(flow * div, H, W)
        flow2 = self.flownets_2(self._stage_input(x, img0, img1, flow))[0]
        flownets2_flow = upsample_nearest(flow2 * div, 4)
        # / div_flow, as the JAX package and the reference have it
        # (flownet2_models.py:180)
        flowsd = upsample_nearest(self.flownets_d(x)[0] / div, 4)
        fused = torch.cat([
            img0, flowsd, flownets2_flow, channel_norm(flowsd),
            channel_norm(flownets2_flow),
            channel_norm(img0 - self._warp(img1, flowsd)),
            channel_norm(img0 - self._warp(img1, flownets2_flow))], 1)
        return self._out(self.flownetfusion(fused))


class FlowNet2CS(_CascadeBase):
    """models/flownet2_models.py:419-600 (flownet2.py:417-459): FlowNetC
    and ``stages`` FlowNet S stages (1: FlowNet2CS, 2: FlowNet2CSS), on
    ``_rgb_mean_normalize``d images; the flow of the last stage, x4
    bilinear, times div_flow."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 stages: int = 1, return_features: bool = False,
                 plain_warp: bool = False, plain_corr: bool = False):
        super().__init__(div_flow, return_features, plain_warp, plain_corr,
                         batch_norm)
        self.stages = stages
        for i in range(stages):
            setattr(self, f"flownets_{i + 1}", FlowNet2SSub(12, batch_norm))

    def forward(self, im1: torch.Tensor, im2: torch.Tensor):
        img0, img1 = _rgb_mean_normalize(im1, im2)
        x = torch.cat([img0, img1], 1)
        H, W = x.shape[2:]
        flow = resize_bilinear(self.flownetc(x)[0] * self.div_flow, H, W)
        for i in range(self.stages):
            flow = getattr(self, f"flownets_{i + 1}")(
                self._stage_input(x, img0, img1, flow))[0]
            flow = resize_bilinear(flow * self.div_flow, H, W)
        return self._out(flow)


class FlowNet2Single(nn.Module):
    """models/flownet2_models.py:208-417 (flownet2.py:378-414): FlowNet2C,
    FlowNet2S or FlowNet2SD (``subnet`` "C", "S" or "SD") alone on
    ``_rgb_mean_normalize``d images; the x4 bilinear upsample of flow2
    times div_flow, or with ``train=True`` the raw flows of levels 2..6."""

    def __init__(self, subnet: str = "C", batch_norm: bool = False,
                 div_flow: float = 20.0, return_features: bool = False):
        super().__init__()
        self.div_flow = div_flow
        self.return_features = return_features
        if subnet == "C":
            self.flownetc = FlowNet2CSub(batch_norm)
        elif subnet == "S":
            self.flownets = FlowNet2SSub(6, batch_norm)
        elif subnet == "SD":
            self.flownets_d = FlowNetSD(6, batch_norm)
        else:
            raise ValueError(f"unknown subnet {subnet!r}")
        self.subnet = subnet

    def forward(self, im1: torch.Tensor, im2: torch.Tensor,
                train: bool = False):
        x = torch.cat(_rgb_mean_normalize(im1, im2), 1)
        net = {"C": "flownetc", "S": "flownets", "SD": "flownets_d"}
        flows = getattr(self, net[self.subnet])(x, train)
        if train:
            return flows
        out = _up4(flows[0], self.div_flow)
        return (out, {}) if self.return_features else out


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
