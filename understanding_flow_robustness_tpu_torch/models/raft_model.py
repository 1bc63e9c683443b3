"""RAFT: the standard configuration, inference and training, and the
FlowNetC-encoder variants, inference (counterpart of
``understanding_flow_robustness_tpu/models/raft_model.py``).

Modules are NCHW and carry the original PyTorch repository's parameter
names (models/raft/extractor.py, update.py, raft.py), so a port
``state_dict`` is a reference state dict and a reference checkpoint loads
strictly (``convert.load_reference_state_dict``).

Mixed precision (the JAX package's ``compute_dtype=bf16``) is
``torch.autocast(bf16)`` around the encoders and the update block: convs
run in bf16, norm statistics and flow/coordinate math stay f32, the fmaps
are cast to f32 before the correlation, and the lookup takes bf16 features
with f32 accumulation.  In training the lookup's gradient reaches the f32
fmaps in f32; the backward runs outside autocast.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.correlation import (
    alt_corr_kernel_inputs,
    alt_corr_lookup,
    alt_corr_lookup_reference,
    corr_lookup,
    corr_lookup_reference,
    prepare_alt_corr,
    volume_pyramid,
)
from ..ops.interp import coords_grid
from .layers import conv, leaky_relu, norm


class ResidualBlock(nn.Module):
    """models/raft/extractor.py:5-78.  As in the reference, ``norm3`` is
    registered both on its own and as ``downsample.1``, so a checkpoint
    carries ``norm3.*`` and ``downsample.1.*``."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3)
        self.relu = nn.ReLU(inplace=True)
        self.norm1 = norm(norm_fn, planes)
        self.norm2 = norm(norm_fn, planes)
        if stride == 1:
            self.downsample = None
        else:
            self.norm3 = norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    """models/raft/extractor.py:142-215: conv7x7/2, three residual stages
    (64, 96/2, 128/2), 1x1 output conv.  Output stride 8."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.norm1 = norm(norm_fn, 64)
        self.relu1 = nn.ReLU(inplace=True)
        stages, in_planes = [], 64
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            stages.append(nn.Sequential(
                ResidualBlock(in_planes, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = stages
        self.conv2 = conv(128, output_dim, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class FlowNetCEncoder(nn.Module):
    """models/raft/extractor.py:292-391 with norm_fn='none', its setting in
    every factory use: conv7/2, conv5/2, conv5/2 with biases, each followed
    by LeakyReLU(0.1).  ``conv{i}`` is the reference's Sequential(conv,
    LeakyReLU), so its weights are ``conv{i}.0.*``.  Output stride 8."""

    def __init__(self, output_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Sequential(conv(3, 64, 7, 2), leaky_relu())
        self.conv2 = nn.Sequential(conv(64, 128, 5, 2), leaky_relu())
        self.conv3 = nn.Sequential(conv(128, output_dim, 5, 2), leaky_relu())

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class FlowHead(nn.Module):
    """models/raft/update.py:6-14."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, 2, 3)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """models/raft/update.py:35-73: a 1x5 then a 5x1 ConvGRU pass."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = conv(c, hidden_dim, (1, 5))
        self.convr1 = conv(c, hidden_dim, (1, 5))
        self.convq1 = conv(c, hidden_dim, (1, 5))
        self.convz2 = conv(c, hidden_dim, (5, 1))
        self.convr2 = conv(c, hidden_dim, (5, 1))
        self.convq2 = conv(c, hidden_dim, (5, 1))

    @staticmethod
    def _gru(h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._gru(h, x, self.convz1, self.convr1, self.convq1)
        return self._gru(h, x, self.convz2, self.convr2, self.convq2)


class BasicMotionEncoder(nn.Module):
    """models/raft/update.py:96-121 (the compact-corr path).  Returns the
    motion features and the feature taps ``cor1``, ``cor`` and ``cor_flo``
    (raft_model.py:389-398): intermediates the forward computes anyway, so
    the taps build no tensor."""

    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = conv(cor_planes, 256, 1)
        self.convc2 = conv(256, 192, 3)
        self.convf1 = conv(2, 128, 7)
        self.convf2 = conv(128, 64, 3)
        self.conv = conv(64 + 192, 128 - 2, 3)

    def forward(self, flow, corr):
        cor1 = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor1))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        cor_flo = torch.cat([cor, flo], dim=1)
        out = F.relu(self.conv(cor_flo))
        return torch.cat([out, flow], dim=1), cor1, cor, cor_flo


class BasicUpdateBlock(nn.Module):
    """models/raft/update.py:139-162: motion encoder, SepConvGRU, FlowHead
    and the 64*9-channel convex-upsample mask head (x0.25).  Also returns
    the taps (motion_features, cor1, cor, cor_flo) (raft_model.py:449-450)."""

    def __init__(self, cor_planes: int, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            conv(128, 256, 3), nn.ReLU(inplace=True), conv(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion_features, cor1, cor, cor_flo = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1))
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow, (motion_features, cor1, cor, cor_flo)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling (models/raft/raft.py:111-122), in f32.
    flow: (B, 2, H, W); mask: (B, 64*9, H, W) -> (B, 2, 8H, 8W)."""
    B, _, H, W = flow.shape
    mask = torch.softmax(mask.float().view(B, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8.0 * flow.float(), [3, 3], padding=1).view(B, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2)  # (B, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * H, 8 * W)


def scale_flow_head(model: "RAFT", scale: float) -> "RAFT":
    """A copy of ``model`` with the FlowHead's output conv scaled by
    ``scale`` (the JAX package's ``scale_flow_head``): conv2 is linear, so
    every delta-flow shrinks by ``scale``.  Random-init RAFT iterates reach
    ~150 px; scale 0.05 puts them at trained-checkpoint magnitudes (5-40 px
    mean flow).  The input model is not modified."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        head = out.update_block.flow_head.conv2
        head.weight.mul_(scale)
        head.bias.mul_(scale)
    return out


class RAFT(nn.Module):
    """models/raft/raft.py:25-233: the standard configuration (fnorm=instance,
    cnorm=batch) and the FlowNetC-encoder variants.

    ``forward`` takes (B, 3, H, W) images in [0, 255], H and W multiples of
    8.  ``self.training`` selects the batch-norm mode, as ``train=`` does in
    the JAX package.  With ``test_mode=True`` it returns (flow_low (B, 2,
    H/8, W/8), flow_up (B, 2, H, W)); with ``test_mode=False`` the list of
    ``iters`` upsampled flows, one per iteration, for the sequence loss.

    Options with the JAX package's names (raft_model.py:712-758):

    - ``corr_impl``: "alt" looks windows up straight from the feature maps
      (kernel ``alt_corr_fwd``); "volume" builds the all-pairs volume and
      its pyramid once per forward and looks windows up in it (kernel
      ``corr_lookup_fwd``, the reference's CorrBlock).  "auto" is "alt" on
      every device, its meaning on the TPU; the two are value-equal.
    - ``return_features``: ``forward`` returns (flow_low, flow_up, feats)
      in test mode, ``feats`` holding the keys of
      ``registry.get_feature_map_keys("RAFT")`` in the model's NCHW
      (``corr_pyramid_{i}`` as (B, N, Hl, Wl), ``idx_corr_vol_{i}`` as
      (B, L*(2r+1)^2, H/8, W/8)).  Taps need the pyramid, so they take the
      volume path whatever ``corr_impl`` says (raft_model.py:843-850).
    - ``flownetc_encoder``: ``FlowNetCEncoder`` as fnet (and as cnet unless
      ``no_separate_context``).
    - ``no_separate_context``: no cnet; the context is ``conv_redir``, a
      1x1 conv on fmap1 (raft_model.py:880-882).

    ``plain_lookup`` runs the lookup's plain PyTorch version on every
    device instead of the CUDA kernels, and autograd differentiates it
    (the kernels' end-to-end oracle)."""

    hidden_dim = 128
    context_dim = 128
    corr_levels = 4
    corr_radius = 4

    def __init__(self, iters: int = 12, mixed_precision: bool = False,
                 plain_lookup: bool = False, corr_impl: str = "auto",
                 return_features: bool = False,
                 flownetc_encoder: bool = False,
                 no_separate_context: bool = False):
        super().__init__()
        if corr_impl not in ("auto", "alt", "volume"):
            raise ValueError(f"corr_impl must be 'auto', 'alt' or 'volume', "
                             f"got {corr_impl!r}")
        self.iters = iters
        self.mixed_precision = mixed_precision
        self.plain_lookup = plain_lookup
        self.corr_impl = corr_impl
        self.return_features = return_features
        self.no_separate_context = no_separate_context
        cdim = self.hidden_dim + self.context_dim
        if flownetc_encoder:
            self.fnet = FlowNetCEncoder(256)
        else:
            self.fnet = BasicEncoder(256, "instance")
        if no_separate_context:
            self.conv_redir = conv(256, cdim, 1)
        elif flownetc_encoder:
            self.cnet = FlowNetCEncoder(cdim)
        else:
            self.cnet = BasicEncoder(cdim, "batch")
        self.update_block = BasicUpdateBlock(
            self.corr_levels * (2 * self.corr_radius + 1) ** 2, self.hidden_dim)

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.mixed_precision)

    def _make_lookup(self, fmap1, fmap2, feats):
        """Once per forward: the lookup of every iteration, (B, H8, W8, 2)
        level-0 coords -> (B, H8, W8, L*(2r+1)^2) f32, on the alt or the
        volume path; the pyramid goes into ``feats`` when taps are on."""
        B, _, H8, W8 = fmap1.shape
        r = self.corr_radius
        # channels-last once per forward; the lookups read C-contiguous rows
        f1n, f2n = fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1)
        if feats is None and self.corr_impl != "volume":
            # f1 and the levels stay f32 (the gradient's precision); the
            # kernels read bf16 copies made here, once, under mixed precision
            f1, levels = prepare_alt_corr(f1n, f2n, self.corr_levels)
            kernel_inputs = None
            if self.mixed_precision:
                kernel_inputs = alt_corr_kernel_inputs(f1, levels,
                                                       torch.bfloat16)
                if self.plain_lookup:
                    # the kernels' bf16 values, held in f32 with an identity
                    # gradient: the plain lookup's gradient then stays f32,
                    # as the kernels' does, instead of being rounded to bf16
                    # and summed over the iterations in bf16 at a cast
                    f1 = f1 + (kernel_inputs[0].float() - f1).detach()
                    levels = tuple(lvl + (k.float() - lvl).detach()
                                   for lvl, k in zip(levels, kernel_inputs[1]))

            def lookup(coords):
                c = coords.reshape(B, H8 * W8, 2)
                if self.plain_lookup:
                    out = alt_corr_lookup_reference(f1, levels, c, r)
                else:
                    out = alt_corr_lookup(f1, levels, c, r, kernel_inputs)
                return out.reshape(B, H8, W8, -1)
            return lookup

        # the volume is cast once, before the pyramid, under mixed precision
        pyramid = volume_pyramid(
            f1n, f2n, self.corr_levels,
            torch.bfloat16 if self.mixed_precision else None)
        if feats is not None:
            feats.update({f"corr_pyramid_{i}": lvl
                          for i, lvl in enumerate(pyramid)})
        fn = corr_lookup_reference if self.plain_lookup else corr_lookup
        return lambda coords: fn(pyramid, coords, r)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                flow_init: torch.Tensor = None, test_mode: bool = True):
        x1 = 2.0 * (image1 / 255.0) - 1.0
        x2 = 2.0 * (image2 / 255.0) - 1.0
        B, _, H, W = x1.shape

        with self._autocast(x1.device):
            fmaps = self.fnet(torch.cat([x1, x2], dim=0))
        fmap1, fmap2 = fmaps.float().split(B, dim=0)
        feats = ({"fmap1": fmap1, "fmap2": fmap2} if self.return_features
                 else None)
        lookup = self._make_lookup(fmap1, fmap2, feats)

        with self._autocast(x1.device):
            if self.no_separate_context:
                cnet = self.conv_redir(fmap1)
            else:
                cnet = self.cnet(x1)
        net, inp = cnet.float().split([self.hidden_dim, self.context_dim], dim=1)
        net = torch.tanh(net)
        inp = torch.relu(inp)
        if feats is not None:
            feats.update(net=net, inp=inp)

        H8, W8 = fmap1.shape[2], fmap1.shape[3]
        coords0 = coords_grid(H8, W8, device=x1.device).permute(2, 0, 1)
        coords0 = coords0[None].expand(B, 2, H8, W8)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init
        flow_predictions = []
        for it in range(self.iters):
            coords1 = coords1.detach()
            corr = lookup(coords1.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            flow = coords1 - coords0
            with self._autocast(x1.device):
                net, up_mask, delta_flow, taps = self.update_block(
                    net, inp, corr, flow)
            coords1 = coords1 + delta_flow.float()
            if not test_mode or feats is not None:
                flow_up = upsample_flow_convex(coords1 - coords0, up_mask)
            if not test_mode:
                flow_predictions.append(flow_up)
            if feats is not None:
                motion_features, cor1, cor, cor_flo = taps
                feats.update({
                    f"idx_corr_vol_{it}": corr, f"net_{it}": net,
                    f"motion_features_{it}": motion_features,
                    f"cor1_{it}": cor1, f"cor_{it}": cor,
                    f"cor_flo_{it}": cor_flo, f"flow_pred_{it}": flow_up})
        if not test_mode:
            return flow_predictions
        flow_low = coords1 - coords0
        if feats is not None:
            return flow_low, flow_up, feats
        # test mode returns only the last upsampled flow, so only it is built
        return flow_low, upsample_flow_convex(flow_low, up_mask)
