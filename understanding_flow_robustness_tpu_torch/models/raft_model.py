"""RAFT, standard configuration, inference and training (counterpart of
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
    prepare_alt_corr,
)
from ..ops.interp import coords_grid
from .layers import conv, norm


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
    """models/raft/update.py:96-121 (the compact-corr path)."""

    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = conv(cor_planes, 256, 1)
        self.convc2 = conv(256, 192, 3)
        self.convf1 = conv(2, 128, 7)
        self.convf2 = conv(128, 64, 3)
        self.conv = conv(64 + 192, 128 - 2, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    """models/raft/update.py:139-162: motion encoder, SepConvGRU, FlowHead
    and the 64*9-channel convex-upsample mask head (x0.25)."""

    def __init__(self, cor_planes: int, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            conv(128, 256, 3), nn.ReLU(inplace=True), conv(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion_features = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1))
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow


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
    """models/raft/raft.py:25-233, standard configuration (fnorm=instance,
    cnorm=batch).

    ``forward`` takes (B, 3, H, W) images in [0, 255], H and W multiples of
    8.  ``self.training`` selects the batch-norm mode, as ``train=`` does in
    the JAX package.  With ``test_mode=True`` it returns (flow_low (B, 2,
    H/8, W/8), flow_up (B, 2, H, W)); with ``test_mode=False`` the list of
    ``iters`` upsampled flows, one per iteration, for the sequence loss.

    ``plain_lookup`` runs the lookup's plain PyTorch version on every
    device instead of the CUDA kernels, and autograd differentiates it
    (the kernels' end-to-end oracle)."""

    hidden_dim = 128
    context_dim = 128
    corr_levels = 4
    corr_radius = 4

    def __init__(self, iters: int = 12, mixed_precision: bool = False,
                 plain_lookup: bool = False):
        super().__init__()
        self.iters = iters
        self.mixed_precision = mixed_precision
        self.plain_lookup = plain_lookup
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch")
        self.update_block = BasicUpdateBlock(
            self.corr_levels * (2 * self.corr_radius + 1) ** 2, self.hidden_dim)

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.mixed_precision)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                flow_init: torch.Tensor = None, test_mode: bool = True):
        x1 = 2.0 * (image1 / 255.0) - 1.0
        x2 = 2.0 * (image2 / 255.0) - 1.0
        B, _, H, W = x1.shape

        with self._autocast(x1.device):
            fmaps = self.fnet(torch.cat([x1, x2], dim=0))
        fmap1, fmap2 = fmaps.float().split(B, dim=0)
        # channels-last once per forward; the lookup reads C-contiguous rows.
        # f1 and the levels stay f32 (the gradient's precision); the
        # kernels read bf16 copies made here, once, under mixed precision
        f1, levels = prepare_alt_corr(
            fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1),
            self.corr_levels)
        kernel_inputs = None
        if self.mixed_precision:
            kernel_inputs = alt_corr_kernel_inputs(f1, levels, torch.bfloat16)
            if self.plain_lookup:
                # the kernels' bf16 values, held in f32 with an identity
                # gradient: the plain lookup's gradient then stays f32, as
                # the kernels' does, instead of being rounded to bf16 and
                # summed over the iterations in bf16 at a cast
                f1 = f1 + (kernel_inputs[0].float() - f1).detach()
                levels = tuple(lvl + (k.float() - lvl).detach()
                               for lvl, k in zip(levels, kernel_inputs[1]))

        with self._autocast(x1.device):
            cnet = self.cnet(x1)
        net, inp = cnet.float().split([self.hidden_dim, self.context_dim], dim=1)
        net = torch.tanh(net)
        inp = torch.relu(inp)

        H8, W8 = fmap1.shape[2], fmap1.shape[3]
        coords0 = coords_grid(H8, W8, device=x1.device).permute(2, 0, 1)
        coords0 = coords0[None].expand(B, 2, H8, W8)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init
        flow_predictions = []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            c = coords1.permute(0, 2, 3, 1).reshape(B, H8 * W8, 2)
            if self.plain_lookup:
                corr = alt_corr_lookup_reference(f1, levels, c, self.corr_radius)
            else:
                corr = alt_corr_lookup(f1, levels, c, self.corr_radius,
                                       kernel_inputs)
            corr = corr.reshape(B, H8, W8, -1).permute(0, 3, 1, 2)
            flow = coords1 - coords0
            with self._autocast(x1.device):
                net, up_mask, delta_flow = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta_flow.float()
            if not test_mode:
                flow_predictions.append(
                    upsample_flow_convex(coords1 - coords0, up_mask))
        if not test_mode:
            return flow_predictions
        flow_low = coords1 - coords0
        # test mode returns only the last upsampled flow, so only it is built
        return flow_low, upsample_flow_convex(flow_low, up_mask)
