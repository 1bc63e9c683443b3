"""RAFT in every configuration of the JAX package's module, inference and
training: the standard one, small RAFT, the FlowNetC-encoder variants, any
lookup radius and level count, the encoders' norms and the
spatial-correlation mode (counterpart of
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
    _widen,
    alt_corr_kernel_inputs,
    alt_corr_lookup,
    alt_corr_lookup_reference,
    corr_lookup,
    corr_lookup_reference,
    corr_pyramid,
    prepare_alt_corr,
    spatial_correlation,
    volume_pyramid,
)
from ..ops.interp import coords_grid, resize_bilinear
from ..parallel.spatial import all_gather_rows, halo_rows, row_mesh
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


class BottleneckBlock(nn.Module):
    """models/raft/extractor.py:81-140 (the small encoder's block): 1x1,
    3x3 (strided), 1x1 convs at planes/4, planes/4, planes.  As in the
    reference, ``norm4`` is registered both on its own and as
    ``downsample.1``."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        q = planes // 4
        self.conv1 = conv(in_planes, q, 1)
        self.conv2 = conv(q, q, 3, stride)
        self.conv3 = conv(q, planes, 1)
        self.relu = nn.ReLU(inplace=True)
        self.norm1 = norm(norm_fn, q)
        self.norm2 = norm(norm_fn, q)
        self.norm3 = norm(norm_fn, planes)
        if stride == 1:
            self.downsample = None
        else:
            self.norm4 = norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride), self.norm4)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        y = self.relu(self.norm3(self.conv3(y)))
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


class SmallEncoder(nn.Module):
    """models/raft/extractor.py:218-289: conv7x7/2 to 32 channels, three
    bottleneck stages (32, 64/2, 96/2), 1x1 output conv.  Output stride 8."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = conv(3, 32, 7, 2)
        self.norm1 = norm(norm_fn, 32)
        self.relu1 = nn.ReLU(inplace=True)
        stages, in_planes = [], 32
        for dim, stride in ((32, 1), (64, 2), (96, 2)):
            stages.append(nn.Sequential(
                BottleneckBlock(in_planes, dim, norm_fn, stride),
                BottleneckBlock(dim, dim, norm_fn, 1)))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = stages
        self.conv2 = conv(96, output_dim, 1)

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


class ConvGRU(nn.Module):
    """models/raft/update.py:17-32: the small update block's 3x3 ConvGRU."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 146):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz = conv(c, hidden_dim, 3)
        self.convr = conv(c, hidden_dim, 3)
        self.convq = conv(c, hidden_dim, 3)

    def forward(self, h, x):
        return SepConvGRU._gru(h, x, self.convz, self.convr, self.convq)


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


class SmallMotionEncoder(nn.Module):
    """models/raft/update.py:76-93: 96 correlation and 32 flow features
    into 80, with the flow appended (82 channels)."""

    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = conv(cor_planes, 96, 1)
        self.convf1 = conv(2, 64, 7)
        self.convf2 = conv(64, 32, 3)
        self.conv = conv(128, 80, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallUpdateBlock(nn.Module):
    """models/raft/update.py:124-136: motion encoder, ConvGRU, FlowHead; no
    mask head (small RAFT upsamples with ``upflow8``).  Returns (net, None,
    delta_flow, taps), the taps being the motion features four times, as
    the JAX package's (raft_model.py:468-470) gives them for ``cor1``,
    ``cor`` and ``cor_flo`` too."""

    def __init__(self, cor_planes: int, hidden_dim: int = 96):
        super().__init__()
        self.encoder = SmallMotionEncoder(cor_planes)
        self.gru = ConvGRU(hidden_dim, 82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        motion_features = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1))
        return net, None, self.flow_head(net), (motion_features,) * 4


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
    """Convex 8x upsampling (models/raft/raft.py:111-122), in f32 (f64 for
    f64 inputs).  flow: (B, 2, H, W); mask: (B, 64*9, H, W) -> (B, 2, 8H,
    8W)."""
    B, _, H, W = flow.shape
    mask = torch.softmax(_widen(mask).view(B, 1, 9, 8, 8, H, W), dim=2)
    if row_mesh() is None:
        up = F.unfold(8.0 * _widen(flow), [3, 3], padding=1)
    else:  # a spatial mesh's block: the 3x3 windows' rows from a halo
        up = F.unfold(halo_rows(8.0 * _widen(flow), 1, 1), [3, 3],
                      padding=(0, 1))
    up = up.view(B, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2)  # (B, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * H, 8 * W)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """models/raft/utils/utils.py:85-87 (raft_model.py:678-681): 8 x the
    bilinear (align_corners=True) 8x upsample, in f32 (f64 for f64
    inputs).  (B, 2, H, W) -> (B, 2, 8H, 8W)."""
    H, W = flow.shape[2:]
    return 8.0 * resize_bilinear(_widen(flow), 8 * H, 8 * W,
                                 align_corners=True)


def spatial_corr_lookup(pyramid, H1: int, W1: int) -> torch.Tensor:
    """The spatial-correlation mode's lookup (corr.py:85-94; JAX
    ``_spatial_corr_lookup``, raft_model.py:1045-1060): no sampling; level
    i (B, P, h/2^i, w/2^i) is nearest-upsampled by 2^i and then C-order
    RESHAPED, not transposed, to (B, H1, W1, -1), as the reference's
    ``corr.view(batch, h1, w1, -1)`` reinterprets its memory; the levels
    are concatenated on the last axis.  Independent of the coords.  Each
    upsampled level must be H1 x W1 again, so H1 and W1 must be multiples
    of 2^(L-1) (H and W of 64 with RAFT's 4 levels); otherwise it raises
    (the JAX package's reshape gives the wrong channel count there)."""
    B = pyramid[0].shape[0]
    return torch.cat([_upsampled(lvl, i, len(pyramid), H1, W1).reshape(
        B, H1, W1, -1) for i, lvl in enumerate(pyramid)], dim=-1)


def _upsampled(lvl: torch.Tensor, i: int, levels: int, H1: int,
               W1: int) -> torch.Tensor:
    """Pyramid level i nearest-upsampled by 2^i to H1 x W1, or the refusal
    where it does not come back to that size."""
    x = lvl
    if i:
        x = x.repeat_interleave(2 ** i, dim=2).repeat_interleave(2 ** i, dim=3)
    if tuple(x.shape[2:]) != (H1, W1):
        raise ValueError(
            f"compute_spatial: level {i} of the {H1}x{W1} correlation "
            f"upsamples to {tuple(x.shape[2:])}; H/8 and W/8 must be "
            f"multiples of {2 ** (levels - 1)}")
    return x


def spatial_corr_lookup_rows(sc: torch.Tensor, levels: int) -> torch.Tensor:
    """This rank's rows of ``spatial_corr_lookup`` of the whole map's
    pyramid under a row-splitting spatial mesh, from the rank's row block
    ``sc`` (B, P, h, W1) of the raw correlation: (B, h, W1, levels * P).

    The C-order reshape gives block i of n the contiguous flat range [i h
    W1 P, (i+1) h W1 P) of each item's (P, H1, W1) stack at every level,
    which lies in the whole-image planes of channels floor(i P / n) ..
    ceil((i+1) P / n).  The raw map is all-gathered once
    (differentiable: the gradient returns to its rows' owners), narrowed
    to those channels, pooled and upsampled channel by channel, and the
    range taken: the unsharded lookup's rows, bit for bit, with a pyramid
    of about 1/n of the channels a rank."""
    mesh = row_mesh()
    n, i = mesh.n_spatial, mesh.spatial_rank
    whole = all_gather_rows(sc, 2)
    B, P, H1, W1 = whole.shape
    plane, size = H1 * W1, H1 // n * W1 * P
    start = i * size
    c0, c1 = start // plane, -(-(start + size) // plane)
    pyramid = corr_pyramid(whole[:, c0:c1], levels)
    return torch.cat([
        _upsampled(lvl, k, levels, H1, W1).reshape(B, -1).narrow(
            1, start - c0 * plane, size).reshape(B, H1 // n, W1, P)
        for k, lvl in enumerate(pyramid)], dim=-1)


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
    """models/raft/raft.py:25-233 in every configuration of the JAX
    package's ``RAFT`` (raft_model.py:712-758).

    ``forward`` takes (B, 3, H, W) images in [0, 255], H and W multiples of
    8.  ``self.training`` selects the batch-norm mode, as ``train=`` does in
    the JAX package.  With ``test_mode=True`` it returns (flow_low (B, 2,
    H/8, W/8), flow_up (B, 2, H, W)); with ``test_mode=False`` the list of
    ``iters`` upsampled flows, one per iteration, for the sequence loss.

    Options with the JAX package's names:

    - ``small``: small RAFT: hidden 96, context 64, radius 3,
      ``SmallEncoder(128, "instance")`` fnet, ``SmallEncoder(160, "none")``
      cnet, ``SmallUpdateBlock`` and ``upflow8`` in place of the convex
      upsample.
    - ``corr_levels``, ``corr_radius``: the pyramid's levels and the
      lookup's radius (small RAFT's is 3 whatever ``corr_radius`` says);
      the kernels take radius 1..7.
    - ``fnorm``, ``cnorm``: the norms of the standard fnet and cnet
      ("instance", "batch", "group" or "none").
    - ``corr_impl``: "alt" looks windows up straight from the feature maps
      (kernel ``alt_corr_fwd``); "volume" builds the all-pairs volume and
      its pyramid once per forward and looks windows up in it (kernel
      ``corr_lookup_fwd``, the reference's CorrBlock).  "auto" is "alt" on
      every device, its meaning on the TPU; the two are value-equal.
    - ``compute_spatial``: the spatial-correlation mode
      (CorrBlock(compute_spatial=True), corr.py:33-54): the (21, 2)
      ``spatial_correlation`` of the f32 fmaps (kernels
      ``spatial_corr_fwd`` / ``spatial_corr_bwd``), its raw (B, 441, h, w)
      output pyramided, and ``spatial_corr_lookup`` in place of the window
      lookup, ``L * 441`` correlation planes.
    - ``return_features``: ``forward`` returns (flow_low, flow_up, feats)
      in test mode, ``feats`` holding the keys of
      ``registry.get_feature_map_keys("RAFT")`` in the model's NCHW
      (``corr_pyramid_{i}`` as (B, N, Hl, Wl), ``idx_corr_vol_{i}`` as
      (B, L*(2r+1)^2, H/8, W/8)), and with ``compute_spatial`` also
      ``spatial_corr``, the correlation / C.  Taps need the pyramid, so
      they take the volume path whatever ``corr_impl`` says
      (raft_model.py:843-850).
    - ``flownetc_encoder``: ``FlowNetCEncoder`` as fnet (and as cnet unless
      ``no_separate_context``).
    - ``no_separate_context``: no cnet; the context is ``conv_redir``, a
      1x1 conv on fmap1 (raft_model.py:880-882).

    ``plain_lookup`` runs the lookup's plain PyTorch version on every
    device instead of the CUDA kernels (with ``compute_spatial``, the
    spatial correlation's), and autograd differentiates it (the kernels'
    end-to-end oracle)."""

    def __init__(self, iters: int = 12, mixed_precision: bool = False,
                 plain_lookup: bool = False, corr_impl: str = "auto",
                 return_features: bool = False,
                 flownetc_encoder: bool = False,
                 no_separate_context: bool = False, small: bool = False,
                 corr_levels: int = 4, corr_radius: int = 4,
                 fnorm: str = "instance", cnorm: str = "batch",
                 compute_spatial: bool = False):
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
        self.small = small
        self.compute_spatial = compute_spatial
        self.hidden_dim = 96 if small else 128
        self.context_dim = 64 if small else 128
        self.corr_levels = corr_levels
        self.corr_radius = 3 if small else corr_radius
        cdim = self.hidden_dim + self.context_dim
        if flownetc_encoder:
            self.fnet = FlowNetCEncoder(256)
        elif small:
            self.fnet = SmallEncoder(128, "instance")
        else:
            self.fnet = BasicEncoder(256, fnorm)
        if no_separate_context:
            fdim = 128 if small and not flownetc_encoder else 256
            self.conv_redir = conv(fdim, cdim, 1)
        elif flownetc_encoder:
            self.cnet = FlowNetCEncoder(cdim)
        elif small:
            self.cnet = SmallEncoder(cdim, "none")
        else:
            self.cnet = BasicEncoder(cdim, cnorm)
        cor_planes = corr_levels * (21 ** 2 if compute_spatial
                                    else (2 * self.corr_radius + 1) ** 2)
        block = SmallUpdateBlock if small else BasicUpdateBlock
        self.update_block = block(cor_planes, self.hidden_dim)

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.mixed_precision)

    def _make_lookup(self, fmap1, fmap2, feats):
        """Once per forward: the lookup of every iteration, (B, H8, W8, 2)
        level-0 coords -> (B, H8, W8, L*(2r+1)^2) f32, on the alt or the
        volume path (or (B, H8, W8, L*441) in the spatial-correlation
        mode); the pyramid goes into ``feats`` when taps are on."""
        B, _, H8, W8 = fmap1.shape
        r = self.corr_radius
        if self.compute_spatial:
            # raft_model.py:855-866: the raw correlation is pyramided; only
            # the tap divides by C.  f32 fmaps, so f32 whatever the autocast
            with torch.autocast(fmap1.device.type, enabled=False):
                sc = spatial_correlation(fmap1, fmap2, 21, dilation_patch=2,
                                         plain=self.plain_lookup)
            pyramid = None
            if feats is not None or row_mesh() is None:
                # on a row block: the block's rows of the whole pyramid
                pyramid = corr_pyramid(sc, self.corr_levels)
            if feats is not None:
                feats["spatial_corr"] = sc / fmap1.shape[1]
                feats.update({f"corr_pyramid_{i}": lvl
                              for i, lvl in enumerate(pyramid)})
            if row_mesh() is not None:
                # the lookup reshapes the whole map: once, independent of
                # the coords
                rows = spatial_corr_lookup_rows(sc, self.corr_levels)
                return lambda coords: rows
            return lambda coords: spatial_corr_lookup(pyramid, H8, W8)
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
        fmap1, fmap2 = _widen(fmaps).split(B, dim=0)
        feats = ({"fmap1": fmap1, "fmap2": fmap2} if self.return_features
                 else None)
        lookup = self._make_lookup(fmap1, fmap2, feats)

        with self._autocast(x1.device):
            if self.no_separate_context:
                cnet = self.conv_redir(fmap1)
            else:
                cnet = self.cnet(x1)
        net, inp = _widen(cnet).split([self.hidden_dim, self.context_dim], dim=1)
        net = torch.tanh(net)
        inp = torch.relu(inp)
        if feats is not None:
            feats.update(net=net, inp=inp)

        H8, W8 = fmap1.shape[2], fmap1.shape[3]
        coords0 = coords_grid(H8, W8, device=x1.device,
                              dtype=fmap1.dtype).permute(2, 0, 1)
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
            coords1 = coords1 + _widen(delta_flow)
            if not test_mode or feats is not None:
                flow_up = self._upsample(coords1 - coords0, up_mask)
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
        return flow_low, self._upsample(flow_low, up_mask)

    def _upsample(self, flow, mask):
        """The convex upsample, or small RAFT's ``upflow8`` (no mask)."""
        return upflow8(flow) if mask is None else upsample_flow_convex(flow,
                                                                       mask)
