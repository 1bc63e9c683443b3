"""Layer helpers of the ported models (counterpart of
``understanding_flow_robustness_tpu/models/layers.py``).

The JAX package reimplements PyTorch's layers; here they are PyTorch's own:
``TorchConv`` is ``nn.Conv2d`` with dilation * (k-1)//2 padding per axis,
``TorchConvTranspose`` is ``nn.ConvTranspose2d`` (``deconv``),
``leaky_relu`` is ``nn.LeakyReLU(0.1)``, ``ConvBlock`` and ``DeconvBlock``
are ``conv_block`` and ``deconv_block`` (``nn.Sequential``s, as the
reference names them),
``InstanceNorm2d`` is ``nn.InstanceNorm2d(affine=False, eps=1e-5)``,
``TorchGroupNorm`` is ``nn.GroupNorm(eps=1e-5)`` and
``TorchBatchNorm`` is ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``.  In eval
mode it normalises with the running statistics; in train mode with the
batch statistics, and it updates the running mean and the unbiased running
variance (n = B*H*W) with momentum 0.1, as ``TorchBatchNorm(
use_running_average=False)`` does (layers.py:419-429).  Instance norm has
no running statistics in either package.

Under data parallelism ``global_batch_norm`` swaps ``GlobalBatchNorm2d``
in for every ``BatchNorm2d``: train-mode statistics over the global batch
of all ranks, as the JAX package's pjit step computes them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel.mesh import all_reduce_sum_grad
from ..parallel.spatial import row_mesh


def conv(in_ch: int, out_ch: int, kernel_size, stride: int = 1,
         dilation: int = 1, bias: bool = True) -> nn.Conv2d:
    """nn.Conv2d with the JAX package's TorchConv default padding:
    dilation * (k-1)//2 per axis, so (1, 5) pads (0, 2)
    (layers.py:109, 149)."""
    kh, kw = kernel_size if isinstance(kernel_size, tuple) else (kernel_size,) * 2
    return nn.Conv2d(in_ch, out_ch, (kh, kw), stride=stride,
                     padding=(dilation * ((kh - 1) // 2),
                              dilation * ((kw - 1) // 2)),
                     dilation=dilation, bias=bias)


def deconv(in_ch: int, out_ch: int, bias: bool = True) -> nn.ConvTranspose2d:
    """The reference's learned 2x upsampling, ConvTranspose2d(k=4, s=2,
    p=1) (TorchConvTranspose, layers.py:251-310): the flow upsamplers and
    PWC-Net's deconvs."""
    return nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1,
                              bias=bias)


def leaky_relu() -> nn.LeakyReLU:
    """LeakyReLU(0.1) (layers.py:32)."""
    return nn.LeakyReLU(0.1)


def conv_block(in_ch: int, out_ch: int, kernel_size, stride: int = 1,
               dilation: int = 1, batch_norm: bool = False) -> nn.Sequential:
    """The reference's ``conv()`` helper (models/submodules.py:18-43; JAX
    ``ConvBlock``, layers.py:433-474): ``conv`` (+ BatchNorm2d, and then
    no conv bias) + LeakyReLU(0.1), named ``<name>.0`` (conv) and
    ``<name>.1`` (batch norm) as in the reference's checkpoints."""
    layers = [conv(in_ch, out_ch, kernel_size, stride, dilation,
                   bias=not batch_norm)]
    if batch_norm:
        layers.append(nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1))
    return nn.Sequential(*layers, leaky_relu())


def deconv_block(in_ch: int, out_ch: int, bias: bool = True) -> nn.Sequential:
    """The reference's ``deconv()`` helper: ``deconv`` + LeakyReLU(0.1)
    (JAX ``DeconvBlock``, layers.py:478-498), named ``<name>.0``; FlowNetS
    and the flexible FlowNetC have no bias, FlowNetC has one."""
    return nn.Sequential(deconv(in_ch, out_ch, bias), leaky_relu())


def crop_like(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Crop x's trailing rows and columns to target's size, NCHW
    (models/FlowNetS.py:52-57; layers.py:503-507).  The crop is the
    image's bottom rows: a spatial mesh's blocks, whose sizes match where
    H divides by 64, take none and raise otherwise."""
    if row_mesh() is not None and x.shape[2] != target.shape[2]:
        raise ValueError(f"crop_like of {x.shape[2]}-row blocks to "
                         f"{target.shape[2]}: the crop is the image's last "
                         "rows")
    return x[:, :, :target.shape[2], :target.shape[3]]


def norm(norm_fn: str, channels: int) -> nn.Module:
    """RAFT's encoder norms (raft_model.py:_norm): ``"group"`` is
    ``nn.GroupNorm(channels // 8, channels)`` with eps 1e-5 and an affine
    weight and bias (``TorchGroupNorm``, layers.py:363-380), ``"none"`` the
    identity."""
    if norm_fn == "instance":
        return nn.InstanceNorm2d(channels, affine=False, eps=1e-5)
    if norm_fn == "batch":
        return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    if norm_fn == "group":
        return nn.GroupNorm(channels // 8, channels, eps=1e-5)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"norm_fn must be 'instance', 'batch', 'group' or "
                     f"'none', got {norm_fn!r}")


def freeze_bn(module: nn.Module) -> nn.Module:
    """Every ``BatchNorm2d`` of ``module`` to eval mode: normalise with the
    running statistics and write none (the reference's ``m.eval()`` on
    each BatchNorm2d, models/raft/raft.py:97-100; the JAX train step's
    ``freeze_bn``, train_step.py:113-118).  Call it after ``.train()``."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.eval()
    return module


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation, drawn from ``generator``: every
    conv kernel from flax's kaiming_normal (truncated normal at +-2 sigma,
    variance 2/fan_in), biases zero, batch norms at scale 1, bias 0, mean
    0, var 1.  RAFT's random-init operating points (the ~150 px "wild"
    iterates, the calibrated ``scale_flow_head``) depend on this scale.
    flax counts a transposed conv's fan-in as in/groups * kh * kw (its
    kernel is (kh, kw, in, out)); torch stores that weight as (in,
    out/groups, kh, kw)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.in_channels // m.groups * m.weight[0, 0].numel()
            else:
                fan_in = m.weight[0].numel()
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``BatchNorm2d`` whose train-mode statistics run over the global
    batch of ``mesh``'s ranks (the JAX package's pjit step partitions the
    reduction of ``TorchBatchNorm``, layers.py:419-429).  Per channel, the
    sum and then the sum of squared deviations are all-reduced, with
    autograd through both collectives; n is the global element count, in
    the unbiased factor of ``running_var`` too.  The parameter and buffer
    names are ``BatchNorm2d``'s, so its state dict loads anywhere.  In eval
    mode it is ``BatchNorm2d``.  (``nn.SyncBatchNorm`` refuses CPU
    tensors.)"""

    mesh = None  # set by global_batch_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        n = xf.numel() // xf.shape[1] * self.mesh.world
        mean = all_reduce_sum_grad(self.mesh, xf.sum(dim=(0, 2, 3))) / n
        d = xf - mean[None, :, None, None]
        var = all_reduce_sum_grad(self.mesh,
                                  (d * d).sum(dim=(0, 2, 3))) / n
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (1.0 / float(self.num_batches_tracked)
                     if self.momentum is None else self.momentum)
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(
                    m * var.detach() * (n / max(n - 1, 1)))
        y = d * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] \
                + self.bias[None, :, None, None]
        return y.to(x.dtype)


def global_batch_norm(module: nn.Module, mesh) -> nn.Module:
    """Make every ``BatchNorm2d`` of ``module`` a ``GlobalBatchNorm2d`` on
    ``mesh``, in place: the same objects, parameters and buffers (an
    optimizer built before keeps them), with the global statistics.  On a
    one-device mesh the global batch is the local one and the module is
    left as it is."""
    if mesh is None or mesh.world == 1:
        return module
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = GlobalBatchNorm2d
            m.mesh = mesh
    return module
