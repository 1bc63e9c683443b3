"""Spatial (height) sharding on a 2-D ``data x spatial`` mesh (counterpart
of ``understanding_flow_robustness_tpu/parallel/spatial.py``).

A frame pair too tall for one device is split by image height over the
ranks of a :func:`parallel.launch`, and optionally also by batch
(``make_2d_mesh``): each rank holds its batch slice's row block and the
halo rows it receives.  XLA's SPMD partitioner inserts the JAX package's
halo exchanges itself; PyTorch has none, so here every operation whose
window crosses rows exchanges its own halo:

* modules: ``spatial_shard`` turns every ``nn.Conv2d`` into a halo
  convolution with no padding along H, every ``nn.ConvTranspose2d`` into a
  halo transposed convolution and a crop, and ``nn.InstanceNorm2d`` /
  ``nn.GroupNorm`` into norms whose moments over H x W are all-reduced
  over the spatial group -- in place, as ``models.layers.
  global_batch_norm`` does, so parameters and state dicts do not change;
  it raises on any module type it does not know to be shard-aware;
* functions: the port's ops read the mesh of the innermost
  :func:`spatial_context` (a ``contextvars`` variable, as the JAX package's
  ``ops/kernel_gate.py`` gates its kernels) and are untouched when it is
  unset: the bilinear resize, ``coords_grid``, the warp (its source rows
  all-gathered, B4 writing the block's rows), the spatial correlation
  (f2 halo'd by its whole displacement, both kernels at a row offset),
  RAFT's lookups (the second frame's features all-gathered, B1/B2/B5 on
  the block's queries; in the spatial-correlation mode the raw map
  gathered and each rank's rows of its C-order reshape built) and the
  convex upsample's unfold;
* reductions: the attack losses and the per-sample L1 norm of MI-FGSM
  sum over the mesh.

Every exchange is an ``all_reduce`` of per-rank slots (a rank writes its
rows into its slot of a zero buffer; x + 0 = x, so the gather is exact),
the one collective that NCCL and gloo -- on CPU ranks and on CUDA ranks
sharing a card -- all take; its backward is the same all-reduce of the
cotangents, added to the rows' owners.  While a context with more than one
row block is active, a module forward of a type that is not shard-aware
raises: no rank returns a shard-local answer in silence.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh, _AllReduceSum, shard_batch

SPATIAL_AXIS = "spatial"
# the models' total stride: every zoo model's H divides by it (JAX's
# check_spatial_shapes default)
MODEL_STRIDE = 64

_MESH: contextvars.ContextVar = contextvars.ContextVar("ufr_spatial_mesh",
                                                       default=None)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`spatial_context`, None outside
    one."""
    return _MESH.get()


def row_mesh() -> Optional[Mesh]:
    """The active mesh when it splits rows (``n_spatial`` > 1), else None:
    the row-local operations' switch."""
    mesh = _MESH.get()
    return mesh if mesh is not None and mesh.n_spatial > 1 else None


def _check_rows(n_spatial: int, h: int, stride: int) -> None:
    if h % (n_spatial * stride):
        raise ValueError(
            f"image height {h} must be divisible by the spatial axis size "
            f"({n_spatial}) times the model stride ({stride}) for even height "
            f"sharding; reshape/pad the input or shrink the spatial axis")


def check_spatial_shapes(mesh: Mesh, img, stride: int = MODEL_STRIDE) -> None:
    """Fail fast, with the rule named, when the height of the global NHWC
    image ``img`` cannot shard evenly over the mesh's spatial axis (JAX
    ``check_spatial_shapes``, parallel/spatial.py:62-74): every block's
    first row must then fall on every layer's stride."""
    _check_rows(mesh.n_spatial, img.shape[1], stride)


def check_block_shapes(mesh: Optional[Mesh], block,
                       stride: int = MODEL_STRIDE) -> None:
    """``check_spatial_shapes`` for a rank's NHWC block of the image."""
    n = 1 if mesh is None else mesh.n_spatial
    _check_rows(n, block.shape[1] * n, stride)


# ------------------------------------------------------------ the blocks

def _row_block(mesh: Mesh, x, dim: int):
    n = x.shape[dim]
    if n % mesh.n_spatial:
        raise ValueError(f"{n} rows do not divide over {mesh.n_spatial} "
                         "row blocks")
    h = n // mesh.n_spatial
    return x.narrow(dim, mesh.spatial_rank * h, h)


def shard_rows(mesh: Optional[Mesh], x, layout: str = "nhwc"):
    """This rank's block of a global ``layout`` ("nhwc" or "nchw") tensor:
    its batch slice (``shard_batch``) and its row block, as
    ``image_sharding`` lays an image out (batch over ``data``, H over
    ``spatial``)."""
    if mesh is None:
        return x
    x = shard_batch(mesh, x)
    return x if mesh.n_spatial == 1 else _row_block(mesh, x, _h_dim(layout))


def _h_dim(layout: str) -> int:
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"layout must be 'nhwc' or 'nchw', got {layout!r}")
    return 1 if layout == "nhwc" else 2


def _slots(x: torch.Tensor, group, n: int, i: int) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` of ``group`` in its slot, by one
    all-reduce of a zero buffer holding ``x`` in slot ``i``."""
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[i] = x
    dist.all_reduce(buf, group=group)
    return buf


@torch.no_grad()
def gather_rows(mesh: Optional[Mesh], x, layout: str = "nhwc"):
    """The inverse of :func:`shard_rows`: the global tensor from every
    rank's block, on every rank (no autograd)."""
    if mesh is None:
        return x
    if mesh.spatial_group is not None:
        x = torch.cat(list(_slots(x.contiguous(), mesh.spatial_group,
                                  mesh.n_spatial, mesh.spatial_rank)),
                      _h_dim(layout))
    if mesh.group is not None:
        x = torch.cat(list(_slots(x.contiguous(), mesh.group, mesh.world,
                                  mesh.rank)))
    return x


# ------------------------------------------------------- the exchanges

def _halo_index(top: int, bottom: int, h: int, n: int, i: int, pb: int,
                pt: int, edge: bool) -> tuple:
    """Where each halo row of block ``i`` lies in the gathered strips: each
    block sends its first ``pb`` and last ``pt`` rows, laid out as n
    strips of pb + pt rows.  Returns (index, valid) lists over the ``top``
    rows above and the ``bottom`` rows below; past the image edge a row is
    the edge row (``edge``) or invalid (zeros)."""
    H = n * h
    index, valid = [], []
    for g in [*range(i * h - top, i * h), *range(i * h + h, i * h + h + bottom)]:
        inside = 0 <= g < H
        q, r = divmod(min(max(g, 0), H - 1), h)
        # a row above the block is among its owner's last pt rows, a row
        # below among its first pb (or the image's first / last row)
        pos = r if r < pb else pb + r - (h - pt)
        index.append(q * (pb + pt) + pos if inside or edge else 0)
        valid.append(inside or edge)
    return index, valid


class _HaloRows(torch.autograd.Function):
    """x (B, C, h, W), one rank's row block -> (B, C, top + h + bottom, W)
    with the rows above and below from the ranks that hold them; the reach
    may span several ranks.  The backward adds each halo row's cotangent
    into its owner's row."""

    @staticmethod
    def forward(ctx, x, top, bottom, edge, group, n, i):
        B, C, h, W = x.shape
        pt, pb = min(top, h), min(bottom, h)
        if edge:  # the image's first and last rows travel too
            pt, pb = max(pt, 1), max(pb, 1)
        strips = torch.cat([x[:, :, :pb], x[:, :, h - pt:]], 2)
        gathered = _slots(strips, group, n, i)  # (n, B, C, pb + pt, W)
        flat = gathered.permute(1, 2, 0, 3, 4).reshape(B, C, n * (pb + pt), W)
        index, valid = _halo_index(top, bottom, h, n, i, pb, pt, edge)
        index = torch.tensor(index, dtype=torch.long, device=x.device)
        valid = torch.tensor(valid, dtype=torch.bool, device=x.device)
        rows = flat.index_select(2, index)
        rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
        ctx.save_for_backward(index, valid)
        ctx.args = (top, h, pb, pt, group, n, i)
        return torch.cat([rows[:, :, :top], x, rows[:, :, top:]], 2)

    @staticmethod
    def backward(ctx, g):
        index, valid = ctx.saved_tensors
        top, h, pb, pt, group, n, i = ctx.args
        B, C, _, W = g.shape
        gx = g[:, :, top:top + h].contiguous()
        rows = torch.cat([g[:, :, :top], g[:, :, top + h:]], 2)
        rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
        parts = rows.new_zeros((B, C, n * (pb + pt), W)).index_add_(
            2, index, rows)
        parts = parts.reshape(B, C, n, pb + pt, W).permute(2, 0, 1, 3, 4)
        parts = parts.contiguous()
        dist.all_reduce(parts, group=group)
        mine = parts[i]
        gx[:, :, :pb] += mine[:, :, :pb]
        gx[:, :, h - pt:] += mine[:, :, pb:]
        return gx, None, None, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              fill: str = "zeros") -> torch.Tensor:
    """NCHW ``x`` with ``top`` rows above and ``bottom`` rows below: on a
    row-splitting mesh the neighbouring blocks' rows (differentiable), and
    past the image edge ``fill`` -- "zeros" (convolutions, unfold, the
    correlation) or "edge", the edge row (the bilinear resize's clamp).
    Without a row-splitting mesh the block is the image and every halo row
    is fill."""
    if fill not in ("zeros", "edge"):
        raise ValueError(f"fill must be 'zeros' or 'edge', got {fill!r}")
    top, bottom = max(int(top), 0), max(int(bottom), 0)
    if top == bottom == 0:
        return x
    mesh = row_mesh()
    if mesh is None:
        return F.pad(x, (0, 0, top, bottom),
                     mode="constant" if fill == "zeros" else "replicate")
    return _HaloRows.apply(x, top, bottom, fill == "edge",
                           mesh.spatial_group, mesh.n_spatial,
                           mesh.spatial_rank)


class _GatherRows(torch.autograd.Function):
    """Every block of the spatial group concatenated along ``dim``; the
    backward takes this rank's rows of the cotangent summed over the
    group."""

    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.args = (dim, x.shape[dim], group, i)
        return torch.cat(list(_slots(x.contiguous(), group, n, i)), dim)

    @staticmethod
    def backward(ctx, g):
        dim, h, group, i = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g.narrow(dim, i * h, h), None, None, None, None


def all_gather_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole map from this rank's row block (rows along ``dim``: 2 for
    NCHW, 1 for NHWC), differentiable; ``x`` itself without a
    row-splitting mesh."""
    mesh = row_mesh()
    if mesh is None:
        return x
    return _GatherRows.apply(x, dim, mesh.spatial_group, mesh.n_spatial,
                             mesh.spatial_rank)


def own_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's row block of a whole map (the inverse of
    ``all_gather_rows``); ``x`` itself without a row-splitting mesh."""
    mesh = row_mesh()
    return x if mesh is None else _row_block(mesh, x, dim)


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the spatial group, differentiable with the
    cotangents summed back (the moments of a norm whose output each rank
    uses for its own rows); ``x`` without a row-splitting mesh."""
    mesh = row_mesh()
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.spatial_group)


class _TotalSum(torch.autograd.Function):
    """The sum over a group of a quantity every rank then uses alike (a
    loss's numerator, replicated downstream): the backward is the identity,
    as the cotangent of the total reaches every rank already."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def grid_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the active mesh (batch slices and
    row blocks: a global loss's sums and counts), differentiable;
    ``x`` outside a context."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return _TotalSum.apply(x, mesh.grid_group)


# ----------------------------------------------------- the layers


# a halo convolution with fewer output channels than this (the flow heads:
# 2) takes its input channels-last on the card: on the block's NCHW shapes
# cuDNN's heuristics give such convolutions FFT-class algorithms whose
# workspace (583.6 MiB for FlowNetC's 3x3 386 -> 2 head on a 26 x 160
# block, 902.5 for PWC-Net's; the whole 48 x 160 map's takes none) is more
# than the rank's activations, where channels-last takes 6-20 MiB
# (scripts/torch_spatial_conv_workspace.py, H100 80GB HBM3, 700 W)
_FEW_OUT = 8


def _halo_conv(conv, xh: torch.Tensor, out_channels: int, rows: slice):
    """``conv(xh)``'s output ``rows``, NCHW; channels-last inside where the
    convolution is on the card and has few outputs."""
    if not (xh.is_cuda and out_channels < _FEW_OUT):
        return conv(xh)[:, :, rows]
    y = conv(xh.contiguous(memory_format=torch.channels_last))
    return y[:, :, rows].contiguous()


def _spatial_geometry(module, name: str) -> tuple:
    """(kernel, stride, padding, dilation) along H of a conv, or the
    refusal."""
    if isinstance(module.padding, str) or module.padding_mode != "zeros":
        raise ValueError(f"{name}: padding {module.padding!r} / "
                         f"{module.padding_mode!r} does not shard by rows")
    return (module.kernel_size[0], module.stride[0], module.padding[0],
            module.dilation[0])


class SpatialConv2d(nn.Conv2d):
    """``nn.Conv2d`` that, under a row-splitting context, convolves its
    block with a halo of p rows above and d(k-1) - p - s + 1 below and no
    H padding (the block's first row falls on the stride); elsewhere it is
    ``nn.Conv2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = row_mesh()
        if mesh is None:
            return super().forward(x)
        k, s, p, d = _spatial_geometry(self, "SpatialConv2d")
        h = x.shape[2]
        H = h * mesh.n_spatial
        if h % s or (H + 2 * p - d * (k - 1) - 1) // s + 1 != H // s:
            raise ValueError(f"a {k}x{k} conv at stride {s}, padding {p}, "
                             f"dilation {d} does not map {h}-row blocks of "
                             f"{H} rows onto blocks")
        xh = halo_rows(x, p, d * (k - 1) - p - s + 1)
        return _halo_conv(lambda t: F.conv2d(
            t, self.weight, self.bias, self.stride, (0, self.padding[1]),
            self.dilation, self.groups), xh, self.out_channels,
            slice(0, h // s))


class SpatialConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that, under a row-splitting context,
    transposes its block with a halo of floor((d(k-1) - p) / s) rows above
    and floor((p - 1) / s) + 1 below, no H padding, and keeps the block's
    s * h output rows (the FlowNets' and PWC-Net's k=4, s=2, p=1 deconvs:
    one row each way); elsewhere it is ``nn.ConvTranspose2d``."""

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        mesh = row_mesh()
        if mesh is None:
            return super().forward(x, output_size)
        k, s, p, d = _spatial_geometry(self, "SpatialConvTranspose2d")
        h = x.shape[2]
        H = h * mesh.n_spatial
        if output_size is not None or (H - 1) * s - 2 * p + d * (k - 1) \
                + self.output_padding[0] + 1 != s * H:
            raise ValueError(f"a {k}x{k} transposed conv at stride {s}, "
                             f"padding {p} does not map {h}-row blocks onto "
                             "blocks")
        top = max((d * (k - 1) - p) // s, 0)
        xh = halo_rows(x, top, (p - 1) // s + 1)
        start = p + top * s
        return _halo_conv(lambda t: F.conv_transpose2d(
            t, self.weight, self.bias, self.stride, (0, self.padding[1]),
            (0, self.output_padding[1]), self.groups, self.dilation), xh,
            self.out_channels, slice(start, start + s * h))


def _normalised(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """x (B, C, h, W) normalised by the mean and biased variance of each
    (sample, group of C / groups channels) over the whole image: local
    sums all-reduced over the spatial group, two passes, in f32 (f64
    stays), with autograd through both collectives."""
    B, C, h, W = x.shape
    xf = x if x.dtype == torch.float64 else x.float()
    xg = xf.reshape(B, groups, C // groups * h * W)
    n = xg.shape[2] * row_mesh().n_spatial
    mean = spatial_sum(xg.sum(2)) / n
    dev = xg - mean[:, :, None]
    var = spatial_sum((dev * dev).sum(2)) / n
    return (dev * torch.rsqrt(var + eps)[:, :, None]).reshape(B, C, h, W)


class SpatialInstanceNorm2d(nn.InstanceNorm2d):
    """``nn.InstanceNorm2d`` whose moments over H x W are the whole image's
    under a row-splitting context (RAFT's fnet); with running statistics
    in eval mode it is pointwise and stays local."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if row_mesh() is None or (self.track_running_stats
                                  and not self.training):
            return super().forward(x)
        if self.track_running_stats:
            raise ValueError("a training InstanceNorm2d with running "
                             "statistics does not shard by rows")
        # the dtype the unsharded norm gives under the current autocast
        out_dtype = F.instance_norm(x[:1, :1, :2, :2]).dtype
        y = _normalised(x, x.shape[1], self.eps)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(out_dtype)


class SpatialGroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` whose moments are the whole image's under a
    row-splitting context."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if row_mesh() is None:
            return super().forward(x)
        out_dtype = F.group_norm(x[:1, :, :1, :1], self.num_groups).dtype
        y = _normalised(x, self.num_groups, self.eps)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(out_dtype)


_SWAP = {nn.Conv2d: SpatialConv2d, nn.ConvTranspose2d: SpatialConvTranspose2d,
         nn.InstanceNorm2d: SpatialInstanceNorm2d,
         nn.GroupNorm: SpatialGroupNorm}
# pointwise modules and containers: no window
_LOCAL = (nn.Sequential, nn.ModuleList, nn.ModuleDict, nn.Identity, nn.ReLU,
          nn.LeakyReLU, nn.Sigmoid, nn.Tanh)
# the port's model classes: their functional operations read the context
_PORT_MODELS = __name__.rsplit(".", 2)[0] + ".models."


def _refusal(module: nn.Module) -> Optional[str]:
    """Why ``module`` cannot run on a row block, or None when it can."""
    t = type(module)
    if isinstance(module, nn.BatchNorm2d):
        return (f"a training {t.__name__}'s statistics span the image"
                if module.training else None)
    if t in _SWAP.values() or t in _LOCAL or \
            t.__module__.startswith(_PORT_MODELS):
        return None
    return f"{t.__name__} is not known to be shard-aware"


def spatial_shard(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Make every ``nn.Conv2d``, ``nn.ConvTranspose2d``,
    ``nn.InstanceNorm2d`` and ``nn.GroupNorm`` of ``module`` its shard-aware
    subclass above, in place: the same objects, parameters and buffers,
    so state dicts load as before; outside a row-splitting context they
    compute what they did.  Eval-mode batch norm is pointwise and stays.
    Raises, changing nothing, on any other module type that is neither a
    container, a known pointwise module nor one of the port's model
    classes (whose functional operations are shard-aware).  On a mesh
    without row blocks (or none) the module is left as it is, as
    ``models.layers.global_batch_norm`` leaves it on one device; the
    layers read the mesh they run on from the context."""
    if mesh is None or mesh.n_spatial == 1:
        return module
    for name, m in module.named_modules():
        if type(m) not in _SWAP:
            why = _refusal(m)
            if why is not None:
                raise ValueError(f"spatial_shard: {name or 'the module'}: "
                                 f"{why}; it would see only its own rows")
    for m in module.modules():
        if type(m) in _SWAP:
            m.__class__ = _SWAP[type(m)]
    return module


def _guard(module: nn.Module, args) -> None:
    if row_mesh() is None:
        return
    why = _refusal(module)
    if why is not None:
        raise ValueError(f"{why} under a spatial mesh (spatial_shard the "
                         "model first); it would see only its own rows")


_HOOK = {"depth": 0, "handle": None}


@contextlib.contextmanager
def spatial_context(mesh: Optional[Mesh]):
    """Run the port's operations on ``mesh``'s blocks: the row-local ones
    exchange their halos over its spatial group and the losses sum over
    its grid.  While it splits rows, a module forward of a type that is
    not shard-aware raises.  A one-device mesh (or None) changes
    nothing."""
    if mesh is None or mesh.grid_group is None:
        yield
        return
    token = _MESH.set(mesh)
    if _HOOK["depth"] == 0:
        _HOOK["handle"] = nn.modules.module.register_module_forward_pre_hook(
            _guard)
    _HOOK["depth"] += 1
    try:
        yield
    finally:
        _HOOK["depth"] -= 1
        if _HOOK["depth"] == 0:
            _HOOK["handle"].remove()
        _MESH.reset(token)


def spatial_predict(model, mesh: Optional[Mesh]) -> Callable:
    """Spatially sharded inference (JAX ``spatial_predict``,
    parallel/spatial.py:77-105): ``spatial_shard`` the model's module once,
    then ``run(img1, img2)`` takes this rank's blocks of (B, H, W, 3)
    images in [0, 1] (``shard_rows``) and returns its block of the flow at
    the model's output resolution (H/4 for FlowNetS), the rows the
    one-device ``predict_flow`` gives for them up to float reassociation.
    The global height must divide by ``n_spatial`` times 64
    (``check_spatial_shapes``)."""
    from ..models.registry import predict_flow

    spatial_shard(model.module, mesh)

    def run(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        if img1.shape != img2.shape:
            raise ValueError(f"frames of two shapes: {tuple(img1.shape)}, "
                             f"{tuple(img2.shape)}")
        check_block_shapes(mesh, img1)
        with spatial_context(mesh):
            return predict_flow(model, img1, img2)

    return run
