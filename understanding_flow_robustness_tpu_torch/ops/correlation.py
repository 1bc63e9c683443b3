"""Correlation: RAFT's all-pairs volume, pyramid and window lookup, the
spatial correlation of the FlowNetC family and PWC-Net, and the channel
norm (counterpart of ``understanding_flow_robustness_tpu/ops/correlation.py``
and ``ops/pallas/alt_corr.py``).

RAFT's functions keep the JAX package's channels-last layouts;
``spatial_correlation`` and ``channel_norm`` take NCHW, the layout of the
convolutions around them.  ``spatial_correlation`` launches the CUDA kernel
``csrc/spatial_corr_fwd.cu`` for a CUDA tensor and runs its plain version,
``spatial_correlation_reference``, for a CPU tensor; its gradient
(``_SpatialCorrelation``) launches ``csrc/spatial_corr_bwd.cu`` for a CUDA
tensor and runs the plain version's autograd for a CPU tensor.  The JAX
package computes this correlation on XLA (banded einsums), not in Pallas.
The on-demand lookup ``alt_corr_features`` never builds the all-pairs volume on
the GPU: ``alt_corr_lookup`` launches the CUDA kernel
``csrc/alt_corr_fwd.cu`` for a CUDA tensor and runs its plain PyTorch
version, ``alt_corr_lookup_reference``, for a CPU tensor.  Its gradient
with respect to the features (``_AltCorrLookup``) launches
``csrc/alt_corr_bwd.cu`` for a CUDA tensor and runs
``alt_corr_lookup_backward_reference`` for a CPU tensor; its gradient with
respect to the coordinates launches ``csrc/alt_corr_dcoords.cu`` for a CUDA
tensor and runs ``alt_corr_coords_grad_reference`` for a CPU tensor.

The volume path builds the pyramid (``volume_pyramid``) and looks windows up
in it with ``corr_lookup``: the CUDA kernel ``csrc/corr_lookup_fwd.cu`` for a
CUDA tensor, its plain version ``corr_lookup_reference`` for a CPU tensor.
Its gradient (``_CorrLookup``) recomputes the plain version under autograd,
as the JAX package's custom_vjp recomputes its XLA formulation.

Under a row-splitting spatial mesh (``parallel/spatial.py``) the models'
entry points work on a rank's row blocks: ``spatial_correlation``
exchanges f2's halo by the whole displacement and correlates the block's
rows of f1 against it at a row offset (both kernels take one), computing
no row it does not keep; ``prepare_alt_corr`` and ``volume_pyramid``
all-gather the second frame's features, so the lookups run the block's
queries against the whole levels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from ..parallel.spatial import all_gather_rows, halo_rows, row_mesh
from ._build import LAUNCH_COUNTS, kernel_fn

# Argument limits of csrc/alt_corr_fwd.cu, csrc/alt_corr_bwd.cu,
# csrc/alt_corr_dcoords.cu and (the first two) csrc/corr_lookup_fwd.cu:
# their kMaxLevels, the radii they are instantiated for (csrc/radius.cuh:
# 1..7, the TPU kernels' r <= 7, ops/pallas/alt_corr.py:321-322) and the
# forward's bound of two 16-byte chunks of a feature row per lane (the
# backward, which takes any C, is held to what the forward takes).
_MAX_LEVELS = 8
_RADII = range(1, 8)
_MAX_CHUNKS = 2 * 32
# the shared memory a block of csrc/spatial_corr_{fwd,bwd}.cu may use (the
# H100's per-block limit)
_SPATIAL_SMEM_MAX = 232448
# the register-tiled kernels of csrc/spatial_corr_{fwd,bwd}.cu, by (patch,
# dilation): the forward's (column groups, channels a chunk); the backward
# takes 4 or 8 column groups as C asks, two output rows a block
_SPATIAL_TILES = {(21, 2): (4, 8), (9, 1): (10, 16)}


def spatial_corr_smem_bytes(patch_size: int, dilation_patch: int,
                            itemsize: int = 4):
    """(forward, backward): the bytes of shared memory a block of
    ``csrc/spatial_corr_fwd.cu`` / ``csrc/spatial_corr_bwd.cu`` takes at
    this patch and dilation for inputs of ``itemsize`` bytes, the most over
    the variants C selects.  The kernels compute the same from the same
    constants (``FwdTile::kSmem``, ``BwdTile::kSmem``, ``chunk_of``, the
    generic backward's ``launch_generic``); ``_check_spatial_args``
    refuses what exceeds the H100's per-block limit.

    (21, 2) and (9, 1) take the register-tiled kernels: a tile of G groups
    of 8 columns, a staged row of its columns and r * d more on each side,
    widened to whole 16-byte words on the left and right and padded to an
    odd number of them (``row_stride``); two buffers (the forward's: for
    each of a chunk's channels, the P f2 rows and the f1 row; the
    backward's: for each of its two output rows P
    cotangent rows, and ``128 // G * 2`` feature rows), each region
    rounded up to 128 bytes
    (TMA destinations) with 4 words of slack, or, if larger, the f32 tile
    of rows of G * 8 + 4 the sums go out through; plus 16 bytes of
    mbarriers.  Any other patch takes the
    generic kernels: the forward two buffers of (32 + P * sw) f32 a
    channel, sw = 32 + (P - 1) * d, as many channels as 32 KiB hold (1 to
    16); the backward (P + 32) f32 rows of sw."""
    P, d = patch_size, dilation_patch
    if (P, d) in _SPATIAL_TILES:
        vec = 16 // itemsize

        def up(n, k):
            return -(-n // k) * k

        def row(g):  # a staged row, elements
            reach = (P - 1) // 2 * d
            words = up(up(reach, vec) + 8 * g + reach, vec) // vec
            return vec * (words + 1 - words % 2)

        def smem(buf, tile):
            return up(max(2 * buf * itemsize, 4 * tile), 16) + 16

        g, nc = _SPATIAL_TILES[(P, d)]
        align = 128 // itemsize
        fwd = smem(up(up(nc * P * row(g), align) + nc * 8 * g + 4 * vec,
                      align), P * P * (8 * g + 4))
        bwd = max(smem(up(2 * up(P * row(g), align) + 256 // g * row(g)
                          + 4 * vec, align), 2 * 256 // g * (8 * g + 4))
                  for g in (4, 8))
        return fwd, bwd
    sw = 32 + (P - 1) * d
    per_channel = 4 * (32 + P * sw)
    chunk = min(max(32 * 1024 // per_channel, 1), 16)
    return 2 * chunk * per_channel, 4 * (P + 32) * sw


def _widen(t: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> f32; f32 and f64 stay (f64 for gradcheck)."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(B, H1, W1, C) x (B, H2, W2, C) -> (B, H1*W1, H2, W2):
    corr[b, (i, j), k, l] = <f1[b, i, j], f2[b, k, l]> / sqrt(C)
    (models/raft/corr.py:98-106), computed in f32.  The two maps share
    their size in RAFT; a spatial mesh's block of queries (f1) meets the
    whole second map."""
    B, H1, W1, C = f1.shape
    H2, W2 = f2.shape[1:3]
    a = f1.reshape(B, H1 * W1, C).float()
    b = f2.reshape(B, H2 * W2, C).float()
    corr = torch.bmm(a, b.transpose(1, 2)) / math.sqrt(C)
    return corr.reshape(B, H1 * W1, H2, W2).to(f1.dtype)


def spatial_correlation_reference(f1: torch.Tensor, f2: torch.Tensor,
                                  patch_size: int = 1,
                                  dilation_patch: int = 1,
                                  row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel ``csrc/spatial_corr_fwd.cu``, one
    multiply and one channel sum per displacement; its autograd is the
    plain version of ``csrc/spatial_corr_bwd.cu``.  NCHW f1 (B, C, H, W),
    f2 (B, C, H2, W) -> (B, P*P, H, W), P = patch_size odd, r = (P-1)//2,
    d = dilation_patch, du-major: channel pu*P + pv is <f1[:, :, y, x],
    f2[:, :, y + row0 + (pu-r)*d, x + (pv-r)*d]>, zero outside f2; not
    divided by C.  Unsharded f2 is f1's size and ``row0`` 0; a spatial
    mesh's row block correlates against its f2 with a halo of r*d rows a
    side at ``row0`` = r*d.  Products and sums in f32 (f64 stays), cast
    back to f1's dtype (``_corr_k1_band``, correlation.py:128-182).

    With an offset, f1 is placed at ``row0`` among zero rows as tall as
    f2 (and f2 given zero rows where f1 reaches past it), the whole is
    correlated and f1's rows are kept: PyTorch's CPU channel sum takes an
    order that depends on the map's size, and this one gives a row
    block's outputs the unsharded ones' order (the kernels compute only
    f1's rows)."""
    B, C, H, W = f1.shape
    H2 = f2.shape[2]
    if row0 or H2 != H:
        lo, hi = min(row0, 0), max(H2, row0 + H)
        pad = torch.nn.functional.pad
        out = spatial_correlation_reference(
            pad(f1, (0, 0, row0 - lo, hi - row0 - H)),
            pad(f2, (0, 0, -lo, hi - H2)), patch_size, dilation_patch)
        return out[:, :, row0 - lo:row0 - lo + H]
    reach = (patch_size - 1) // 2 * dilation_patch
    a = _widen(f1)
    b = torch.nn.functional.pad(_widen(f2), (reach,) * 4)
    out = a.new_empty((B, patch_size * patch_size, H, W))
    for pu in range(patch_size):
        for pv in range(patch_size):
            y0, x0 = pu * dilation_patch, pv * dilation_patch
            out[:, pu * patch_size + pv] = (
                a * b[:, :, y0:y0 + H, x0:x0 + W]).sum(1)
    return out.to(f1.dtype)


def _check_spatial_args(name, f1, f2, patch_size, dilation_patch, row0=0):
    """Raise on what csrc/spatial_corr_{fwd,bwd}.cu do not take."""
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise TypeError(f"{name} takes f32 or bf16 features of one dtype, got "
                        f"{f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f2.dim() != 4 or f1.shape[:2] != f2.shape[:2] \
            or f1.shape[3] != f2.shape[3]:
        raise ValueError(f"{name} takes f1 (B, C, H, W) and f2 (B, C, H2, W),"
                         f" got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if abs(row0) > 65535 or f2.shape[2] > 65535:
        raise ValueError(f"{name}: row offset {row0} or f2's {f2.shape[2]} "
                         "rows exceed the kernel's grid")
    if patch_size < 1 or patch_size % 2 == 0 or dilation_patch < 1:
        raise ValueError(f"{name} takes an odd patch_size and "
                         f"dilation_patch >= 1, got {patch_size}, "
                         f"{dilation_patch}")
    smem = max(spatial_corr_smem_bytes(patch_size, dilation_patch,
                                       f1.element_size()))
    if smem > _SPATIAL_SMEM_MAX or f1.shape[2] > 65535 \
            or f1.shape[0] > 65535:
        raise ValueError(f"{name}: patch {patch_size} at dilation "
                         f"{dilation_patch} (or B, H = {f1.shape[0]}, "
                         f"{f1.shape[2]}) exceeds the kernel's shared memory "
                         "or grid")
    for t in (f1, f2):
        if t.device != f1.device or t.device.type != "cuda":
            raise ValueError(f"{name} inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous")


def _spatial_corr_fwd_cuda(f1: torch.Tensor, f2: torch.Tensor,
                           patch_size: int, dilation_patch: int,
                           row0: int = 0) -> torch.Tensor:
    """Launch csrc/spatial_corr_fwd.cu: (B, P*P, H, W) in f1's dtype, f1's
    rows against f2's (B, C, H2, W) at the row offset ``row0``
    (``spatial_correlation_reference``)."""
    import ctypes

    _check_spatial_args("spatial_corr_fwd", f1, f2, patch_size,
                        dilation_patch, row0)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("spatial_corr_fwd", "ufr_spatial_corr_fwd",
                        [vp, vp, vp] + [i32] * 9 + [vp])
    B, C, H, W = f1.shape
    out = torch.empty((B, patch_size ** 2, H, W), device=f1.device,
                      dtype=f1.dtype)
    if out.numel() == 0 or C == 0:
        return out.zero_()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W,
                 f2.shape[2], row0, patch_size, dilation_patch,
                 int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("spatial_corr_fwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["spatial_corr_fwd"] += 1
    return out


def _spatial_corr_bwd_cuda(f1: torch.Tensor, f2: torch.Tensor,
                           g: torch.Tensor, patch_size: int,
                           dilation_patch: int, want=(True, True),
                           row0: int = 0):
    """Launch csrc/spatial_corr_bwd.cu: (df1, df2), each its input's shape
    ((B, C, H, W) and (B, C, H2, W)) in the inputs' dtype (summed in f32),
    or None where ``want`` says it is not needed; g: (B, P*P, H, W)
    contiguous, in the inputs' dtype; ``row0``: the forward's row offset.
    One launch computes both."""
    import ctypes

    _check_spatial_args("spatial_corr_bwd", f1, f2, patch_size,
                        dilation_patch, row0)
    B, C, H, W = f1.shape
    if g.dtype != f1.dtype or tuple(g.shape) != (
            B, patch_size ** 2, H, W) or g.device != f1.device \
            or not g.is_contiguous():
        raise ValueError(f"g must be contiguous {f1.dtype} (B, P*P, H, W) = "
                         f"({B}, {patch_size ** 2}, {H}, {W}) on {f1.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("spatial_corr_bwd", "ufr_spatial_corr_bwd",
                        [vp] * 5 + [i32] * 9 + [vp])
    grads = [torch.empty_like(t) if w else None for t, w in zip((f1, f2),
                                                                 want)]
    if f1.numel() == 0 or not any(want):
        return tuple(grads)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), g.data_ptr(),
                 *[None if t is None else t.data_ptr() for t in grads],
                 B, C, H, W, f2.shape[2], row0, patch_size, dilation_patch,
                 int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("spatial_corr_bwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["spatial_corr_bwd"] += 1
    return tuple(grads)


def _spatial_corr(f1, f2, patch_size, dilation_patch, row0=0):
    """The forward: the plain version for CPU tensors, the kernel for CUDA
    tensors (on both inputs in their common dtype), f1's dtype out."""
    if f1.device.type == "cpu":
        return spatial_correlation_reference(f1, f2, patch_size,
                                             dilation_patch, row0)
    if f1.device.type != "cuda":
        raise ValueError(f"spatial_correlation: unsupported device "
                         f"{f1.device}")
    dtype = torch.promote_types(f1.dtype, f2.dtype)
    out = _spatial_corr_fwd_cuda(f1.to(dtype).contiguous(),
                                 f2.to(dtype).contiguous(), patch_size,
                                 dilation_patch, row0)
    return out.to(f1.dtype)


class _SpatialCorrelation(torch.autograd.Function):
    """The spatial correlation with its gradient into both feature maps:
    the kernels ``csrc/spatial_corr_fwd.cu`` / ``csrc/spatial_corr_bwd.cu``
    for CUDA tensors, the plain version and its autograd for CPU tensors
    (the JAX package differentiates its einsums with XLA's autodiff).
    Gradients come back in each input's dtype, summed in f32."""

    @staticmethod
    def forward(ctx, f1, f2, patch_size, dilation_patch, row0):
        ctx.args = (patch_size, dilation_patch, row0)
        ctx.save_for_backward(f1, f2)
        return _spatial_corr(f1, f2, patch_size, dilation_patch, row0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        want = ctx.needs_input_grad[:2]
        if f1.device.type == "cpu":
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(w) for t, w in zip((f1, f2),
                                                                     want)]
                out = spatial_correlation_reference(*ins, *ctx.args)
                grads = iter(torch.autograd.grad(
                    out, [t for t in ins if t.requires_grad], g))
            df1, df2 = (next(grads) if w else None for w in want)
        else:
            dtype = torch.promote_types(f1.dtype, f2.dtype)
            patch_size, dilation_patch, row0 = ctx.args
            df1, df2 = _spatial_corr_bwd_cuda(
                f1.to(dtype).contiguous(), f2.to(dtype).contiguous(),
                g.to(dtype).contiguous(), patch_size, dilation_patch,
                want=want, row0=row0)
        return (None if df1 is None else df1.to(f1.dtype),
                None if df2 is None else df2.to(f2.dtype), None, None, None)


def spatial_correlation(f1: torch.Tensor, f2: torch.Tensor,
                        patch_size: int = 1, kernel_size: int = 1,
                        stride: int = 1, padding: int = 0,
                        dilation: int = 1, dilation_patch: int = 1,
                        plain: bool = False) -> torch.Tensor:
    """Spatial correlation sampling, NCHW (the JAX package's
    ``spatial_correlation``, correlation.py:56-103; the
    spatial-correlation-sampler op): f1, f2 (B, C, H, W) -> (B, P*P, H, W)
    in f1's dtype, du-major, zero outside, not divided by C (callers divide
    by C); ``spatial_correlation_reference`` says what it computes.

    Kernel 1, stride 1, padding 0 (every reference model's configuration):
    the CUDA kernel ``csrc/spatial_corr_fwd.cu`` for CUDA tensors, the
    plain version for CPU tensors; any other device raises.  Differentiable
    in f1 and f2 through ``_SpatialCorrelation`` (the backward kernel
    ``csrc/spatial_corr_bwd.cu`` on the card).  Any other kernel size,
    stride or padding takes ``spatial_correlation_general``, plain PyTorch
    on every device, as the JAX package computes it in XLA
    (correlation.py:203-255); no reference model uses it.  ``plain``: the
    plain version (and its autograd) on every device.

    Under a row-splitting spatial mesh f1 and f2 are a rank's row blocks:
    f2 gets a halo of the whole vertical displacement (P-1)/2 * d rows a
    side from the blocks that hold them (zeros past the image, the
    kernel's bounds), and the block's h rows of f1 are correlated against
    it at the row offset (P-1)/2 * d: the block's rows of the unsharded
    result, each the same channel sum in the same order.  The gradient
    into the halo rows goes back to their owners (``halo_rows``)."""
    if (kernel_size, stride, padding) != (1, 1, 0):
        if row_mesh() is not None:
            raise ValueError("spatial_correlation: only kernel 1, stride 1, "
                             "padding 0 shards by rows")
        return spatial_correlation_general(f1, f2, patch_size, kernel_size,
                                           stride, padding, dilation,
                                           dilation_patch)
    row0 = 0
    if row_mesh() is not None:
        row0 = (patch_size - 1) // 2 * dilation_patch
        f2 = halo_rows(f2, row0, row0)
    if plain:
        return spatial_correlation_reference(f1, f2, patch_size,
                                             dilation_patch, row0)
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return _SpatialCorrelation.apply(f1, f2, patch_size, dilation_patch,
                                         row0)
    return _spatial_corr(f1, f2, patch_size, dilation_patch, row0)


def spatial_correlation_general(f1: torch.Tensor, f2: torch.Tensor,
                                patch_size: int, kernel_size: int,
                                stride: int, padding: int, dilation: int,
                                dilation_patch: int) -> torch.Tensor:
    """The spatial correlation with any kernel size, stride, padding and
    dilation (the JAX package's ``_spatial_correlation_general``,
    correlation.py:203-255; correlation.cpp:75-124), NCHW: f1, f2 (B, C,
    H, W) -> (B, P*P, oH, oW), oH = (H + 2 padding - ((k-1) dilation + 1))
    // stride + 1.  Per displacement (du-major), the channel sum of f1 times
    f2 shifted by ((pu-r) d, (pv-r) d), zero outside, then summed over the
    k x k (dilated) kernel window of the zero-padded product map with the
    output stride.  Products and sums in f32, cast back to f1's dtype;
    differentiable through autograd.  Plain PyTorch on every device."""
    B, C, H, W = f1.shape
    rad = (patch_size - 1) // 2
    dil_k = (kernel_size - 1) * dilation + 1
    oH = (H + 2 * padding - dil_k) // stride + 1
    oW = (W + 2 * padding - dil_k) // stride + 1
    if oH < 1 or oW < 1:
        raise ValueError(f"spatial_correlation: a {kernel_size}x"
                         f"{kernel_size} kernel at dilation {dilation} does "
                         f"not fit ({H}x{W} padded by {padding})")
    reach = rad * dilation_patch
    a = f1.float()
    b = torch.nn.functional.pad(f2.float(), (reach,) * 4)
    outs = []
    for pu in range(patch_size):
        for pv in range(patch_size):
            y0, x0 = pu * dilation_patch, pv * dilation_patch
            prod = (a * b[:, :, y0:y0 + H, x0:x0 + W]).sum(1)  # (B, H, W)
            prod = torch.nn.functional.pad(prod, (padding,) * 4)
            acc = 0
            for ki in range(kernel_size):
                for kj in range(kernel_size):
                    i0, j0 = ki * dilation, kj * dilation
                    acc = acc + prod[:, i0:i0 + (oH - 1) * stride + 1:stride,
                                     j0:j0 + (oW - 1) * stride + 1:stride]
            outs.append(acc)
    return torch.stack(outs, dim=1).to(f1.dtype)


def channel_norm(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-pixel L2 norm over channels, NCHW (B, C, H, W) -> (B, 1, H, W),
    squares summed in f32 and cast back to x's dtype (the JAX package's
    ``channel_norm``, correlation.py:962-970; the ChannelNorm CUDA op with
    norm_deg 2).  Plain PyTorch: an elementwise pass and a channel sum."""
    sq = _widen(x).square().sum(dim=1, keepdim=True)
    return torch.sqrt(sq + eps).to(x.dtype)


def corr_pyramid(corr: torch.Tensor, num_levels: int = 4) -> list:
    """Average-pool pyramid over the target dims of (B, N, H2, W2)
    (models/raft/corr.py:60-64): odd sizes drop their trailing row or
    column; row pairs, then column pairs, then x0.25 — the association of
    ``pool_fmap_levels``."""
    pyr = [corr]
    x = corr
    for _ in range(num_levels - 1):
        h2, w2 = x.shape[2] // 2, x.shape[3] // 2
        x = x[:, :, : 2 * h2, : 2 * w2]
        rows = x[:, :, 0::2, :] + x[:, :, 1::2, :]
        x = (rows[..., 0::2] + rows[..., 1::2]) * 0.25
        pyr.append(x)
    return pyr


def pool_fmap_levels(f2: torch.Tensor, num_levels: int) -> list:
    """(B, H, W, C) feature map -> its 2^l average-pooled levels, with
    ``corr_pyramid``'s floor semantics and association.  By linearity of
    the correlation in f2, correlating against level l equals pooling the
    volume's target dims l times."""
    levels = [f2]
    x = f2
    for _ in range(num_levels - 1):
        h2, w2 = x.shape[1] // 2, x.shape[2] // 2
        x = x[:, : 2 * h2, : 2 * w2]
        rows = x[:, 0::2] + x[:, 1::2]
        x = (rows[:, :, 0::2] + rows[:, :, 1::2]) * 0.25
        levels.append(x)
    return levels


def _grid_taps(vol: torch.Tensor, centers: torch.Tensor, radius: int):
    """The (2r+2)^2 integer-grid values around each window and the window's
    fractional offset.

    vol: (M, Hl, Wl); centers: (M, 2) as (x, y) in level pixels.  Returns
    (g (M, 2r+2, 2r+2) with g[m, i, j] the value at (floor(y) - r + i,
    floor(x) - r + j), zero outside the level, widened to f32 (f64 stays);
    ax (M,), ay (M,) the fractions x - floor(x), y - floor(y))."""
    M, Hl, Wl = vol.shape
    r = radius
    n = 2 * r + 1
    if Hl * Wl == 0:
        # an empty level (RAFT's fourth below 64 px): every tap lies
        # outside it, as in the JAX package's volume lookup
        cx, cy = _widen(centers[:, 0]), _widen(centers[:, 1])
        g = torch.zeros((M, n + 1, n + 1), dtype=cx.dtype, device=vol.device)
        return g, cx - torch.floor(cx), cy - torch.floor(cy)
    # far-out centres are clamped to where the whole window is still out
    # of the volume, so the float->int conversion cannot overflow
    cx = _widen(centers[:, 0]).clamp(-(r + 2.0), Wl + r + 1.0)
    cy = _widen(centers[:, 1]).clamp(-(r + 2.0), Hl + r + 1.0)
    fx, fy = torch.floor(cx), torch.floor(cy)
    offs = torch.arange(-r, r + 2, device=vol.device)
    xs = fx.long()[:, None] + offs  # (M, n+1)
    ys = fy.long()[:, None] + offs
    inside = (((ys >= 0) & (ys < Hl))[:, :, None]
              & ((xs >= 0) & (xs < Wl))[:, None, :])
    idx = ys.clamp(0, Hl - 1)[:, :, None] * Wl + xs.clamp(0, Wl - 1)[:, None, :]
    # gather, then widen: only the taps are converted, not the volume
    g = _widen(vol.reshape(M, Hl * Wl).gather(1, idx.reshape(M, -1)))
    return g.reshape(M, n + 1, n + 1) * inside, cx - fx, cy - fy


def _window_sample(vol: torch.Tensor, centers: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Bilinear (2r+1)^2 window around each centre, zeros outside.

    vol: (M, Hl, Wl); centers: (M, 2) as (x, y) in level pixels,
    align_corners=True (no half-pixel shift).  Returns (M, (2r+1)^2) f32 in
    the reference's s-major order: channel s*(2r+1) + t samples
    (x - r + s, y - r + t) (models/raft/corr.py:79-85).  All taps of a
    window share one fractional offset, so the window is a blend of the
    (2r+2)^2 integer-grid values around it."""
    M = vol.shape[0]
    n = 2 * radius + 1
    g, ax, ay = _grid_taps(vol, centers, radius)  # g[m, i, j]: (y0+i, x0+j)
    ax, ay = ax[:, None, None], ay[:, None, None]
    samp = ((1 - ax) * (1 - ay) * g[:, :-1, :-1] + ax * (1 - ay) * g[:, :-1, 1:]
            + (1 - ax) * ay * g[:, 1:, :-1] + ax * ay * g[:, 1:, 1:])  # [m, t, s]
    return samp.transpose(1, 2).reshape(M, n * n)


def volume_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int,
                   dtype: Optional[torch.dtype] = None) -> list:
    """RAFT's volume path from (B, H, W, C) fmaps (raft_model.py:867-874):
    the all-pairs volume as one f32 ``bmm`` outside autocast (under autocast
    it would run on bf16 inputs, which the JAX package does not do), divided
    by sqrt(C), cast once to ``dtype`` (bf16 under mixed precision; the f32
    volume is freed there unless autograd keeps it) and pooled in that dtype
    with ``corr_pyramid``'s association.  Returns the levels (B, H*W, Hl,
    Wl), each a new contiguous tensor, as ``corr_lookup``'s kernel reads
    them.  Under a row-splitting spatial mesh fmap1 is this rank's block of
    queries and fmap2 is all-gathered: (B, h*W, Hl, Wl)."""
    with torch.autocast(fmap1.device.type, enabled=False):
        corr = all_pairs_correlation(fmap1.float(),
                                     all_gather_rows(fmap2.float(), 1))
    if dtype is not None:
        corr = corr.to(dtype)
    return corr_pyramid(corr, num_levels)


def corr_lookup_reference(pyramid: Sequence[torch.Tensor],
                          coords: torch.Tensor, radius: int = 4
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel ``csrc/corr_lookup_fwd.cu``: the
    radius-r window lookup into a correlation pyramid (CorrBlock,
    models/raft/corr.py:72-96).  pyramid[l]: (B, H1*W1, Hl, Wl) f32 or bf16
    (bf16 taps are widened to f32); coords: (B, H1, W1, 2) level-0 (x, y).
    Returns (B, H1, W1, L*(2r+1)^2) f32, level l centred at coords / 2^l,
    s-major per level.  Differentiable in the pyramid and the coords."""
    B, H1, W1, _ = coords.shape
    c = coords.reshape(B * H1 * W1, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        vol = corr.reshape(B * H1 * W1, corr.shape[2], corr.shape[3])
        out.append(_window_sample(vol, c / 2 ** lvl, radius))
    return torch.cat(out, dim=-1).reshape(B, H1, W1, -1)


def _corr_lookup_fwd(pyramid, coords, radius):
    device = pyramid[0].device
    if device.type == "cpu":
        return corr_lookup_reference(pyramid, coords, radius)
    if device.type != "cuda":
        raise ValueError(f"corr_lookup: unsupported device {device}")
    # the kernel's (B*N, ...) views of the layouts (no copy when contiguous)
    B, H1, W1, _ = coords.shape
    BN = B * H1 * W1
    levels = [p.reshape(BN, p.shape[2], p.shape[3]) for p in pyramid]
    out = corr_lookup_fwd(_live_levels(levels), coords.reshape(BN, 2), radius)
    return _zero_taps(out, len(levels), radius).reshape(B, H1, W1, -1)


class _CorrLookup(torch.autograd.Function):
    """The volume lookup with its gradient (the JAX package's
    ``_corr_lookup_pallas_vjp``, ops/correlation.py:343-365): the forward
    is the kernel (or, on the CPU, the plain version), the backward
    recomputes the plain version under autograd and differentiates it with
    respect to the pyramid and the coords.  No backward kernel, in either
    package."""

    @staticmethod
    def forward(ctx, radius, coords, *pyramid):
        ctx.radius = radius
        ctx.save_for_backward(coords, *pyramid)
        return _corr_lookup_fwd(pyramid, coords, radius)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(saved, needs)]
            out = corr_lookup_reference(ins[1:], ins[0], ctx.radius)
            wanted = [t for t in ins if t.requires_grad]
            # an empty level takes no part in the output: zeros
            grads = iter(torch.zeros_like(t) if d is None else d
                         for t, d in zip(wanted, torch.autograd.grad(
                             out, wanted, g, allow_unused=True)))
        return (None, *[next(grads) if t.requires_grad else None
                        for t in ins])


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Radius-r window lookup into a correlation pyramid (the JAX package's
    ``corr_lookup``, ops/correlation.py:296-365): the CUDA kernel
    ``csrc/corr_lookup_fwd.cu`` for CUDA tensors, its plain version
    ``corr_lookup_reference`` for CPU tensors; any other device raises.

    pyramid[l]: (B, H1*W1, Hl, Wl) f32 or bf16; coords: (B, H1, W1, 2)
    level-0 (x, y) f32.  Returns (B, H1, W1, L*(2r+1)^2) f32 in the
    reference's compact s-major layout.  Without autograd this is one
    launch; with it the lookup runs through ``_CorrLookup``, whose backward
    is the plain version's."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (coords, *pyramid)):
        return _CorrLookup.apply(radius, coords, *pyramid)
    return _corr_lookup_fwd(pyramid, coords, radius)


def alt_corr_lookup_reference(f1: torch.Tensor, levels: Sequence[torch.Tensor],
                              coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel ``csrc/alt_corr_fwd.cu``.

    f1: (B, N, C), already scaled by 1/sqrt(C); levels[l]: (B, Hl, Wl, C)
    pooled fmap2; coords: (B, N, 2) level-0 (x, y) centres, f32.  Builds
    each level's volume <f1, level> in f32 and samples its windows.
    Returns (B, N, L*(2r+1)^2) f32, s-major per level."""
    B, N, C = f1.shape
    a = _widen(f1)
    c = coords.reshape(B * N, 2)
    out = []
    for lvl, f2 in enumerate(levels):
        Hl, Wl = f2.shape[1], f2.shape[2]
        vol = torch.bmm(a, _widen(f2.reshape(B, Hl * Wl, C)).transpose(1, 2))
        out.append(_window_sample(vol.reshape(B * N, Hl, Wl), c / 2 ** lvl,
                                  radius))
    return torch.cat(out, dim=-1).reshape(B, N, -1)


def alt_corr_lookup_backward_reference(f1: torch.Tensor,
                                       levels: Sequence[torch.Tensor],
                                       coords: torch.Tensor, g: torch.Tensor,
                                       radius: int = 4):
    """Plain PyTorch version of the kernel ``csrc/alt_corr_bwd.cu``: the
    gradient of ``alt_corr_lookup_reference`` with respect to f1 and the
    levels for the output cotangent g (B, N, L*(2r+1)^2), by autograd on
    f32 copies of the same values (bf16 values upcast, as the plain
    forward reads them).  Returns (df1 (B, N, C), (dlevels[l] (B, Hl, Wl,
    C), ...)), f32."""
    with torch.enable_grad():
        a = _widen(f1.detach()).requires_grad_()
        lv = [_widen(lvl.detach()).requires_grad_() for lvl in levels]
        out = alt_corr_lookup_reference(a, lv, coords.detach(), radius)
        # an empty level (no rows or columns) takes no part in the output
        grads = torch.autograd.grad(out, [a, *lv], g.to(out.dtype),
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip([a, *lv], grads)]
    return grads[0], tuple(grads[1:])


def _sign_hat_selectors(frac: torch.Tensor, radius: int, dtype):
    """Per window: the ordinary hats and their coordinate derivatives over
    the 2r+2 grid points of one axis, (hat, dhat) each (M, 2r+1, 2r+2).

    Sample k of the window lies at floor(c) - r + k + frac and grid point j
    at floor(c) - r + j, so their difference is d = (j - k) - frac; the hat
    is relu(1 - |d|) and its derivative with respect to c is sign(d) on
    the open support |d| < 1 (ops/pallas/alt_corr.py:75-86).  d is formed
    in f64, where it is exact for every f32 fraction that is not tiny."""
    n = 2 * radius + 1
    k = torch.arange(n, device=frac.device, dtype=torch.float64)
    j = torch.arange(n + 1, device=frac.device, dtype=torch.float64)
    d = (j[None, :] - k[:, None])[None] - frac.double()[:, None, None]
    hat = torch.clamp(1.0 - d.abs(), min=0.0)
    dhat = torch.sign(d) * (d.abs() < 1.0)
    return hat.to(dtype), dhat.to(dtype)


def alt_corr_coords_grad_reference(f1: torch.Tensor,
                                   levels: Sequence[torch.Tensor],
                                   coords: torch.Tensor, g: torch.Tensor,
                                   radius: int = 4) -> torch.Tensor:
    """Plain PyTorch version of the kernel ``csrc/alt_corr_dcoords.cu``: the
    gradient of ``alt_corr_lookup_reference`` with respect to the coords,
    for the output cotangent g (B, N, L*(2r+1)^2), as the TPU kernel B3
    (``_alt_corr_kernel`` with deriv="x"/"y") defines it.

    Builds each level's f32 volume as ``alt_corr_lookup_reference`` does
    and, for the x derivative, replaces the column hat of every window
    sample by sign(grid - sample) on the open support |grid - sample| < 1
    (the row hat stays); the y derivative is symmetric.  Each level's
    window derivatives are contracted with its 81 cotangents (s-major) and
    summed over the levels with the chain factor 2^-l.  Where a window's
    fraction on an axis is 0 (an exactly integer centre, as at RAFT's
    first iteration) that axis's derivative is 0, as in B3; autograd
    through the floor-based sampler would give the forward difference
    there instead, so this is not autograd.  Returns (B, N, 2) f32 (f64
    for f64 inputs)."""
    B, N, C = f1.shape
    n = 2 * radius + 1
    a = _widen(f1)
    c = coords.reshape(B * N, 2).to(a.dtype)
    gl = g.reshape(B * N, len(levels), n, n).to(a.dtype)  # [m, l, s, t]
    dc = a.new_zeros((B * N, 2))
    for lvl, f2 in enumerate(levels):
        Hl, Wl = f2.shape[1], f2.shape[2]
        vol = torch.bmm(a, _widen(f2.reshape(B, Hl * Wl, C)).transpose(1, 2))
        taps, ax, ay = _grid_taps(vol.reshape(B * N, Hl, Wl), c / 2 ** lvl,
                                  radius)  # taps[m, i, j]: (y0 + i, x0 + j)
        hx, dhx = _sign_hat_selectors(ax, radius, a.dtype)  # [m, s, j]
        hy, dhy = _sign_hat_selectors(ay, radius, a.dtype)  # [m, t, i]
        dx = torch.einsum("mti,mij,msj->mst", hy, taps, dhx)
        dy = torch.einsum("mti,mij,msj->mst", dhy, taps, hx)
        w = gl[:, lvl] * 2.0 ** -lvl
        dc = dc + torch.stack([(w * dx).sum((1, 2)), (w * dy).sum((1, 2))], -1)
    return dc.reshape(B, N, 2)


def prepare_alt_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int,
                     compute_dtype: Optional[torch.dtype] = None):
    """Once per forward: (B, H, W, C) fmaps -> (f1 (B, N, C) scaled by
    1/sqrt(C), pooled fmap2 levels (B, Hl, Wl, C)), pooled in f32 and then
    cast to ``compute_dtype`` (ops/pallas/alt_corr.py:521-528); all
    contiguous, as the kernel reads them.  Scaling and pooling are plain
    autograd ops, so the gradients ``alt_corr_lookup`` returns for f1 and
    the levels reach the fmaps through their autograd transposes.  Under
    a row-splitting spatial mesh f1 is this rank's block of queries and
    fmap2 is all-gathered first: the levels are the whole map's, bit for
    bit, for any level count."""
    B, H, W, C = fmap1.shape
    fmap2 = all_gather_rows(fmap2, 1)
    f1 = (_widen(fmap1) * (1.0 / math.sqrt(C))).reshape(B, H * W, C)
    levels = pool_fmap_levels(_widen(fmap2), num_levels)
    if compute_dtype is not None:
        f1 = f1.to(compute_dtype)
        levels = [lvl.to(compute_dtype) for lvl in levels]
    return f1.contiguous(), tuple(lvl.contiguous() for lvl in levels)


def alt_corr_kernel_inputs(f1: torch.Tensor, levels: Sequence[torch.Tensor],
                           dtype: torch.dtype):
    """Detached contiguous copies of prepared f1 and levels in the dtype the
    kernels read, made once per forward and shared by every lookup of it
    (the ``kernel_inputs`` of ``alt_corr_lookup``)."""
    return (f1.detach().to(dtype).contiguous(),
            tuple(lvl.detach().to(dtype).contiguous() for lvl in levels))


class _AltCorrLookup(torch.autograd.Function):
    """The lookup with its gradients (the JAX package's ``_alt_corr_vjp``,
    ops/correlation.py:659-692, 695-780).

    Differentiable inputs: the coords, and f1 and the levels as prepared
    (f32 on the model's path).  The kernels read ``kernel_inputs``, their
    detached copies in the compute dtype, and the gradients go back to f1
    and the levels in f32, never rounded to bf16 -- where JAX also puts its
    custom_vjp.  The backward computes only what ``needs_input_grad``
    asks for: the feature gradient (B2) when f1 or a level requires grad,
    the coordinate gradient (B3) when the coords do.  Saved for the
    backward: those copies and the coords, the same tensors for every
    iteration of a forward, never the output."""

    @staticmethod
    def forward(ctx, radius, num_levels, coords, kf1, *rest):
        klevels = rest[:num_levels]
        ctx.radius = radius
        ctx.num_levels = num_levels
        ctx.save_for_backward(coords, kf1, *klevels)
        return _lookup(kf1, klevels, coords, radius)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coords, kf1, *klevels = ctx.saved_tensors
        L = ctx.num_levels
        cpu = kf1.device.type == "cpu"
        if not cpu:
            # the kernels read the live levels and their channels of g
            live = _live_levels(klevels)
            g = g[..., :len(live) * (2 * ctx.radius + 1) ** 2]
            g = g.float().contiguous()
        dcoords = None
        if ctx.needs_input_grad[2]:
            if cpu:
                dcoords = alt_corr_coords_grad_reference(
                    kf1, klevels, coords, g, ctx.radius)
            else:
                dcoords = _alt_corr_dcoords_cuda(kf1, live, coords, g,
                                                 ctx.radius)
            dcoords = dcoords.to(coords.dtype)
        dfeats = (None,) * (1 + L)
        if any(ctx.needs_input_grad[4 + L:]):
            if cpu:
                df1, dlevels = alt_corr_lookup_backward_reference(
                    kf1, klevels, coords, g, ctx.radius)
            else:
                df1, dlevels = _alt_corr_bwd_cuda(kf1, live, coords, g,
                                                  ctx.radius)
                dlevels += tuple(torch.zeros(lvl.shape, device=lvl.device)
                                 for lvl in klevels[len(live):])
            dfeats = (df1, *dlevels)
        return (None, None, dcoords, None) + (None,) * L + dfeats


def _live_levels(levels) -> tuple:
    """The leading levels with at least one row and column (and at least
    the first), the ones the kernels are passed.  Pooling floors, so every
    level after an empty one is empty: RAFT's fourth below 64 px.  Every
    window of an empty level lies outside it, so its taps are zeros and
    its gradient is zero, as in the JAX package."""
    n = 1
    while n < len(levels) and levels[n].shape[1] * levels[n].shape[2]:
        n += 1
    return tuple(levels[:n])


def _zero_taps(out, L, radius):
    """A kernel's taps (..., live*(2r+1)^2) zero-extended to L levels."""
    k = L * (2 * radius + 1) ** 2
    if out.shape[-1] == k:
        return out
    return torch.cat([out, out.new_zeros(out.shape[:-1] + (k - out.shape[-1],))],
                     dim=-1)


def _lookup(f1, levels, coords, radius):
    if f1.device.type == "cpu":
        return alt_corr_lookup_reference(f1, levels, coords, radius)
    if f1.device.type != "cuda":
        raise ValueError(f"alt_corr_lookup: unsupported device {f1.device}")
    out = _alt_corr_lookup_cuda(f1, _live_levels(levels), coords, radius)
    return _zero_taps(out, len(levels), radius)


def alt_corr_lookup(f1: torch.Tensor, levels: Sequence[torch.Tensor],
                    coords: torch.Tensor, radius: int = 4,
                    kernel_inputs=None) -> torch.Tensor:
    """The lookup of ``alt_corr_features`` from prepared inputs
    (``prepare_alt_corr``): the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors.

    ``kernel_inputs``: (f1, levels) copies in the dtype the kernels read
    (``alt_corr_kernel_inputs``); by default f1 and levels themselves.
    Without autograd (``no_grad``/``inference_mode``, or no input that
    requires grad) this is one forward launch.  Otherwise the lookup runs
    through ``_AltCorrLookup``: its backward returns f32 gradients to f1
    and the levels, and to the coords when they require grad (JAX's
    ``coords_grad=True``; RAFT detaches its coords every iteration, which
    is JAX's ``coords_grad=False``)."""
    kf1, klevels = kernel_inputs if kernel_inputs is not None else (
        f1, tuple(levels))
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (coords, f1, *levels))):
        return _lookup(kf1, klevels, coords, radius)
    return _AltCorrLookup.apply(
        radius, len(levels), coords, kf1.detach(),
        *[lvl.detach() for lvl in klevels], f1, *levels)


def alt_corr_features(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      coords: torch.Tensor, num_levels: int = 4,
                      radius: int = 4,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Correlation-pyramid window lookup straight from the feature maps
    (the reference's alt_cuda_corr, models/raft/corr.py:109-137).

    fmap1, fmap2: (B, H, W, C); coords: (B, H, W, 2) level-0 (x, y).
    Returns (B, H, W, L*(2r+1)^2) f32 in the reference's compact s-major
    layout, value-equal to ``corr_lookup(corr_pyramid(
    all_pairs_correlation(fmap1, fmap2)), coords)``.  Differentiable in the
    fmaps and the coords: the kernels read ``compute_dtype`` copies and
    the gradients stay f32."""
    B, H, W, _ = fmap1.shape
    f1, levels = prepare_alt_corr(fmap1, fmap2, num_levels)
    kin = (alt_corr_kernel_inputs(f1, levels, compute_dtype)
           if compute_dtype is not None else None)
    out = alt_corr_lookup(f1, levels, coords.reshape(B, H * W, 2), radius,
                          kin)
    return out.reshape(B, H, W, -1)


def _check_kernel_args(name, f1, levels, coords, radius):
    """Raise on what csrc/alt_corr_{fwd,bwd,dcoords}.cu do not take."""
    B, N, C = f1.shape
    L = len(levels)
    vec = 16 // f1.element_size()
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 features, got {f1.dtype}")
    if coords.dtype != torch.float32 or tuple(coords.shape) != (B, N, 2):
        raise ValueError(f"coords must be f32 (B, N, 2) = ({B}, {N}, 2), got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    if not 1 <= L <= _MAX_LEVELS or radius not in _RADII:
        raise ValueError(f"{name} takes 1..{_MAX_LEVELS} levels and "
                         f"radius {_RADII[0]}..{_RADII[-1]}, got {L} and "
                         f"{radius}")
    if C % vec or C // vec > _MAX_CHUNKS:
        raise ValueError(f"{name} takes C a multiple of {vec} up to "
                         f"{vec * _MAX_CHUNKS} for {f1.dtype}, got {C}")
    for t in (f1, coords, *levels):
        if t.device != f1.device:
            raise ValueError(f"{name} inputs must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} inputs must be contiguous and "
                             "16-byte aligned")
    for lvl in levels:
        if lvl.dtype != f1.dtype or lvl.dim() != 4 or lvl.shape[0] != B \
                or lvl.shape[3] != C:
            raise ValueError(f"each level must be {f1.dtype} (B, Hl, Wl, C), "
                             f"got {lvl.dtype} {tuple(lvl.shape)}")
        if B * N and not lvl.shape[1] * lvl.shape[2]:
            raise ValueError(f"{name} takes no empty level (alt_corr_lookup "
                             "passes only the live ones)")


def _level_args(levels):
    import ctypes

    L = len(levels)
    ptrs = (ctypes.c_void_p * L)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * L))(
        *[d for lvl in levels for d in (lvl.shape[1], lvl.shape[2])])
    return ptrs, hw


def _check_path_counts(path_counts, L, device):
    """Raise on a path counter csrc/alt_corr_{fwd,bwd,dcoords}.cu do not
    take."""
    if path_counts is not None and (
            path_counts.dtype != torch.int32 or path_counts.numel() != 2 * L
            or path_counts.device != device
            or not path_counts.is_contiguous()):
        raise ValueError(f"path_counts must be a contiguous int32 tensor of "
                         f"{2 * L} on {device}")


def _alt_corr_lookup_cuda(f1, levels, coords, radius, path_counts=None):
    """Launch csrc/alt_corr_fwd.cu: (B, N, L*(2r+1)^2) f32, one launch for
    every level.  ``path_counts``: None, or a zeroed int32 CUDA tensor of
    2*L that the kernel adds to: [l] the (8x8 tile, level) pairs with a
    live window that took the tensor-core tile path, [L + l] those that
    took the per-query path."""
    import ctypes

    _check_kernel_args("alt_corr_fwd", f1, levels, coords, radius)
    B, N, C = f1.shape
    L = len(levels)
    _check_path_counts(path_counts, L, f1.device)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("alt_corr_fwd", "ufr_alt_corr_fwd", [
        vp, ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp, vp, i32, i32,
        i32, i32, i32, i32, vp, vp])

    n = 2 * radius + 1
    out = torch.empty((B, N, L * n * n), device=f1.device, dtype=torch.float32)
    if B * N == 0:
        return out
    H1, W1 = _query_grid(levels, N)
    ptrs, hw = _level_args(levels)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), ptrs, hw, L, coords.data_ptr(),
                 out.data_ptr(), B, H1, W1, C, radius,
                 int(f1.dtype == torch.bfloat16),
                 None if path_counts is None else path_counts.data_ptr(),
                 stream)
    if err:
        raise RuntimeError("alt_corr_fwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["alt_corr_fwd"] += 1
    return out


def _check_cotangent(f1, levels, g, radius):
    """Raise on a cotangent csrc/alt_corr_{bwd,dcoords}.cu do not take."""
    B, N, _ = f1.shape
    k = len(levels) * (2 * radius + 1) ** 2
    if g.dtype != torch.float32 or tuple(g.shape) != (B, N, k) \
            or g.device != f1.device or not g.is_contiguous() \
            or g.data_ptr() % 16:
        raise ValueError(f"g must be contiguous f32 (B, N, L*n*n) = ({B}, "
                         f"{N}, {k}) on {f1.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")


def _query_grid(levels, n: int):
    """The (H1, W1) grid of the n queries per image that csrc/alt_corr_fwd.cu,
    alt_corr_bwd.cu and alt_corr_dcoords.cu cut into 8x8 tiles: level 0's
    width and the rows n fills, where n is whole rows of it (level 0's
    grid on the one-device path, a spatial mesh's block of rows on the
    sharded one); else one row of n.  Any grid gives the same result; a
    2-D one keeps a tile's windows together."""
    w = levels[0].shape[2]
    return (n // w, w) if w and n % w == 0 else (1, n)


def _alt_corr_bwd_cuda(f1, levels, coords, g, radius, path_counts=None):
    """Launch csrc/alt_corr_bwd.cu: (df1 (B, N, C), dlevels) in f32 for
    the output cotangent g (B, N, L*(2r+1)^2) f32.  df2 is accumulated
    with atomics, so its levels start from ``torch.zeros``; df1 is written
    whole.  ``path_counts``: None, or a zeroed int32 CUDA tensor of 2*L
    that the kernel adds to: [l] the (8x8 tile, level) pairs that took the
    tile path, [L + l] those that took the per-query path."""
    import ctypes

    _check_kernel_args("alt_corr_bwd", f1, levels, coords, radius)
    _check_cotangent(f1, levels, g, radius)
    B, N, C = f1.shape
    L = len(levels)
    _check_path_counts(path_counts, L, f1.device)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("alt_corr_bwd", "ufr_alt_corr_bwd", [
        vp, ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp, vp, vp,
        ctypes.POINTER(vp), i32, i32, i32, i32, i32, i32, vp, vp])

    df1 = torch.empty((B, N, C), device=f1.device, dtype=torch.float32)
    dlevels = tuple(torch.zeros(lvl.shape, device=f1.device,
                                dtype=torch.float32) for lvl in levels)
    if B * N == 0:
        return df1, dlevels
    H1, W1 = _query_grid(levels, N)
    ptrs, hw = _level_args(levels)
    dptrs = (vp * L)(*[d.data_ptr() for d in dlevels])
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), ptrs, hw, L, coords.data_ptr(), g.data_ptr(),
                 df1.data_ptr(), dptrs, B, H1, W1, C, radius,
                 int(f1.dtype == torch.bfloat16),
                 None if path_counts is None else path_counts.data_ptr(),
                 stream)
    if err:
        raise RuntimeError("alt_corr_bwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["alt_corr_bwd"] += 1
    return df1, dlevels


def _alt_corr_dcoords_cuda(f1, levels, coords, g, radius, path_counts=None):
    """Launch csrc/alt_corr_dcoords.cu: dcoords (B, N, 2) f32, the
    coordinate gradient of the lookup for the output cotangent g (B, N,
    L*(2r+1)^2) f32, as ``alt_corr_coords_grad_reference`` computes it.
    One call covers every level: the kernel writes each (query, level)'s
    share into a scratch of per-level partials, which a second kernel sums
    in level order into dcoords (no atomics: the same bits every call).
    ``path_counts``: None, or a zeroed int32 CUDA tensor of 2*L that the
    kernel adds to as ``_alt_corr_lookup_cuda``'s does: [l] the (8x8 tile,
    level) pairs with a live window that took the tensor-core tile path,
    [L + l] those that took the per-query path."""
    import ctypes

    _check_kernel_args("alt_corr_dcoords", f1, levels, coords, radius)
    _check_cotangent(f1, levels, g, radius)
    B, N, C = f1.shape
    L = len(levels)
    _check_path_counts(path_counts, L, f1.device)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("alt_corr_dcoords", "ufr_alt_corr_dcoords", [
        vp, ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp, vp, vp, vp,
        i32, i32, i32, i32, i32, i32, vp, vp])

    dcoords = torch.empty((B, N, 2), device=f1.device, dtype=torch.float32)
    if B * N == 0:
        return dcoords
    partial = torch.empty((B, N, L, 2), device=f1.device, dtype=torch.float32)
    H1, W1 = _query_grid(levels, N)
    ptrs, hw = _level_args(levels)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), ptrs, hw, L, coords.data_ptr(), g.data_ptr(),
                 partial.data_ptr(), dcoords.data_ptr(), B, H1, W1, C, radius,
                 int(f1.dtype == torch.bfloat16),
                 None if path_counts is None else path_counts.data_ptr(),
                 stream)
    if err:
        raise RuntimeError("alt_corr_dcoords launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["alt_corr_dcoords"] += 1
    return dcoords


def _check_lookup_args(levels, coords, radius):
    """Raise on what csrc/corr_lookup_fwd.cu does not take.  levels[l]:
    (BN, Hl, Wl); coords: (BN, 2)."""
    L = len(levels)
    if not 1 <= L <= _MAX_LEVELS or radius not in _RADII:
        raise ValueError(f"corr_lookup_fwd takes 1..{_MAX_LEVELS} levels and "
                         f"radius {_RADII[0]}..{_RADII[-1]}, got {L} and "
                         f"{radius}")
    dtype, device = levels[0].dtype, levels[0].device
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr_lookup_fwd takes an f32 or bf16 pyramid, got "
                        f"{dtype}")
    BN = levels[0].shape[0]
    for lvl in levels:
        if lvl.dtype != dtype or lvl.dim() != 3 or lvl.shape[0] != BN:
            raise ValueError(f"each level must be {dtype} (BN, Hl, Wl) with "
                             f"BN={BN}, got {lvl.dtype} {tuple(lvl.shape)}")
        if BN and not lvl.shape[1] * lvl.shape[2]:
            raise ValueError("corr_lookup_fwd takes no empty level "
                             "(corr_lookup passes only the live ones)")
    if coords.dtype != torch.float32 or tuple(coords.shape) != (BN, 2):
        raise ValueError(f"coords must be f32 (BN, 2) = ({BN}, 2), got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    for t in (coords, *levels):
        if t.device != device or device.type != "cuda":
            raise ValueError("corr_lookup_fwd inputs must be on one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("corr_lookup_fwd inputs must be contiguous")


def corr_lookup_fwd(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                    radius: int = 4) -> torch.Tensor:
    """Launch csrc/corr_lookup_fwd.cu: levels[l] (BN, Hl, Wl) f32 or bf16,
    contiguous; coords (BN, 2) level-0 (x, y) f32.  Returns (BN,
    L*(2r+1)^2) f32, channel l*n*n + s*n + t sampling (x/2^l - r + s,
    y/2^l - r + t).  One launch covers every level."""
    import ctypes

    _check_lookup_args(levels, coords, radius)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("corr_lookup_fwd", "ufr_corr_lookup_fwd", [
        ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp, vp,
        ctypes.c_longlong, i32, i32, vp])

    BN, L, n = coords.shape[0], len(levels), 2 * radius + 1
    out = torch.empty((BN, L * n * n), device=coords.device,
                      dtype=torch.float32)
    if BN == 0:
        return out
    ptrs = (vp * L)(*[lvl.data_ptr() for lvl in levels])
    hw = (i32 * (2 * L))(*[d for lvl in levels for d in lvl.shape[1:]])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = fn(ptrs, hw, L, coords.data_ptr(), out.data_ptr(), BN, radius,
                 int(levels[0].dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("corr_lookup_fwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["corr_lookup_fwd"] += 1
    return out

