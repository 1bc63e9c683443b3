"""Correlation: RAFT's all-pairs volume, pyramid and window lookup, and the
spatial correlation of PWC-Net (counterpart of
``understanding_flow_robustness_tpu/ops/correlation.py`` and
``ops/pallas/alt_corr.py``).

RAFT's functions keep the JAX package's channels-last layouts;
``spatial_correlation`` takes NCHW, the layout of PWC-Net's convolutions.
The on-demand lookup ``alt_corr_features`` never builds the all-pairs volume on
the GPU: ``alt_corr_lookup`` launches the CUDA kernel
``csrc/alt_corr_fwd.cu`` for a CUDA tensor and runs its plain PyTorch
version, ``alt_corr_lookup_reference``, for a CPU tensor.  Its gradient
with respect to the features (``_AltCorrLookup``) launches
``csrc/alt_corr_bwd.cu`` for a CUDA tensor and runs
``alt_corr_lookup_backward_reference`` for a CPU tensor.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from ._build import LAUNCH_COUNTS, kernel_fn

# Argument limits of csrc/alt_corr_fwd.cu and csrc/alt_corr_bwd.cu: their
# kMaxLevels, their kRadius and their bound of two 16-byte chunks of a
# feature row per lane.
_MAX_LEVELS = 8
_RADIUS = 4
_MAX_CHUNKS = 2 * 32


def _widen(t: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> f32; f32 and f64 stay (f64 for gradcheck)."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H*W, H, W):
    corr[b, (i, j), k, l] = <f1[b, i, j], f2[b, k, l]> / sqrt(C)
    (models/raft/corr.py:98-106), computed in f32."""
    B, H, W, C = f1.shape
    a = f1.reshape(B, H * W, C).float()
    b = f2.reshape(B, H * W, C).float()
    corr = torch.bmm(a, b.transpose(1, 2)) / math.sqrt(C)
    return corr.reshape(B, H * W, H, W).to(f1.dtype)


def spatial_correlation(f1: torch.Tensor, f2: torch.Tensor,
                        patch_size: int = 1) -> torch.Tensor:
    """Spatial correlation with kernel 1, stride 1, padding 0 and patch
    dilation 1, PWC-Net's configuration (correlation.py:56-102; the
    spatial-correlation-sampler op).  NCHW: f1, f2 (B, C, H, W) ->
    (B, P*P, H, W), P = patch_size, du-major: channel pu*P + pv is
    <f1[:, :, y, x], f2[:, :, y + pu - r, x + pv - r]>, r = (P-1)//2, zero
    outside; not divided by C.  Products and sums in f32, cast back to
    f1's dtype (``_corr_k1_band``, correlation.py:182).  Plain PyTorch: the
    JAX package runs this on XLA, not in a Pallas kernel."""
    B, C, H, W = f1.shape
    r = (patch_size - 1) // 2
    a = _widen(f1)
    b = torch.nn.functional.pad(_widen(f2), (r, r, r, r))
    out = a.new_empty((B, patch_size * patch_size, H, W))
    for pu in range(patch_size):
        for pv in range(patch_size):
            out[:, pu * patch_size + pv] = (
                a * b[:, :, pu:pu + H, pv:pv + W]).sum(1)
    return out.to(f1.dtype)


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


def _window_sample(vol: torch.Tensor, centers: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Bilinear (2r+1)^2 window around each centre, zeros outside.

    vol: (M, Hl, Wl); centers: (M, 2) as (x, y) in level pixels,
    align_corners=True (no half-pixel shift).  Returns (M, (2r+1)^2) f32 in
    the reference's s-major order: channel s*(2r+1) + t samples
    (x - r + s, y - r + t) (models/raft/corr.py:79-85).  All taps of a
    window share one fractional offset, so the window is a blend of the
    (2r+2)^2 integer-grid values around it."""
    M, Hl, Wl = vol.shape
    r = radius
    n = 2 * r + 1
    # far-out centres are clamped to where the whole window is still out
    # of the volume, so the float->int conversion cannot overflow
    cx = _widen(centers[:, 0]).clamp(-(r + 2.0), Wl + r + 1.0)
    cy = _widen(centers[:, 1]).clamp(-(r + 2.0), Hl + r + 1.0)
    fx, fy = torch.floor(cx), torch.floor(cy)
    ax, ay = (cx - fx)[:, None, None], (cy - fy)[:, None, None]
    offs = torch.arange(-r, r + 2, device=vol.device)
    xs = fx.long()[:, None] + offs  # (M, n+1)
    ys = fy.long()[:, None] + offs
    inside = (((ys >= 0) & (ys < Hl))[:, :, None]
              & ((xs >= 0) & (xs < Wl))[:, None, :])
    idx = ys.clamp(0, Hl - 1)[:, :, None] * Wl + xs.clamp(0, Wl - 1)[:, None, :]
    g = _widen(vol.reshape(M, Hl * Wl)).gather(1, idx.reshape(M, -1))
    g = g.reshape(M, n + 1, n + 1) * inside  # g[m, i, j]: (y0 - r + i, x0 - r + j)
    samp = ((1 - ax) * (1 - ay) * g[:, :-1, :-1] + ax * (1 - ay) * g[:, :-1, 1:]
            + (1 - ax) * ay * g[:, 1:, :-1] + ax * ay * g[:, 1:, 1:])  # [m, t, s]
    return samp.transpose(1, 2).reshape(M, n * n)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Radius-r window lookup into a correlation pyramid (CorrBlock,
    models/raft/corr.py:72-96).  pyramid[l]: (B, H1*W1, Hl, Wl); coords:
    (B, H1, W1, 2) level-0 (x, y).  Returns (B, H1, W1, L*(2r+1)^2) f32,
    level l centred at coords / 2^l."""
    B, H1, W1, _ = coords.shape
    c = coords.reshape(B * H1 * W1, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        vol = corr.reshape(B * H1 * W1, corr.shape[2], corr.shape[3])
        out.append(_window_sample(vol, c / 2 ** lvl, radius))
    return torch.cat(out, dim=-1).reshape(B, H1, W1, -1)


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
        grads = torch.autograd.grad(out, [a, *lv], g.to(out.dtype))
    return grads[0], tuple(grads[1:])


def prepare_alt_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int,
                     compute_dtype: Optional[torch.dtype] = None):
    """Once per forward: (B, H, W, C) fmaps -> (f1 (B, N, C) scaled by
    1/sqrt(C), pooled fmap2 levels (B, Hl, Wl, C)), pooled in f32 and then
    cast to ``compute_dtype`` (ops/pallas/alt_corr.py:521-528); all
    contiguous, as the kernel reads them.  Scaling and pooling are plain
    autograd ops, so the gradients ``alt_corr_lookup`` returns for f1 and
    the levels reach the fmaps through their autograd transposes."""
    B, H, W, C = fmap1.shape
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
    """The lookup with its feature gradient (the JAX package's
    ``_alt_corr_vjp``, ops/correlation.py:659-692).

    Differentiable inputs: f1 and the levels as prepared (f32 on the
    model's path).  The kernels read ``kernel_inputs``, their detached
    copies in the compute dtype, and the gradients go back to f1 and the
    levels in f32, never rounded to bf16 -- where JAX also puts its
    custom_vjp.  Saved for the backward: those copies and the coords, the
    same tensors for every iteration of a forward, never the output."""

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
        if kf1.device.type == "cpu":
            df1, dlevels = alt_corr_lookup_backward_reference(
                kf1, klevels, coords, g, ctx.radius)
        else:
            df1, dlevels = _alt_corr_bwd_cuda(
                kf1, klevels, coords, g.float().contiguous(), ctx.radius)
        return (None, None, None, None) + (None,) * ctx.num_levels + (
            df1, *dlevels)


def _lookup(f1, levels, coords, radius):
    if f1.device.type == "cpu":
        return alt_corr_lookup_reference(f1, levels, coords, radius)
    if f1.device.type != "cuda":
        raise ValueError(f"alt_corr_lookup: unsupported device {f1.device}")
    return _alt_corr_lookup_cuda(f1, levels, coords, radius)


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
    through ``_AltCorrLookup`` and its backward returns f32 gradients to f1
    and the levels.  The coordinates take no gradient: RAFT detaches them
    every iteration, and their gradient kernel is ROADMAP queue B item 3."""
    if coords.requires_grad:
        raise NotImplementedError(
            "alt_corr_lookup has no coordinate gradient: its kernel is "
            "ROADMAP queue B item 3 (B3, alt_corr.py::_alt_corr_kernel "
            "deriv='x'/'y'); detach the coordinates")
    kf1, klevels = kernel_inputs if kernel_inputs is not None else (
        f1, tuple(levels))
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (f1, *levels))):
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
    fmaps: the kernels read ``compute_dtype`` copies and the gradients
    stay f32."""
    B, H, W, _ = fmap1.shape
    f1, levels = prepare_alt_corr(fmap1, fmap2, num_levels)
    kin = (alt_corr_kernel_inputs(f1, levels, compute_dtype)
           if compute_dtype is not None else None)
    out = alt_corr_lookup(f1, levels, coords.reshape(B, H * W, 2), radius,
                          kin)
    return out.reshape(B, H, W, -1)


def _check_kernel_args(name, f1, levels, coords, radius):
    """Raise on what csrc/alt_corr_{fwd,bwd}.cu do not take."""
    B, N, C = f1.shape
    L = len(levels)
    vec = 16 // f1.element_size()
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 features, got {f1.dtype}")
    if coords.dtype != torch.float32 or tuple(coords.shape) != (B, N, 2):
        raise ValueError(f"coords must be f32 (B, N, 2) = ({B}, {N}, 2), got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    if not 1 <= L <= _MAX_LEVELS or radius != _RADIUS:
        raise ValueError(f"{name} takes 1..{_MAX_LEVELS} levels and "
                         f"radius {_RADIUS}, got {L} and {radius}")
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


def _level_args(levels):
    import ctypes

    L = len(levels)
    ptrs = (ctypes.c_void_p * L)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * L))(
        *[d for lvl in levels for d in (lvl.shape[1], lvl.shape[2])])
    return ptrs, hw


def _alt_corr_lookup_cuda(f1, levels, coords, radius):
    import ctypes

    _check_kernel_args("alt_corr_fwd", f1, levels, coords, radius)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("alt_corr_fwd", "ufr_alt_corr_fwd", [
        vp, ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp, vp, i32, i32,
        i32, i32, i32, vp])

    B, N, C = f1.shape
    L = len(levels)
    n = 2 * radius + 1
    out = torch.empty((B, N, L * n * n), device=f1.device, dtype=torch.float32)
    if B * N == 0:
        return out
    ptrs, hw = _level_args(levels)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), ptrs, hw, L, coords.data_ptr(),
                 out.data_ptr(), B, N, C, radius,
                 int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("alt_corr_fwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["alt_corr_fwd"] += 1
    return out


def _alt_corr_bwd_cuda(f1, levels, coords, g, radius):
    """Launch csrc/alt_corr_bwd.cu: (df1 (B, N, C), dlevels) in f32 for
    the output cotangent g (B, N, L*(2r+1)^2) f32.  df2 is a scatter with
    atomics, so its levels start from ``torch.zeros``; df1 is written
    whole."""
    import ctypes

    _check_kernel_args("alt_corr_bwd", f1, levels, coords, radius)
    B, N, C = f1.shape
    L = len(levels)
    n = 2 * radius + 1
    if g.dtype != torch.float32 or tuple(g.shape) != (B, N, L * n * n) \
            or g.device != f1.device or not g.is_contiguous() \
            or g.data_ptr() % 16:
        raise ValueError(f"g must be contiguous f32 (B, N, L*n*n) = ({B}, "
                         f"{N}, {L * n * n}) on {f1.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("alt_corr_bwd", "ufr_alt_corr_bwd", [
        vp, ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp, vp, vp,
        ctypes.POINTER(vp), i32, i32, i32, i32, i32, vp])

    df1 = torch.empty((B, N, C), device=f1.device, dtype=torch.float32)
    dlevels = tuple(torch.zeros(lvl.shape, device=f1.device,
                                dtype=torch.float32) for lvl in levels)
    if B * N == 0:
        return df1, dlevels
    ptrs, hw = _level_args(levels)
    dptrs = (vp * L)(*[d.data_ptr() for d in dlevels])
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), ptrs, hw, L, coords.data_ptr(), g.data_ptr(),
                 df1.data_ptr(), dptrs, B, N, C, radius,
                 int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("alt_corr_bwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["alt_corr_bwd"] += 1
    return df1, dlevels
