"""RAFT correlation: all-pairs volume, pyramid and window lookup
(counterpart of ``understanding_flow_robustness_tpu/ops/correlation.py``
and ``ops/pallas/alt_corr.py``).

Public functions keep the JAX package's channels-last layouts.  The
on-demand lookup ``alt_corr_features`` never builds the all-pairs volume on
the GPU: ``alt_corr_lookup`` launches the CUDA kernel
``csrc/alt_corr_fwd.cu`` for a CUDA tensor and runs its plain PyTorch
version, ``alt_corr_lookup_reference``, for a CPU tensor.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import torch

# Launches of each hand-written kernel, counted by its wrapper where it
# launches the kernel (chip_smoke.py reads them to show the main path ran
# through the kernels).
LAUNCH_COUNTS: collections.Counter = collections.Counter()

# Argument limits of csrc/alt_corr_fwd.cu: its kMaxLevels, its kRadius and
# its bound of two 16-byte chunks of a feature row per lane.
_MAX_LEVELS = 8
_RADIUS = 4
_MAX_CHUNKS = 2 * 32


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H*W, H, W):
    corr[b, (i, j), k, l] = <f1[b, i, j], f2[b, k, l]> / sqrt(C)
    (models/raft/corr.py:98-106), computed in f32."""
    B, H, W, C = f1.shape
    a = f1.reshape(B, H * W, C).float()
    b = f2.reshape(B, H * W, C).float()
    corr = torch.bmm(a, b.transpose(1, 2)) / math.sqrt(C)
    return corr.reshape(B, H * W, H, W).to(f1.dtype)


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
    cx = centers[:, 0].float().clamp(-(r + 2.0), Wl + r + 1.0)
    cy = centers[:, 1].float().clamp(-(r + 2.0), Hl + r + 1.0)
    fx, fy = torch.floor(cx), torch.floor(cy)
    ax, ay = (cx - fx)[:, None, None], (cy - fy)[:, None, None]
    offs = torch.arange(-r, r + 2, device=vol.device)
    xs = fx.long()[:, None] + offs  # (M, n+1)
    ys = fy.long()[:, None] + offs
    inside = (((ys >= 0) & (ys < Hl))[:, :, None]
              & ((xs >= 0) & (xs < Wl))[:, None, :])
    idx = ys.clamp(0, Hl - 1)[:, :, None] * Wl + xs.clamp(0, Wl - 1)[:, None, :]
    g = vol.reshape(M, Hl * Wl).float().gather(1, idx.reshape(M, -1))
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
    a = f1.float()
    c = coords.reshape(B * N, 2)
    out = []
    for lvl, f2 in enumerate(levels):
        Hl, Wl = f2.shape[1], f2.shape[2]
        vol = torch.bmm(a, f2.reshape(B, Hl * Wl, C).float().transpose(1, 2))
        out.append(_window_sample(vol.reshape(B * N, Hl, Wl), c / 2 ** lvl,
                                  radius))
    return torch.cat(out, dim=-1).reshape(B, N, -1)


def prepare_alt_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int,
                     compute_dtype: Optional[torch.dtype] = None):
    """Once per forward: (B, H, W, C) fmaps -> (f1 (B, N, C) scaled by
    1/sqrt(C), pooled fmap2 levels (B, Hl, Wl, C)), pooled in f32 and then
    cast to ``compute_dtype`` (ops/pallas/alt_corr.py:521-528); all
    contiguous, as the kernel reads them."""
    B, H, W, C = fmap1.shape
    f1 = (fmap1.float() * (1.0 / math.sqrt(C))).reshape(B, H * W, C)
    levels = pool_fmap_levels(fmap2.float(), num_levels)
    if compute_dtype is not None:
        f1 = f1.to(compute_dtype)
        levels = [lvl.to(compute_dtype) for lvl in levels]
    return f1.contiguous(), tuple(lvl.contiguous() for lvl in levels)


def alt_corr_lookup(f1: torch.Tensor, levels: Sequence[torch.Tensor],
                    coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The lookup of ``alt_corr_features`` from prepared inputs
    (``prepare_alt_corr``): the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors.  Forward only."""
    if any(t.requires_grad for t in (f1, coords, *levels)):
        raise NotImplementedError(
            "alt_corr_lookup has no backward yet: the backward kernel is "
            "ROADMAP queue B item 2 (alt_corr.py::_alt_corr_bwd_kernel)")
    if f1.device.type == "cpu":
        return alt_corr_lookup_reference(f1, levels, coords, radius)
    if f1.device.type != "cuda":
        raise ValueError(f"alt_corr_lookup: unsupported device {f1.device}")
    return _alt_corr_lookup_cuda(f1, levels, coords, radius)


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
    all_pairs_correlation(fmap1, fmap2)), coords)``."""
    B, H, W, _ = fmap1.shape
    f1, levels = prepare_alt_corr(fmap1, fmap2, num_levels, compute_dtype)
    out = alt_corr_lookup(f1, levels, coords.reshape(B, H * W, 2), radius)
    return out.reshape(B, H, W, -1)


def _alt_corr_lookup_cuda(f1, levels, coords, radius):
    import ctypes

    from ._build import load_library

    B, N, C = f1.shape
    L = len(levels)
    vec = 16 // f1.element_size()
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"alt_corr_fwd takes f32 or bf16 features, got {f1.dtype}")
    if coords.dtype != torch.float32 or tuple(coords.shape) != (B, N, 2):
        raise ValueError(f"coords must be f32 (B, N, 2) = ({B}, {N}, 2), got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    if not 1 <= L <= _MAX_LEVELS or radius != _RADIUS:
        raise ValueError(f"alt_corr_fwd takes 1..{_MAX_LEVELS} levels and "
                         f"radius {_RADIUS}, got {L} and {radius}")
    if C % vec or C // vec > _MAX_CHUNKS:
        raise ValueError(f"alt_corr_fwd takes C a multiple of {vec} up to "
                         f"{vec * _MAX_CHUNKS} for {f1.dtype}, got {C}")
    for t in (f1, coords, *levels):
        if t.device != f1.device:
            raise ValueError("alt_corr_fwd inputs must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("alt_corr_fwd inputs must be contiguous and "
                             "16-byte aligned")
    for lvl in levels:
        if lvl.dtype != f1.dtype or lvl.dim() != 4 or lvl.shape[0] != B \
                or lvl.shape[3] != C:
            raise ValueError(f"each level must be {f1.dtype} (B, Hl, Wl, C), "
                             f"got {lvl.dtype} {tuple(lvl.shape)}")

    lib = load_library("alt_corr_fwd")
    fn = lib.ufr_alt_corr_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ufr_cuda_error_string.restype = ctypes.c_char_p
    lib.ufr_cuda_error_string.argtypes = [ctypes.c_int]

    n = 2 * radius + 1
    out = torch.empty((B, N, L * n * n), device=f1.device, dtype=torch.float32)
    if B * N == 0:
        return out
    ptrs = (ctypes.c_void_p * L)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * L))(
        *[d for lvl in levels for d in (lvl.shape[1], lvl.shape[2])])
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
