"""Sampling, warping and resizing (counterpart of
``understanding_flow_robustness_tpu/ops/interp.py``).

Unlike the JAX package these take NCHW tensors, the layout of the port's
convolutions.  ``warp_backward`` is the plain PyTorch version of the CUDA
kernel ``csrc/warp_fwd.cu`` (``ops/warp.py`` launches it for CUDA tensors);
every function here also runs on the CPU.  The TPU's tiled warp planning,
its violation count and the bounded correction are not ported: a GPU
gathers per pixel and is exact for every flow.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WARP_MODES = ("border", "zeros_mask", "spynet")
# the zeros_mask mode's mask threshold on the analytic in-bounds weight
# (interp.py:536)
MASK_THRESHOLD = 1e-4


def coords_grid(height: int, width: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 2) pixel-coordinate grid, channel order (x, y).

    RAFT's coords_grid (models/raft/utils/utils.py:79-82) in the JAX
    package's channels-last layout."""
    y, x = torch.meshgrid(
        torch.arange(height, device=device, dtype=dtype),
        torch.arange(width, device=device, dtype=dtype),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def unnormalize_coords(gx: torch.Tensor, gy: torch.Tensor, height: int,
                       width: int, align_corners: bool):
    """[-1, 1] normalised grid coordinates -> pixel coordinates, torch's
    conventions (interp.py:135-145)."""
    if align_corners:
        return (gx + 1.0) * 0.5 * (width - 1), (gy + 1.0) * 0.5 * (height - 1)
    return (((gx + 1.0) * width - 1.0) * 0.5,
            ((gy + 1.0) * height - 1.0) * 0.5)


class _Clip(torch.autograd.Function):
    """``x.clamp(lo, hi)`` with ``jnp.clip``'s gradient: g times 1 inside,
    0.5 at either bound (lax.max/min split a tie) and 0 outside -- a
    product, so a NaN cotangent stays NaN where torch's clamp would drop
    it (FlowNet2's channel norm at an exact zero, see ``channel_norm``)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,), (lo, hi) = ctx.saved_tensors, ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample of img (B, C, H, W) at pixel coordinates x, y
    (B, Ho, Wo) -> (B, C, Ho, Wo) in img's dtype (interp.py:56-120).

    Weights and sums are f32 whatever img's dtype.  "zeros": taps outside
    the image give 0; "border": the coordinate is clamped to [0, size-1]
    first (with ``jnp.clip``'s gradient, ``_Clip``) and the weights come
    from the clamped coordinate.  In zeros mode a coordinate beyond
    [-2, size+1] is clamped to that range, where all of its taps stay
    outside, so the float->int conversion never sees a far-out value."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    B, C, H, W = img.shape
    x = x.float()
    y = y.float()
    if padding_mode == "border":
        x = _Clip.apply(x, 0.0, W - 1.0)
        y = _Clip.apply(y, 0.0, H - 1.0)
    else:
        x = x.clamp(-2.0, W + 1.0)
        y = y.clamp(-2.0, H + 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.float().reshape(B, C, H * W)

    def tap(yi, xi):
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1, -1)
        v = flat.gather(2, idx.expand(B, C, idx.shape[-1]))
        v = v.reshape(B, C, *yi.shape[1:])
        if padding_mode == "zeros":
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = v * valid[:, None]
        return v

    out = (tap(y0i, x0i) * (1 - wy) * (1 - wx)
           + tap(y0i, x0i + 1) * (1 - wy) * wx
           + tap(y0i + 1, x0i) * wy * (1 - wx)
           + tap(y0i + 1, x0i + 1) * wy * wx)
    return out.to(img.dtype)


def _normalise(coord: torch.Tensor, size: int) -> torch.Tensor:
    """2 * coord / (size-1) - 1 (interp.py:514, 541).  The divisor is a
    0-dim tensor on coord's device: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal instead, which can differ in the
    last bit, and the kernel divides (``__fdiv_rn``)."""
    denom = torch.full((), float(max(size - 1, 1)), dtype=torch.float32,
                       device=coord.device)
    return 2.0 * coord / denom - 1.0


def _axis_weight(coord: torch.Tensor, size: int) -> torch.Tensor:
    """The analytic in-bounds weight of one axis (interp.py:528-533)."""
    f0 = torch.floor(coord)
    frac = coord - f0
    w0 = torch.where((f0 >= 0) & (f0 <= size - 1), 1.0 - frac, 0.0)
    w1 = torch.where((f0 + 1 >= 0) & (f0 + 1 <= size - 1), frac, 0.0)
    return w0 + w1


def warp_sample_coords(flow: torch.Tensor, mode: str):
    """flow (B, 2, H, W), channel 0 = u (x displacement) -> the sampler's
    (x, y) pixel coordinates (B, H, W) f32 and, for "zeros_mask", the
    (B, H, W) bool mask (else None); interp.py:501-545.  The kernel
    computes the same with the same f32 operations in the same order."""
    if mode not in WARP_MODES:
        raise ValueError(f"unknown warp mode: {mode}")
    B, _, H, W = flow.shape
    xs = torch.arange(W, dtype=torch.float32, device=flow.device)
    ys = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    x = xs + flow[:, 0].float()
    y = ys + flow[:, 1].float()
    if mode == "border":
        return x, y, None
    gx, gy = _normalise(x, W), _normalise(y, H)
    if mode == "spynet":
        gx, gy = gx.clamp(-1.0, 1.0), gy.clamp(-1.0, 1.0)
    px, py = unnormalize_coords(gx, gy, H, W, align_corners=False)
    if mode == "spynet":
        return px, py, None
    mask = _axis_weight(px, W) * _axis_weight(py, H) >= MASK_THRESHOLD
    return px, py, mask


def warp_backward_reference(img: torch.Tensor, flow: torch.Tensor,
                            mode: str = "border") -> torch.Tensor:
    """Plain PyTorch version of the kernel ``csrc/warp_fwd.cu``:
    out(y, x) = img(y + v, x + u), NCHW (interp.py:481-547).

    img: (B, C, H, W) f32 or bf16; flow: (B, 2, H, W) with channel 0 = u.
    Returns (B, C, H, W) in img's dtype, sampled in f32.
      * "border":     Resample2d semantics (FlowNet2's stage chaining).
      * "zeros_mask": PWC-Net's ``warp``: zeros-padded align_corners=False
                      sampling on a grid normalised by (size-1), times the
                      analytic separable in-bounds mask thresholded at
                      1e-4 -- not a warped ones channel, so the mask bits
                      do not depend on the sampler.
      * "spynet":     SPyNet's ``Backward``: the normalised grid clamped
                      to [-1, 1], then align_corners=False zeros sampling.
    """
    x, y, mask = warp_sample_coords(flow, mode)
    out = bilinear_sample(img, x, y,
                          "border" if mode == "border" else "zeros")
    if mask is not None:
        out = out * mask[:, None].to(out.dtype)
    return out


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """torch's F.interpolate(mode="bilinear"), no anti-aliasing, NCHW
    (interp.py:550-579, which builds the same weights as matrices)."""
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=align_corners, antialias=False)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """F.interpolate(mode="nearest") by an integer ``scale``, NCHW: each
    value repeated ``scale`` times along H and W (interp.py:597-603;
    FlowNet2's x4 upsample of its S2 and SD flows)."""
    return x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(kernel_size=2, stride=2) on NCHW: odd sizes drop their
    last row or column; sum of the 2x2 block times 0.25, as interp.py:
    606-618 computes it."""
    B, C, H, W = x.shape
    h2, w2 = H // 2, W // 2
    x = x[:, :, : 2 * h2, : 2 * w2].reshape(B, C, h2, 2, w2, 2)
    return x.sum(dim=(3, 5)) * 0.25
