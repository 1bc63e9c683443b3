"""Sampling, warping and resizing (counterpart of
``understanding_flow_robustness_tpu/ops/interp.py``).

Unlike the JAX package these take NCHW tensors, the layout of the port's
convolutions; the InputPadder helpers ``compute_pad`` and ``remove_pad``
keep the JAX package's NHWC, the layout of the images and flows that
``predict_flow`` takes and returns (the padding itself is done on the host,
``native.batch_u8_to_float01_pad`` and ``data.loader.pad_batch``).  ``warp_backward`` is the plain PyTorch version of the CUDA
kernel ``csrc/warp_fwd.cu`` (``ops/warp.py`` launches it for CUDA tensors);
every function here also runs on the CPU.  The TPU's tiled warp planning,
its violation count and the bounded correction are not ported: a GPU
gathers per pixel and is exact for every flow.

Under a row-splitting spatial mesh (``parallel/spatial.py``) the functions
the models call work on a rank's row block: ``coords_grid`` starts at the
block's global row, ``resize_bilinear`` maps the block's output rows to
global source rows with a one-row halo, ``avg_pool2`` and
``upsample_nearest`` stay local (blocks are aligned); the warp takes the
whole source and the row offset of the rows it writes
(``warp_backward_reference(..., row0=)``, ``ops/warp.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.spatial import halo_rows, row_mesh

WARP_MODES = ("border", "zeros_mask", "spynet")
# the zeros_mask mode's mask threshold on the analytic in-bounds weight
# (interp.py:536)
MASK_THRESHOLD = 1e-4


def coords_grid(height: int, width: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 2) pixel-coordinate grid, channel order (x, y).

    RAFT's coords_grid (models/raft/utils/utils.py:79-82) in the JAX
    package's channels-last layout.  Under a row-splitting spatial mesh
    the grid of this rank's ``height`` rows: y starts at the block's
    global row."""
    y0 = 0 if row_mesh() is None else row_mesh().spatial_rank * height
    y, x = torch.meshgrid(
        torch.arange(y0, y0 + height, device=device, dtype=dtype),
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


def warp_sample_coords(flow: torch.Tensor, mode: str, row0: int = 0,
                       src_height=None):
    """flow (B, 2, h, W), channel 0 = u (x displacement) -> the sampler's
    (x, y) pixel coordinates (B, h, W) f32 and, for "zeros_mask", the
    (B, h, W) bool mask (else None); interp.py:501-545.  The flow's rows
    are rows ``row0`` .. ``row0 + h - 1`` of a source of ``src_height``
    rows (by default h): the grid starts at row0 and the normalisation
    divides by the source's height, so a block's coordinates are the
    rows of the whole flow's, bit for bit.  The kernel computes the same
    with the same f32 operations in the same order."""
    if mode not in WARP_MODES:
        raise ValueError(f"unknown warp mode: {mode}")
    B, _, h, W = flow.shape
    H = h if src_height is None else src_height
    xs = torch.arange(W, dtype=torch.float32, device=flow.device)
    ys = torch.arange(row0, row0 + h, dtype=torch.float32,
                      device=flow.device)[:, None]
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
                            mode: str = "border",
                            row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel ``csrc/warp_fwd.cu``:
    out(y, x) = img(row0 + y + v, x + u), NCHW (interp.py:481-547).

    img: (B, C, H, W) f32 or bf16, the whole source; flow: (B, 2, h, W)
    with channel 0 = u, rows row0 .. row0 + h - 1 of the output (all of
    it by default: h = H, row0 = 0; a spatial mesh's block otherwise).
    Returns (B, C, h, W) in img's dtype, sampled in f32.
      * "border":     Resample2d semantics (FlowNet2's stage chaining).
      * "zeros_mask": PWC-Net's ``warp``: zeros-padded align_corners=False
                      sampling on a grid normalised by (size-1), times the
                      analytic separable in-bounds mask thresholded at
                      1e-4 -- not a warped ones channel, so the mask bits
                      do not depend on the sampler.
      * "spynet":     SPyNet's ``Backward``: the normalised grid clamped
                      to [-1, 1], then align_corners=False zeros sampling.
    """
    x, y, mask = warp_sample_coords(flow, mode, row0, img.shape[2])
    out = bilinear_sample(img, x, y,
                          "border" if mode == "border" else "zeros")
    if mask is not None:
        out = out * mask[:, None].to(out.dtype)
    return out


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """torch's F.interpolate(mode="bilinear"), no anti-aliasing, NCHW
    (interp.py:550-579, which builds the same weights as matrices).

    Under a row-splitting spatial mesh ``x`` is a rank's block of h rows
    and ``out_h`` the rows of its output block: the image's H = n h rows
    resize to n out_h, and each output row blends the two source rows its
    global coordinate names (F.interpolate's f32 scale and source index),
    from the block and a one-row halo with the image's edge rows beyond
    (the index clamp); the columns are F.interpolate's own."""
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x
    mesh = row_mesh()
    if mesh is None:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=align_corners, antialias=False)
    h = x.shape[2]
    y0, y1, lam = _resize_rows(h * mesh.n_spatial, out_h * mesh.n_spatial,
                               mesh.spatial_rank * out_h, out_h,
                               align_corners)
    # block-local indices into the halo'd rows (the first is global row
    # row0 - 1); the source rows of a block's output lie within one row of
    # it for the scales of the zoo (x2, x4, x8 and their inverses)
    base = mesh.spatial_rank * h - 1
    lo, hi = y0 - base, y1 - base
    if int(lo.min()) < 0 or int(hi.max()) > h + 1:
        raise ValueError(f"resize of {h}-row blocks to {out_h} rows reaches "
                         "past a one-row halo")
    rows = halo_rows(x, 1, 1, fill="edge")
    lam = lam.to(device=x.device)[:, None]
    blend = (rows.index_select(2, lo.to(x.device)).float() * (1 - lam)
             + rows.index_select(2, hi.to(x.device)).float() * lam)
    return F.interpolate(blend.to(x.dtype), size=(out_h, out_w),
                         mode="bilinear", align_corners=align_corners,
                         antialias=False)


def _resize_rows(H: int, out_H: int, first: int, n: int,
                 align_corners: bool) -> tuple:
    """Rows ``first`` .. ``first + n - 1`` of a bilinear resize of H rows to
    out_H: their two source rows (long) and the second's weight (f32),
    with F.interpolate's f32 arithmetic (area_pixel_compute_source_index:
    scale = in / out, or (in - 1) / (out - 1) with align_corners; a source
    below 0 clamped to 0; the second row clamped to the last)."""
    o = torch.arange(first, first + n, dtype=torch.float32)
    if align_corners:
        scale = torch.tensor((H - 1) / (out_H - 1) if out_H > 1 else 0.0,
                             dtype=torch.float32)
        src = scale * o
    else:
        scale = torch.tensor(H, dtype=torch.float32) / out_H
        src = torch.clamp(scale * (o + 0.5) - 0.5, min=0.0)
    y0 = src.long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    return y0, y1, src - y0.float()


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """F.interpolate(mode="nearest") by an integer ``scale``, NCHW: each
    value repeated ``scale`` times along H and W (interp.py:597-603;
    FlowNet2's x4 upsample of its S2 and SD flows)."""
    return x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(kernel_size=2, stride=2) on NCHW: odd sizes drop their
    last row or column; sum of the 2x2 block times 0.25, as interp.py:
    606-618 computes it.  A spatial mesh's blocks pool alone: their rows
    pair up within the block, which must be even."""
    B, C, H, W = x.shape
    if H % 2 and row_mesh() is not None:
        raise ValueError(f"avg_pool2 of {H}-row blocks: the pairs would "
                         "cross blocks")
    h2, w2 = H // 2, W // 2
    x = x[:, :, : 2 * h2, : 2 * w2].reshape(B, C, h2, 2, w2, 2)
    return x.sum(dim=(3, 5)) * 0.25


def compute_pad(height: int, width: int, mode: str = "sintel",
                multiple: int = 8) -> tuple:
    """Pad amounts (top, bottom, left, right) to reach a multiple, RAFT's
    InputPadder rule (interp.py:621-630; models/raft/utils/utils.py:7-23):
    "sintel" pads both axes symmetrically, "kitti" pads H at the bottom
    only and W symmetrically."""
    pad_h = (-height) % multiple
    pad_w = (-width) % multiple
    if mode == "sintel":
        return (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)
    return (0, pad_h, pad_w // 2, pad_w - pad_w // 2)


def remove_pad(x, pad: tuple):
    """Crop the (top, bottom, left, right) padding of ``compute_pad`` off
    NHWC (a tensor or an array)."""
    t, b, l, r = pad
    H, W = x.shape[1:3]
    return x[:, t:H - b, l:W - r]
