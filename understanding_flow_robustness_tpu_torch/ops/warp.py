"""Backward warp through the CUDA kernel ``csrc/warp_fwd.cu`` (the port of
the TPU kernel ``ops/pallas/warp_tile.py::_warp_kernel``).

``warp_backward`` launches the kernel for CUDA tensors and runs its plain
PyTorch version, ``ops/interp.py::warp_backward_reference``, for CPU
tensors; any other device raises, and so does a failed build or launch.
With autograd on, the warp runs through ``_WarpBackward``, whose backward
recomputes the plain version under autograd (the JAX package's custom_vjp,
ops/interp.py:425-442, which differentiates the gather formulation): the
JAX package has no backward kernel for the warp.

Under a row-splitting spatial mesh (``parallel/spatial.py``) the warp's
reach along y is the flow's, unbounded: ``warp_backward`` all-gathers the
source image's rows and the kernel (or the plain version) writes the
block's rows, from the row offset ``row0`` of the whole output, with the
sample coordinates of the unsharded warp, bit for bit.
"""

from __future__ import annotations

import torch

from ..parallel.spatial import all_gather_rows, row_mesh
from ._build import LAUNCH_COUNTS, kernel_fn
from .interp import WARP_MODES, warp_backward_reference


def _check_kernel_args(img: torch.Tensor, flow: torch.Tensor,
                       row0: int) -> None:
    """Raise on what csrc/warp_fwd.cu does not take."""
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"warp_fwd takes f32 or bf16 images, got {img.dtype}")
    if img.dim() != 4:
        raise ValueError(f"img must be (B, C, H, W), got {tuple(img.shape)}")
    B, _, H, W = img.shape
    if flow.dtype != torch.float32 or flow.dim() != 4 \
            or tuple(flow.shape[:2]) != (B, 2) or flow.shape[3] != W:
        raise ValueError(f"flow must be f32 (B, 2, h, W) = ({B}, 2, h, {W}),"
                         f" got {flow.dtype} {tuple(flow.shape)}")
    if not 0 <= row0 <= H - flow.shape[2]:
        raise ValueError(f"rows {row0} .. {row0 + flow.shape[2] - 1} of the "
                         f"output lie outside the source's {H}")
    if flow.device != img.device:
        raise ValueError("warp_fwd inputs must be on one device")
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp_fwd inputs must be contiguous")


def _warp_fwd_cuda(img: torch.Tensor, flow: torch.Tensor, mode: str,
                   row0: int = 0) -> torch.Tensor:
    """Launch csrc/warp_fwd.cu: rows row0 .. row0 + h - 1 of the warp of
    img (B, C, H, W) by the flow's h rows (B, 2, h, W) -> (B, C, h, W)."""
    import ctypes

    _check_kernel_args(img, flow, row0)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn, lib = kernel_fn("warp_fwd", "ufr_warp_fwd",
                        [vp, vp, vp] + [i32] * 8 + [vp])
    B, C, H, W = img.shape
    h = flow.shape[2]
    out = img.new_empty((B, C, h, W))
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H, W,
                 h, row0, WARP_MODES.index(mode),
                 int(img.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("warp_fwd launch failed: "
                           + lib.ufr_cuda_error_string(err).decode())
    LAUNCH_COUNTS["warp_fwd"] += 1
    return out


def _warp(img: torch.Tensor, flow: torch.Tensor, mode: str,
          row0: int = 0) -> torch.Tensor:
    if mode not in WARP_MODES:
        raise ValueError(f"unknown warp mode: {mode}")
    if img.device.type == "cpu":
        return warp_backward_reference(img, flow, mode, row0)
    if img.device.type != "cuda":
        raise ValueError(f"warp_backward: unsupported device {img.device}")
    return _warp_fwd_cuda(img.contiguous(), flow.float().contiguous(), mode,
                          row0)


class _WarpBackward(torch.autograd.Function):
    """The warp with its gradient into img and flow, recomputed through the
    plain version's autograd."""

    @staticmethod
    def forward(ctx, img, flow, mode, row0):
        ctx.args = (mode, row0)
        ctx.save_for_backward(img, flow)
        return _warp(img, flow, mode, row0)

    @staticmethod
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        with torch.enable_grad():
            i = img.detach().requires_grad_(ctx.needs_input_grad[0])
            f = flow.detach().requires_grad_(ctx.needs_input_grad[1])
            out = warp_backward_reference(i, f, *ctx.args)
            wrt = [t for t in (i, f) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (next(grads) if ctx.needs_input_grad[0] else None,
                next(grads) if ctx.needs_input_grad[1] else None, None, None)


def warp_backward(img: torch.Tensor, flow: torch.Tensor,
                  mode: str = "border", plain: bool = False) -> torch.Tensor:
    """Backward-warp img (B, C, H, W) by flow (B, 2, H, W), channel 0 = u:
    out(y, x) = img(y + v, x + u), in img's dtype, in mode "border",
    "zeros_mask" or "spynet" (``warp_backward_reference`` says what each
    computes).  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors (and, with ``plain``, on every device); differentiable in img
    and flow.  Under a row-splitting spatial mesh img and flow are this
    rank's row blocks: the source is all-gathered and the block's rows of
    the whole warp are computed."""
    B, _, h, W = img.shape
    if flow.dim() != 4 or tuple(flow.shape) != (B, 2, h, W):
        raise ValueError(f"flow must be (B, 2, H, W) = ({B}, 2, {h}, {W}), "
                         f"got {tuple(flow.shape)}")
    row0 = 0
    if row_mesh() is not None:
        row0 = row_mesh().spatial_rank * h
        img = all_gather_rows(img, 2)
    if plain:
        return warp_backward_reference(img, flow, mode, row0)
    if torch.is_grad_enabled() and (img.requires_grad or flow.requires_grad):
        return _WarpBackward.apply(img, flow, mode, row0)
    return _warp(img, flow, mode, row0)
