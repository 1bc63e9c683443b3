"""Training losses (counterpart of
``understanding_flow_robustness_tpu/training/losses.py``; reference:
training/utils.py:68-222).

``sequence_loss``: RAFT-style L1 over the per-iteration prediction list
with gamma^(N-1-i) weights and the valid & |gt| < MAX_FLOW mask, or the
FlowNetC/PWC per-scale branch.  ``multiscale_epe``: per-scale EPE against
area-resized ground truth with the classic [0.005, 0.01, 0.02, 0.08, 0.32]
weights or gamma^i.

Channels-last, as in the JAX package: flows are (B, H, W, 2), valid is
(B, H, W).

With ``mesh`` (data parallelism) the inputs are this rank's slice of the
batch and every mean divides by the count of the GLOBAL batch, as the JAX
package's pjit step computes it: the counts of kept (valid, non-NaN)
elements are all-reduced (they carry no gradient), the numerators stay
local.  The loss and each metric returned are then this rank's share, and
their sum over the ranks is the global value: the train step all-reduces
them, and its summed gradients are the global loss's.  The JAX package's packed 1/8-resolution loss is TPU layout
machinery and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum

MAX_FLOW = 400.0
_CLASSIC_WEIGHTS = (0.005, 0.01, 0.02, 0.08, 0.32)


def _area_resize(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """torch's ``F.interpolate(mode="area")`` on a (B, H, W, C) tensor:
    adaptive average pooling with variable bins, [floor(i*H/h),
    ceil((i+1)*H/h)) (losses.py:22-48)."""
    if tuple(flow.shape[1:3]) == (h, w):
        return flow
    out = F.interpolate(flow.permute(0, 3, 1, 2), size=(h, w), mode="area")
    return out.permute(0, 2, 3, 1)


def _count(n: torch.Tensor, mesh) -> torch.Tensor:
    """A count over this rank's slice -> over the global batch, >= 1."""
    if mesh is not None:
        n = all_reduce_sum(mesh, n.detach().clone())
    return torch.clamp(n, min=1.0)


def _mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """``torch.mean`` over the global batch (this rank's share)."""
    if mesh is None or mesh.world == 1:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * mesh.world)


def _nanmean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean over the non-NaN elements (the reference's
    ``x[~isnan(x)].mean()``); 0 when every element is NaN."""
    m = ~torch.isnan(x)
    return torch.sum(torch.where(m, x, torch.zeros_like(x))) / _count(
        torch.sum(m.to(x.dtype)), mesh)


def _keep_mask(flow_gt: torch.Tensor, valid: torch.Tensor,
               max_flow: float) -> torch.Tensor:
    """valid & |gt| < max_flow.  The reference's ``not_excluding`` is a dead
    no-op (utils.py:88-91), accepted and ignored here as in the JAX
    package."""
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    return (valid >= 0.5) & (mag < max_flow)


def _scaled_gt(flow_gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """GT area-resized to pred's size, u and v scaled by the size ratios."""
    h, w = pred.shape[1:3]
    scale = torch.tensor([w / flow_gt.shape[2], h / flow_gt.shape[1]],
                         dtype=pred.dtype, device=pred.device)
    return _area_resize(flow_gt, h, w) * scale


def _epe_metrics(epe: torch.Tensor, mask: torch.Tensor, mesh) -> dict:
    keep = mask.to(epe.dtype)
    n = _count(torch.sum(keep), mesh)
    return {
        "epe": torch.sum(epe * keep) / n,
        "1px": torch.sum((epe < 1).float() * keep) / n,
        "3px": torch.sum((epe < 3).float() * keep) / n,
        "5px": torch.sum((epe < 5).float() * keep) / n,
    }


def sequence_loss(flow_preds, flow_gt: torch.Tensor, valid: torch.Tensor,
                  gamma: float = 0.8, max_flow: float = MAX_FLOW,
                  flownetc: bool = False, pwc: bool = False,
                  not_excluding: bool = False, div_flow: float = 1.0,
                  flownetc_weighing: bool = False, mesh=None):
    """training/utils.py:148-222.  Returns (loss, metrics dict of 0-d
    tensors).  The RAFT branch's mean runs over B*H*W*2; the EPE metrics
    are masked means over the final (RAFT) or first (FlowNetC/PWC)
    prediction."""
    n = len(flow_preds)
    if div_flow > 1:
        flow_gt = flow_gt / div_flow
    keep = _keep_mask(flow_gt, valid, max_flow)

    loss = 0.0
    for i, pred in enumerate(flow_preds):
        if flownetc or pwc:
            i_loss = torch.abs(pred - _scaled_gt(flow_gt, pred))
            # the reference's weight ternary checks flowNetC alone
            # (utils.py:186-189): PWC without it gets gamma^(n-1-i)
            if flownetc_weighing:
                weight = _CLASSIC_WEIGHTS[i]
            elif flownetc:
                weight = gamma ** i
            else:
                weight = gamma ** (n - i - 1)
            loss = loss + weight * _nanmean(i_loss, mesh)
        else:
            i_loss = torch.abs(pred - flow_gt)
            weight = gamma ** (n - i - 1)
            loss = loss + weight * _mean(
                keep[..., None].to(i_loss.dtype) * i_loss, mesh)

    if flownetc or pwc:
        epe = torch.linalg.vector_norm(
            flow_preds[0] - _scaled_gt(flow_gt, flow_preds[0]), dim=-1)
        epe_mask = torch.ones_like(epe, dtype=torch.bool)
    else:
        epe = torch.linalg.vector_norm(flow_preds[-1] - flow_gt, dim=-1)
        epe_mask = keep
    return loss, _epe_metrics(epe, epe_mask, mesh)


def multiscale_epe(flow_preds, flow_gt: torch.Tensor, valid: torch.Tensor,
                   gamma: float = 0.8, max_flow: float = MAX_FLOW,
                   flownetc: bool = False, pwc: bool = False,
                   not_excluding: bool = False, div_flow: float = 1.0,
                   flownetc_weighing: bool = False, mesh=None):
    """training/utils.py:68-145: per-scale sqrt-sum-squared EPE maps against
    area-resized GT (u/v-rescaled for the loss, not for the EPE metric).
    Returns (loss, metrics) with ``loss`` also among the metrics."""
    n = len(flow_preds)
    eps = 1e-5
    if div_flow > 1:
        flow_gt = flow_gt / div_flow
    keep = _keep_mask(flow_gt, valid, max_flow)

    loss = 0.0
    for i, pred in enumerate(flow_preds):
        if flownetc or pwc:
            d = pred - _scaled_gt(flow_gt, pred)
            epe_map = torch.sqrt(torch.sum(d ** 2, dim=-1) + eps)
            # here the reference checks ``flowNetC or pwc`` (utils.py:103-105)
            weight = _CLASSIC_WEIGHTS[i] if flownetc_weighing else gamma ** i
            loss = loss + weight * _nanmean(epe_map, mesh)
        else:
            i_loss = torch.abs(pred - flow_gt)
            weight = gamma ** (n - i - 1)
            loss = loss + weight * _mean(
                keep[..., None].to(i_loss.dtype) * i_loss, mesh)

    if flownetc or pwc:
        h, w = flow_preds[0].shape[1:3]
        epe = torch.sqrt(torch.sum(
            (flow_preds[0] - _area_resize(flow_gt, h, w)) ** 2, dim=-1))
        # utils.py:96-97: the multiscale EPE metric drops NaNs
        epe_mask = ~torch.isnan(epe)
        epe = torch.where(epe_mask, epe, torch.zeros_like(epe))
    else:
        epe = torch.linalg.vector_norm(flow_preds[-1] - flow_gt, dim=-1)
        epe_mask = keep
    return loss, dict(_epe_metrics(epe, epe_mask, mesh), loss=loss)
