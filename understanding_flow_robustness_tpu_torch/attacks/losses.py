"""Flow attack and evaluation losses, NHWC (counterpart of
``understanding_flow_robustness_tpu/attacks/losses.py``).

References: patch_attacks/losses.py:8-59 and
global_attacks/perturb_model.py:38-145.  Ground-truth tensors carry an
optional third channel, the valid mask; every reduction follows the
reference's valid-masked mean with eps = 1e-8.  Differentiable: the attacks
take the gradient of ``flow_attack_loss`` with respect to the images.

Inside a spatial context (``parallel/spatial.py``; ``make_spatial_attack``)
the tensors are a rank's (batch slice, row block): every sum and count of
these means runs over the whole mesh (``grid_total``), so each rank holds
the one-device loss and its gradient scale.
"""

from __future__ import annotations

import torch

from ..ops.interp import resize_bilinear
from ..parallel.spatial import current_mesh, grid_total

EPSILON = 1e-8


def _sum(x: torch.Tensor) -> torch.Tensor:
    """torch.sum(x), over the whole mesh inside a spatial context."""
    return grid_total(torch.sum(x))


def _mean(x: torch.Tensor) -> torch.Tensor:
    """torch.mean(x), over the whole mesh inside a spatial context."""
    if current_mesh() is None:
        return torch.mean(x)
    return _sum(x) / grid_total(torch.tensor(float(x.numel()),
                                             device=x.device))


def _upsample_pred(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Bilinear-resize pred (B, h, w, 2) to the GT's size and scale u, v by
    the size ratio (patch_attacks/losses.py:11-15; F.upsample with
    align_corners=False)."""
    h_gt, w_gt = gt.shape[1:3]
    h_pred, w_pred = pred.shape[1:3]
    pred = resize_bilinear(pred.permute(0, 3, 1, 2), h_gt, w_gt,
                           align_corners=False).permute(0, 2, 3, 1)
    scale = torch.tensor([w_gt / w_pred, h_gt / h_pred], dtype=pred.dtype,
                         device=pred.device)
    return pred * scale


def compute_epe(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Valid-masked mean end-point error (patch_attacks/losses.py:8-28)."""
    pred = _upsample_pred(gt, pred)
    epe = torch.sqrt((gt[..., 0] - pred[..., 0]) ** 2
                     + (gt[..., 1] - pred[..., 1]) ** 2)
    if gt.shape[-1] == 3:
        valid = gt[..., 2]
        return _sum(epe * valid) / (_sum(valid) + EPSILON)
    return _mean(epe)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """``torch.nn.functional.cosine_similarity``'s semantics as the JAX
    package writes them: <a, b> / (max(|a|, eps) max(|b|, eps))."""
    na = torch.clamp(torch.linalg.vector_norm(a, dim=dim), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=dim), min=eps)
    return torch.sum(a * b, dim=dim) / (na * nb)


def compute_cossim(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """patch_attacks/losses.py:31-50."""
    pred = _upsample_pred(gt, pred)
    sim = cosine_similarity(gt[..., :2], pred)
    if gt.shape[-1] == 3:
        valid = gt[..., 2]
        return _sum(sim * valid) / (_sum(valid) + EPSILON)
    return _mean(sim)


def compute_l1(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """global_attacks/perturb_model.py:85-99: the mean over the non-NaN
    elements only (the reference indexes with ~isnan, :93); all NaN gives
    0/0 = NaN, as torch.mean of an empty tensor does."""
    pred = _upsample_pred(gt, pred)
    l1 = torch.abs(pred - gt[..., :2])
    notnan = ~torch.isnan(l1)
    l1_mean = (_sum(torch.where(notnan, l1, torch.zeros_like(l1)))
               / _sum(notnan))
    if gt.shape[-1] == 3:
        valid = gt[..., 2]
        return _sum(l1_mean * valid) / (_sum(valid) + EPSILON)
    return l1_mean


def multiscale_cossim(gts, preds) -> torch.Tensor:
    """patch_attacks/losses.py:53-59: the sum of -mean cosine similarity
    over the scales."""
    loss = 0.0
    for gt, pred in zip(gts, preds):
        loss = loss - torch.mean(cosine_similarity(gt, pred))
    return loss


def flow_attack_loss(flow_pred: torch.Tensor, ground_truth: torch.Tensor,
                     flow_loss: str = "cossim") -> torch.Tensor:
    """compute_flow_loss (global_attacks/perturb_model.py:102-145): the
    prediction is compared at its own resolution (the attack pipeline
    gives GT and prediction one size)."""
    gt2 = ground_truth[..., :2]
    if flow_loss == "cossim":
        loss = 1.0 - cosine_similarity(flow_pred, gt2)
    elif flow_loss == "l2":
        loss = torch.sqrt(torch.sum((flow_pred - gt2) ** 2, dim=-1) + 1e-7)
    elif flow_loss == "l1":
        loss = torch.abs(flow_pred - gt2)
    else:
        raise NotImplementedError(flow_loss)

    if ground_truth.shape[-1] == 3:
        valid = ground_truth[..., 2]
        if flow_loss == "l1":
            loss = loss * valid[..., None]
        else:
            loss = loss * valid
        return _sum(loss) / (_sum(valid) + EPSILON)
    return _mean(loss)
