"""Universal adversarial patch optimization on torch autograd (counterpart
of ``understanding_flow_robustness_tpu/attacks/patch_attack.py``;
reference: patch_attacks/main.py).

The inner loop (main.py:523-613) composites the patch canvas into both
frames, runs the model forward and backward to the two composited images,
updates the whole canvas and re-composites, while
``loss > loss_threshold and count < max_count``.  The JAX package runs that
loop as one jitted ``lax.while_loop``; here it is a Python loop whose
tensors stay on the device, and the condition reads the loss on the host
once per iteration, as the reference's loop does.  Placement stays numpy
on the host (``attacks/patch.py``), as does the epoch loop.

Loss (main.py:546-575): L2 ``sqrt(sum((flow - target)^2) + 1e-8).mean()`` or
``(1 - cossim).mean()`` against ``target = -clean_flow``, plus an
``alpha``-weighted L1 patch regularizer toward the initial patch; update
``patch -= clamp(0.5 * lr * (g_tgt + g_future), -2, 2)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..utils import on_device
from .losses import compute_cossim, compute_epe, cosine_similarity
from .patch import circle_transform, extract_patch, rezoom_to, square_transform


@dataclasses.dataclass(frozen=True)
class PatchAttackConfig:
    lr: float = 100.0            # patch_attacks/main.py default --lr 1e2
    alpha: float = 0.0           # patch regularizer weight
    max_count: int = 2
    l2: bool = False             # loss: l2 if True else cossim
    loss_threshold: float = 0.1
    image_clip: tuple[float, float] = (0.0, 1.0)


def make_patch_attack_step(predict: Callable, cfg: PatchAttackConfig):
    """Build the inner attack (main.py:523-613).

    predict(img1, img2) -> flow, differentiable in the images (the port's
    ``predict_flow_differentiable``: the module holds its parameters, so
    there is no ``takes_variables``).  Inputs: tgt/ref_future images,
    patch/mask/init canvases (all NHWC full-image tensors on one device),
    target flow.  Returns (adv_tgt, adv_ref_future, patch_canvas,
    final_loss, n_steps): the loss is the f32 loss evaluated in the last
    iteration, before that iteration's update (inf if none ran), as a
    0-d tensor; n_steps an int.
    """
    lo, hi = cfg.image_clip

    def loss_fn(adv_tgt, adv_ref_future, target, mask, patch, patch_init):
        flow = predict(adv_tgt, adv_ref_future)
        if cfg.l2:
            loss_data = torch.mean(
                torch.sqrt(torch.sum((flow - target) ** 2, dim=-1) + 1e-8))
        else:
            loss_data = torch.mean(1.0 - cosine_similarity(flow, target))
        loss_reg = torch.mean(torch.abs(mask * patch - mask * patch_init))
        return (1 - cfg.alpha) * loss_data + cfg.alpha * loss_reg

    def attack(tgt, ref_future, patch, mask, patch_init, target):
        def composite(p):
            return (1 - mask) * tgt + mask * p, (1 - mask) * ref_future + mask * p

        # main.py:536-541: the initial composite stays unclamped; every
        # later one is clamped after its update (main.py:585-605)
        adv_tgt, adv_ref = composite(patch)
        loss = torch.tensor(float("inf"))
        count = 0
        # the condition is the f32 comparison of the JAX package's loop,
        # read on the host: one device sync per iteration after the first
        # (whose loss is the host's inf), none after the last one when
        # max_count ends the loop
        while count < cfg.max_count and bool(loss > cfg.loss_threshold):
            x = adv_tgt.detach().requires_grad_()
            y = adv_ref.detach().requires_grad_()
            with torch.enable_grad():
                value = loss_fn(x, y, target, mask, patch, patch_init)
                g_tgt, g_ref = torch.autograd.grad(value, (x, y))
            loss = value.detach()
            patch = patch - torch.clamp(0.5 * cfg.lr * (g_tgt + g_ref),
                                        -2.0, 2.0)
            adv_tgt, adv_ref = composite(patch)
            adv_tgt = torch.clamp(adv_tgt, lo, hi)
            adv_ref = torch.clamp(adv_ref, lo, hi)
            count += 1
        return adv_tgt, adv_ref, patch, loss.to(tgt.device), count

    return attack


def train_patch_epoch(
    attack_step,
    predict,
    patch: np.ndarray,
    mask: np.ndarray,
    patch_init: np.ndarray,
    patch_shape,
    batches,
    patch_type: str = "circle",
    norotate: bool = False,
    epoch_size: int = 0,
    on_batch=None,
    device="cuda",
):
    """One optimization epoch over (tgt, ref_future) batches
    (patch_attacks/main.py:345-520): place -> attack -> extract -> re-zoom.

    ``batches`` yields (tgt_img, ref_future_img) NHWC float [0,1] numpy
    arrays; ``predict`` is the model's forward (no gradient needed) and
    ``attack_step`` the one ``make_patch_attack_step`` builds, both on
    ``device``.  ``on_batch(i, tgt, adv_tgt, patch_canvas, loss)`` (numpy,
    float) mirrors the reference's per-iteration TensorBoard dumps gated by
    --training_output_freq (main.py:463-519).
    """
    patch_shape_orig = patch_shape
    for i, (tgt, ref_future) in enumerate(batches):
        tgt_d, ref_d = on_device(tgt, device), on_device(ref_future, device)
        with torch.no_grad():
            target = -1.0 * predict(tgt_d, ref_d)
        data_shape = tgt.shape

        if patch_type == "circle":
            # margin=1: the reference passes `True` positionally into
            # margin (main.py:378-380)
            pc, mc, ic, rx, ry, patch_shape = circle_transform(
                patch, mask, patch_init, data_shape, patch_shape, margin=1
            )
        else:
            pc, mc, ic, rx, ry = square_transform(
                patch, mask, patch_init, data_shape, patch_shape,
                norotate=norotate,
            )

        adv_tgt, _, pc_new, loss, _ = attack_step(
            tgt_d, ref_d, on_device(pc, device), on_device(mc, device),
            on_device(ic, device), target,
        )
        pc_new = pc_new.cpu().numpy()
        if on_batch is not None:
            on_batch(i, np.asarray(tgt), adv_tgt.cpu().numpy(), pc_new,
                     float(loss))
        masked = pc_new * np.asarray(mc)
        patch = extract_patch(masked, rx, ry, patch_shape)
        mask_x = extract_patch(np.asarray(mc), rx, ry, patch_shape)
        init_x = extract_patch(np.asarray(ic), rx, ry, patch_shape)
        patch, mask, patch_init, patch_shape = rezoom_to(
            patch, mask_x, init_x, patch_shape, patch_shape_orig
        )
        if epoch_size and i >= epoch_size - 1:
            break
    return patch, mask, patch_init, patch_shape


def validate_patch(
    predict,
    patch: np.ndarray,
    mask: np.ndarray,
    patch_shape,
    val_samples,
    patch_type: str = "circle",
    norotate: bool = False,
    device="cuda",
):
    """validate_flow_with_gt (main.py:616-784): per-sample random placement,
    clean vs adversarial EPE/cossim.  val_samples yields
    (ref_past, tgt, ref_future, gt_flow) NHWC numpy with batch dim;
    ``predict`` runs on ``device``."""
    sums = np.zeros(4)
    n = 0
    for ref_past, tgt, ref_future, gt_flow in val_samples:
        with torch.no_grad():
            flow = predict(on_device(tgt, device),
                           on_device(ref_future, device))
        if patch_type == "circle":
            pc, mc, _, _, _, _ = circle_transform(
                patch, mask, patch.copy(), tgt.shape, patch_shape
            )
        else:
            pc, mc, _, _, _ = square_transform(
                patch, mask, patch.copy(), tgt.shape, patch_shape,
                norotate=norotate,
            )
        adv_tgt = np.clip((1 - mc) * tgt + mc * pc, 0, 1).astype(np.float32)
        adv_ref = np.clip((1 - mc) * ref_future + mc * pc, 0, 1).astype(
            np.float32
        )
        with torch.no_grad():
            adv_flow = predict(on_device(adv_tgt, device),
                               on_device(adv_ref, device))

        gt = on_device(gt_flow, device)
        sums += np.array([
            float(compute_epe(gt, flow)),
            float(compute_epe(gt, adv_flow)),
            float(compute_cossim(gt, flow)),
            float(compute_cossim(gt, adv_flow)),
        ])
        n += 1
    metrics = sums / max(n, 1)
    return {
        "epe": metrics[0], "adv_epe": metrics[1],
        "cos_sim": metrics[2], "adv_cos_sim": metrics[3],
    }
