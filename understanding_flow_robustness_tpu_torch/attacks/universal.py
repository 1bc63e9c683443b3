"""Universal perturbation trainer on torch autograd (counterpart of
``understanding_flow_robustness_tpu/attacks/universal.py``; reference:
global_attacks/universal_perturbation.py:161-726).

A single shared two-frame perturbation pair is optimized over a dataset:
per batch, n-step I-FGSM *descent* toward target = -clean_flow (or ascent
toward a gaussian-noised clean flow with --add_gaussian), the accumulated
noise clamped to the eps-ball each step (:452-530).  The inner n-step loop
runs on the device (the JAX package jits it as one ``lax.fori_loop``); the
epoch loop and the per-epoch snapshots stay on the host (:348).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from ..utils import on_device
from .losses import flow_attack_loss


@dataclasses.dataclass(frozen=True)
class UniversalConfig:
    perturb_method: str = "ifgsm"     # ifgsm | ifgm
    perturb_mode: str = "both"
    output_norm: float = 0.02
    n_step: int = 40
    learning_rate: float = 2e-3
    flow_loss: str = "l2"
    add_gaussian: bool = False        # ascent with noisy target


def make_universal_attack_step(predict: Callable, cfg: UniversalConfig):
    """The inner attack: (img0, img1, noise0, noise1, target) ->
    (adv0, adv1, new_noise0, new_noise1), NHWC tensors on one device;
    ``predict`` is differentiable in the images."""
    # reference dispatch (universal_perturbation.py:477-500): substring
    # match — so e.g. "mifgsm" runs the sign path there too — exact
    # "ifgm" for raw gradients, anything else rejected
    use_sign = "ifgsm" in cfg.perturb_method
    if not use_sign and cfg.perturb_method != "ifgm":
        raise NotImplementedError(
            f"universal perturbation method: {cfg.perturb_method}")
    if cfg.perturb_mode not in ("both", "left", "right"):
        raise ValueError(f"Invalid perturbation mode: {cfg.perturb_mode}")
    m0 = 0.0 if cfg.perturb_mode == "right" else 1.0
    m1 = 0.0 if cfg.perturb_mode == "left" else 1.0
    descent = not cfg.add_gaussian
    eps = cfg.output_norm

    def attack(img0, img1, noise0, noise1, target):
        adv0 = torch.clamp(img0 + noise0, 0.0, 1.0)
        adv1 = torch.clamp(img1 + noise1, 0.0, 1.0)
        for _ in range(cfg.n_step):
            x = adv0.detach().requires_grad_()
            y = adv1.detach().requires_grad_()
            with torch.enable_grad():
                loss = flow_attack_loss(predict(x, y), target, cfg.flow_loss)
                g0, g1 = torch.autograd.grad(loss, (x, y))
            if use_sign:
                g0, g1 = torch.sign(g0), torch.sign(g1)
            step0 = cfg.learning_rate * g0 * m0
            step1 = cfg.learning_rate * g1 * m1
            if descent:
                adv0 = torch.clamp(adv0 - step0, 0.0, 1.0)
                adv1 = torch.clamp(adv1 - step1, 0.0, 1.0)
            else:
                adv0 = torch.clamp(adv0 + step0, 0.0, 1.0)
                adv1 = torch.clamp(adv1 + step1, 0.0, 1.0)
            n0 = torch.clamp(adv0 - img0, -eps, eps)
            n1 = torch.clamp(adv1 - img1, -eps, eps)
            adv0, adv1 = img0 + n0, img1 + n1
        return adv0, adv1, adv0 - img0, adv1 - img1

    return attack


def train_universal_perturbation(
    predict,
    attack_step,
    batches,
    image_shape,
    cfg: UniversalConfig,
    epochs: int = 1,
    epoch_size: int = 0,
    save_dir: str | None = None,
    rng: np.random.RandomState | None = None,
    on_epoch_end: Callable | None = None,
    on_batch_end: Callable | None = None,
    logger=None,
    device="cuda",
):
    """Epoch loop (universal_perturbation.py:354-449): the perturbation pair
    persists across batches on ``device``; per-epoch snapshots go to
    ``save_dir/perturbations/epoch_N.npy``, (1, 2, H, W, 3).  ``predict``
    is the model's forward (no gradient needed).  ``on_batch_end(tgt, ref,
    noise0, noise1)`` (tensors) mirrors the reference's per-iteration
    TensorBoard dumps (:399-442); ``on_epoch_end(epoch, noise0, noise1)``
    gets numpy; ``logger`` is an optional TermLogger whose train bar is
    advanced per batch (:445-446).  Returns the final pair as numpy."""
    rng = rng or np.random.RandomState(0)
    noise0 = torch.zeros(image_shape, dtype=torch.float32, device=device)
    noise1 = torch.zeros(image_shape, dtype=torch.float32, device=device)

    for epoch in range(epochs):
        if logger is not None:
            logger.epoch_bar.update(epoch)
            logger.reset_train_bar()
        for i, (tgt, ref_future) in enumerate(batches()):
            tgt = on_device(tgt, device)
            ref_future = on_device(ref_future, device)
            with torch.no_grad():
                flow = predict(tgt, ref_future)
            if cfg.add_gaussian:
                target = flow + on_device(
                    rng.randn(*flow.shape).astype(np.float32), device)
            else:
                target = -1.0 * flow
            _, _, noise0, noise1 = attack_step(
                tgt, ref_future, noise0, noise1, target)
            if on_batch_end is not None:
                on_batch_end(tgt, ref_future, noise0, noise1)
            if logger is not None:
                logger.train_bar.update(i + 1)
            if epoch_size and i >= epoch_size - 1:
                break
        n0, n1 = noise0.cpu().numpy(), noise1.cpu().numpy()
        if save_dir is not None:
            d = os.path.join(save_dir, "perturbations")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"epoch_{epoch}.npy"),
                    np.stack([n0, n1], axis=1))
        if on_epoch_end is not None:
            on_epoch_end(epoch, n0, n1)
    return noise0.cpu().numpy(), noise1.cpu().numpy()
