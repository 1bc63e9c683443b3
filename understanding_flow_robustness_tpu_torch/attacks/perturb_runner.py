"""Global-attack evaluation runner (counterpart of
``understanding_flow_robustness_tpu/attacks/perturb_runner.py``; reference:
global_attacks/perturb_main.py).

``run()`` reproduces the reference pipeline (:48-814): per frame pair the
clean flow, the attack (white-box, noise, an image corruption, or a
re-applied universal or fixed noise), the adversarial flow and the
noise-only flow, with sample dumps, per-frame timing and the final
``validate`` aggregation.  The attack runs step by step on torch autograd
(``global_attacks.make_attack``) on ``RunConfig.device``, the card unless
the caller asks for the CPU; a corruption runs on the host
(``corruptions.corrupt_pair``) and its pair is copied to that device.  Not
ported: the JAX package's mesh branch (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..utils import on_device
from . import log_utils
from .corruptions import check_severity, corrupt_pair, get_corruption_names
from .global_attacks import (
    PerturbConfig,
    PredictFn,
    make_attack,
    perturb_trajectory,
)
from .losses import compute_epe

WHITEBOX_METHODS = ("fgsm", "fgm", "ifgsm", "ifgm", "mifgsm", "mifgm",
                    "gaussian", "uniform", "none")
CORRUPTIONS = tuple(get_corruption_names("all"))


def _write_evolution_gifs(path: str, tr0: np.ndarray, tr1: np.ndarray):
    """Perturbation-evolution GIFs (perturb_model.py:582-614): each step's
    noise is min-max normalised to uint8; files are named viz{ctr}_0.gif /
    viz{ctr}_1.gif with the first unused ctr, total duration ~20 ms."""
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    ctr = 0
    while os.path.isfile(os.path.join(path, f"viz{ctr}_0.gif")):
        ctr += 1
    for suffix, tr in (("0", tr0), ("1", tr1)):
        frames = []
        for step in range(tr.shape[0]):
            n = tr[step, 0]
            lo, hi = n.min(), n.max()
            frames.append(Image.fromarray(
                np.uint8((n - lo) / (hi - lo + 1e-12) * 255.0)))
        frames[0].save(
            os.path.join(path, f"viz{ctr}_{suffix}.gif"), save_all=True,
            append_images=frames[1:],
            # reference: imageio duration=20/n_step SECONDS per frame
            # (perturb_model.py:610-614); PIL's duration is milliseconds
            duration=max(int(20.0 / max(tr.shape[0], 1) * 1000.0), 1),
            loop=0,
        )


@dataclasses.dataclass
class RunConfig:
    flownet: str = "FlowNetC"
    perturb: PerturbConfig = dataclasses.field(default_factory=PerturbConfig)
    n_height: int = 256
    n_width: int = 640
    output_path: str = "output/perturb"
    seed: int = 0
    write_out_frequency: int = 0        # dump every Nth sample (0 = off)
    save_npy: bool = False
    universal_perturbation_path: Optional[str] = None
    arbitrary_gt: Optional[np.ndarray] = None   # fixed target for all pairs
    # fixed noise pair re-applied to every sample (the reference's
    # arbitrary_noise_index branch, perturb_main.py:385-448): (2, H, W, 3)
    arbitrary_noise: Optional[np.ndarray] = None
    # --homogeneous (perturb_main.py:477-481): second frame := first frame,
    # full-res GT := zeros (the downsampled attack target is left alone,
    # exactly like the reference's unpack order).
    homogeneous: bool = False
    # --uniform_noise universal baseline (perturb_main.py:451-457): one
    # uniform noise pair in [-output_norm, output_norm] drawn once and
    # applied to every sample.
    uniform_noise: bool = False
    # --show_evolve (perturb_model.py:497,582,604-614): directory for
    # per-attack perturbation-evolution GIFs (iterative methods only).
    show_evolve_path: Optional[str] = None
    # where the images, the attack and the noise draws live
    device: str = "cuda"
    # the corruptions' draws (an np.random.RandomState); None: numpy's
    # global state, as the JAX package's runner draws
    corruption_rng: Optional[np.random.RandomState] = None


def build_arbitrary_gt(kind: str, helper_gt: np.ndarray,
                       rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Arbitrary attack targets (perturb_main.py:244-383):

    * digit index -- handled by the caller (a dataset sample's GT)
    * "fun"       -- a flow field drawing "42" (+-90 px strokes on a -5 field)
    * "uniform_N" -- random U(-180, 180) blocks of size N
    helper_gt: (H, W, 3) NHWC (u, v, valid).
    """
    rng = rng or np.random.RandomState(0)
    H, W = helper_gt.shape[:2]
    if kind == "fun":
        gt = np.full_like(helper_gt, -5.0)
        thickness, margin = 50, 20
        idx = np.zeros((H, W), bool)
        # "4"
        idx[margin : 256 - margin, 225 : 225 + thickness] = True
        idx[margin : 128, 125 : 125 + thickness] = True
        idx[128 - thickness // 2 : 128 + thickness // 2,
            125 : 225 + thickness] = True
        gt[idx, 0] = -90
        gt[idx, 1] = -90
        # "2"
        idx = np.zeros((H, W), bool)
        idx[margin : margin + thickness, 400 : 500 + thickness] = True
        idx[128 - thickness // 2 : 128 + thickness // 2,
            400 : 500 + thickness] = True
        idx[256 - margin - thickness : 256 - margin,
            400 : 500 + thickness] = True
        idx[margin : 128, 500 : 500 + thickness] = True
        idx[128 : 256 - margin, 400 : 400 + thickness] = True
        gt[idx, 0] = 90
        gt[idx, 1] = 90
        gt[..., 2] = 1
        return gt
    if kind.startswith("uniform"):
        factor = int(kind[kind.rfind("_") + 1 :])
        hs, ws = H // factor, W // factor
        small = rng.uniform(
            -180, 180, (hs, ws, helper_gt.shape[2])
        ).astype(np.float32)
        # torch F.interpolate(mode="nearest") to the FULL size
        # (perturb_main.py:358-363): src index = floor(dst * in / out)
        iy = np.arange(H) * hs // H
        ix = np.arange(W) * ws // W
        gt = small[iy][:, ix]
        gt[..., 2] = 1
        return gt
    raise ValueError(kind)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(predict: PredictFn, samples: Iterable, cfg: RunConfig) -> dict:
    """Attack-evaluate over (img0, img1, gt_small, gt_full) samples, NHWC
    numpy in [0, 1] with the batch dimension.  ``predict`` is
    differentiable in the images (``predict_flow_differentiable``); the
    clean, adversarial and noise-only flows run it without autograd.
    Returns the aggregate metrics dict (plus ``time_per_frame``, wall
    seconds per frame with the device synchronised) and writes
    results{seed}.txt and log{seed}.txt under the output path.  A
    corruption's severity is ``int(cfg.perturb.output_norm)``, 1-5."""
    method = cfg.perturb.perturb_method
    is_corruption = method in CORRUPTIONS
    if is_corruption:
        check_severity(int(cfg.perturb.output_norm))
    elif method not in WHITEBOX_METHODS:
        # fail BEFORE creating output dirs, with the reference's explicit
        # dispatch error (perturb_model.py:270-272)
        raise ValueError(f"Invalid perturbation method: {method}")
    device = torch.device(cfg.device)

    os.makedirs(cfg.output_path, exist_ok=True)
    seed = log_utils.find_unused_seed_results(cfg.output_path, cfg.seed)
    paths = log_utils.create_write_folder_structure(cfg.output_path)
    logf = os.path.join(cfg.output_path, f"log{seed}.txt")

    if is_corruption:
        attack = None
    elif cfg.show_evolve_path:
        def attack(i0, i1, t, gen):
            outs, (tr0, tr1) = perturb_trajectory(predict, i0, i1, t,
                                                  cfg.perturb, gen)
            _write_evolution_gifs(cfg.show_evolve_path,
                                  tr0.cpu().numpy(), tr1.cpu().numpy())
            return outs
    else:
        attack = make_attack(predict, cfg.perturb)

    def predict_eval(a, b):
        with torch.no_grad():
            return predict(a, b)

    universal = None
    if cfg.universal_perturbation_path:
        universal = np.load(cfg.universal_perturbation_path)
    uniform_universal = None
    if cfg.uniform_noise:
        # drawn ONCE before the sample loop (perturb_main.py:451-457;
        # upstream hardcodes its default 256x640 geometry -- drawn at the
        # configured size so other geometries work, as the JAX package does)
        eps = float(cfg.perturb.output_norm)
        rng = np.random.RandomState(cfg.seed if cfg.seed > 0 else 0)
        uniform_universal = (
            rng.rand(2, 1, cfg.n_height, cfg.n_width, 3).astype(np.float32)
            * 2 * eps - eps
        )

    generator = torch.Generator(device=device).manual_seed(seed)
    noises0, noises1, origins, outputs, gts = [], [], [], [], []
    _sync(device)
    t_start = time.time()

    for img0, img1, gt_small, gt_full in samples:
        img0, img1 = on_device(img0, device), on_device(img1, device)
        if cfg.homogeneous:
            # perturb_main.py:477-481: identical frames, zeroed full-res GT
            # (the attack target gt_small is computed before this upstream
            # and is intentionally NOT zeroed)
            img1 = img0
            gt_full = np.zeros_like(np.asarray(gt_full))
        flow_origin = predict_eval(img0, img1)

        if cfg.arbitrary_gt is not None:
            target = on_device(cfg.arbitrary_gt, device)[None].expand(
                (img0.shape[0],) + cfg.arbitrary_gt.shape)
        else:
            target = on_device(gt_small, device)

        fixed = None
        if cfg.arbitrary_noise is not None:
            fixed = (cfg.arbitrary_noise[0][None], cfg.arbitrary_noise[1][None])
        elif uniform_universal is not None:
            fixed = (uniform_universal[0], uniform_universal[1])
        elif universal is not None:
            # re-apply a pre-trained universal perturbation
            # (perturb_main.py:450-464)
            fixed = (universal[:, 0], universal[:, 1])
        if fixed is not None:
            adv0 = torch.clamp(img0 + on_device(fixed[0], device), 0.0, 1.0)
            adv1 = torch.clamp(img1 + on_device(fixed[1], device), 0.0, 1.0)
            noise0, noise1 = adv0 - img0, adv1 - img1
        elif is_corruption:
            # on the host, then onto the run's device (perturb_runner.py:
            # 270-278 of the JAX package)
            out0, out1 = corrupt_pair(
                img0.cpu().numpy(), img1.cpu().numpy(), method,
                int(cfg.perturb.output_norm), mode=cfg.perturb.perturb_mode,
                rng=cfg.corruption_rng)
            adv0 = on_device(np.clip(out0, 0, 1), device)
            adv1 = on_device(np.clip(out1, 0, 1), device)
            noise0, noise1 = adv0 - img0, adv1 - img1
        else:
            noise0, noise1, adv0, adv1 = attack(img0, img1, target, generator)

        flow_output = predict_eval(adv0, adv1)

        # noise-only prediction (perturb_main.py:627-650): normalise each
        # noise into [0, 1] and run the model on it
        def norm01(x):
            lo, hi = torch.min(x), torch.max(x)
            return (x - lo) / (hi - lo + 1e-12)

        flow_noise = predict_eval(norm01(noise0), norm01(noise1))

        gt_full_t = torch.as_tensor(np.asarray(gt_full, np.float32))
        host = {k: v.detach().cpu() for k, v in (
            ("noise0", noise0), ("noise1", noise1), ("origin", flow_origin),
            ("output", flow_output), ("adv0", adv0), ("adv1", adv1),
            ("flow_noise", flow_noise))}
        for b in range(int(img0.shape[0])):
            noises0.append(host["noise0"][b].numpy())
            noises1.append(host["noise1"][b].numpy())
            origins.append(host["origin"][b].numpy())
            outputs.append(host["output"][b].numpy())
            gts.append(gt_full_t[b].numpy())

            j = len(outputs) - 1
            if cfg.write_out_frequency and j % cfg.write_out_frequency == 0:
                log_utils.write_out_sample(
                    paths, j,
                    image0=host["adv0"][b].numpy(),
                    image1=host["adv1"][b].numpy(),
                    noise0=noises0[-1], noise1=noises1[-1],
                    flow_output=outputs[-1], flow_origin=origins[-1],
                    flow_output_noise=host["flow_noise"][b].numpy(),
                    save_npy=cfg.save_npy,
                )

            epe_before = float(compute_epe(gt_full_t[b:b + 1],
                                           host["origin"][b:b + 1]))
            epe_after = float(compute_epe(gt_full_t[b:b + 1],
                                          host["output"][b:b + 1]))
            log_utils.log(f"[{j}] epe {epe_before:.3f} -> {epe_after:.3f}",
                          logf, to_console=False)

        if cfg.homogeneous:
            # the homogeneous experiment evaluates exactly ONE sample
            # (perturb_main.py:777-778 breaks after the first iteration)
            break

    _sync(device)
    n = max(len(outputs), 1)
    per_frame = (time.time() - t_start) / n
    results = log_utils.validate(
        noises0, noises1, origins, outputs, gts,
        output_path=cfg.output_path, seed=seed,
    )
    log_utils.log(f"time_per_frame: {per_frame:.3f}s", logf, to_console=False)
    results["time_per_frame"] = (per_frame, 0.0)
    return results
