"""Attack-run logging, sample dumps and the final aggregation (counterpart
of ``understanding_flow_robustness_tpu/attacks/log_utils.py``).

Reference: global_attacks/log_utils.py -- folder taxonomy (:33-77), PNG/NPY
sample dumps (:78-199), file and console log (:202-223), and ``validate``,
which writes the mean and std of the noise, EPE, cosine and L1 metrics to
results{seed}.txt (:226-528).  Flows are NHWC numpy arrays; the GT carries
(u, v, valid).  ``validate`` computes its flow metrics with the port's
losses on CPU tensors.  PIL is imported only by the PNG dumps.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..flowviz import flow_to_image
from . import eval_utils
from .losses import compute_cossim, compute_epe, compute_l1

SUBDIRS = [
    "image0_output_noise", "image1_output_noise",
    "image0_output_image", "image1_output_image",
    "flow_output", "flow_origin", "flow_output_noise",
]


def log(message: str, filepath: str | None = None, to_console: bool = True):
    """log_utils.py:202-223."""
    if to_console:
        print(message)
    if filepath is not None:
        os.makedirs(os.path.dirname(filepath), exist_ok=True)
        with open(filepath, "a", encoding="utf-8") as f:
            f.write(message + "\n")


def create_write_folder_structure(output_path: str) -> dict[str, str]:
    """log_utils.py:33-77: per-artifact output dirs."""
    paths = {}
    for sub in SUBDIRS:
        p = os.path.join(output_path, sub)
        os.makedirs(p, exist_ok=True)
        paths[sub] = p
    return paths


def write_out_sample(
    paths: dict[str, str],
    idx: int,
    image0=None, image1=None,
    noise0=None, noise1=None,
    flow_output=None, flow_origin=None, flow_output_noise=None,
    save_npy: bool = False,
):
    """log_utils.py:78-199: PNG (and optionally NPY) dumps of the
    adversarial images, the min-max normalised noises and the flows'
    color-wheel renderings; numpy arrays in."""
    from PIL import Image

    def save_img(arr01, folder):
        im = np.uint8(np.clip(arr01, 0, 1) * 255.0)
        Image.fromarray(im).save(
            os.path.join(paths[folder], f"{idx:05d}.png"))
        if save_npy:
            np.save(os.path.join(paths[folder], f"{idx:05d}.npy"), arr01)

    def save_noise(noise, folder):
        lo, hi = float(noise.min()), float(noise.max())
        save_img((noise - lo) / (hi - lo + 1e-12), folder)

    def save_flow(flow, folder):
        save_img(flow_to_image(np.asarray(flow)) / 255.0, folder)

    if image0 is not None:
        save_img(image0, "image0_output_image")
    if image1 is not None:
        save_img(image1, "image1_output_image")
    if noise0 is not None:
        save_noise(noise0, "image0_output_noise")
    if noise1 is not None:
        save_noise(noise1, "image1_output_noise")
    if flow_output is not None:
        save_flow(flow_output, "flow_output")
    if flow_origin is not None:
        save_flow(flow_origin, "flow_origin")
    if flow_output_noise is not None:
        save_flow(flow_output_noise, "flow_output_noise")


def validate(
    noises0, noises1, origins, outputs, ground_truths,
    output_path: str | None = None,
    seed: int = 0,
    is_disparity: bool = False,
) -> dict[str, tuple[float, float]]:
    """Aggregate attack metrics over all samples (log_utils.py:226-528):
    per-sample noise L0/L1 and the flow EPE, cosine and L1 before and after
    the attack -- or, in disparity mode (log_utils.py:251-305), MAE, RMSE
    and D1 before and after over the gt > 0 and non-NaN mask -- reported as
    (mean, std) and appended to results{seed}.txt.  Inputs are numpy
    arrays, one per sample."""
    n = len(outputs)
    flow_keys = [
        "flow_epe_origin", "flow_epe",
        "flow_cossim_unattacked", "flow_cossim_attacked",
        "flow_l1_unattacked", "flow_l1_attacked",
    ]
    disp_keys = [
        "disparity_mae_unattacked", "disparity_mae_attacked",
        "disparity_rmse_unattacked", "disparity_rmse_attacked",
        "disparity_d1_unattacked", "disparity_d1_attacked",
    ]
    cols = {k: np.zeros(n) for k in [
        "noise0_l0pix", "noise0_l1pix", "noise1_l0pix", "noise1_l1pix",
    ] + (disp_keys if is_disparity else flow_keys)}

    def t(x):  # one sample as a (1, ...) f32 CPU tensor
        return torch.from_numpy(np.asarray(x, np.float32)[None])

    for i, (n0, n1, origin, output, gt) in enumerate(
        zip(noises0, noises1, origins, outputs, ground_truths)
    ):
        cols["noise0_l0pix"][i] = eval_utils.lp_norm(n0, p=0)
        cols["noise0_l1pix"][i] = eval_utils.lp_norm(n0, p=1, axis=-1)
        cols["noise1_l0pix"][i] = eval_utils.lp_norm(n1, p=0)
        cols["noise1_l1pix"][i] = eval_utils.lp_norm(n1, p=1, axis=-1)

        if is_disparity:
            mask = np.logical_and(gt > 0.0, ~np.isnan(gt))
            cols["disparity_mae_unattacked"][i] = eval_utils.mean_abs_err(
                origin[mask], gt[mask])
            cols["disparity_mae_attacked"][i] = eval_utils.mean_abs_err(
                output[mask], gt[mask])
            cols["disparity_rmse_unattacked"][i] = (
                eval_utils.root_mean_sq_err(origin[mask], gt[mask]))
            cols["disparity_rmse_attacked"][i] = (
                eval_utils.root_mean_sq_err(output[mask], gt[mask]))
            cols["disparity_d1_unattacked"][i] = eval_utils.d1_error(
                origin[mask], gt[mask])
            cols["disparity_d1_attacked"][i] = eval_utils.d1_error(
                output[mask], gt[mask])
            continue

        gt_t, origin_t, output_t = t(gt), t(origin), t(output)
        cols["flow_epe_origin"][i] = float(compute_epe(gt_t, origin_t))
        cols["flow_epe"][i] = float(compute_epe(gt_t, output_t))
        cols["flow_cossim_unattacked"][i] = float(compute_cossim(gt_t, origin_t))
        cols["flow_cossim_attacked"][i] = float(compute_cossim(gt_t, output_t))
        cols["flow_l1_unattacked"][i] = float(compute_l1(gt_t, origin_t))
        cols["flow_l1_attacked"][i] = float(compute_l1(gt_t, output_t))

    # D1 is reported in PERCENT (log_utils.py:351-355 multiplies by 100
    # before aggregating); everything else stays in natural units
    for k in ("disparity_d1_unattacked", "disparity_d1_attacked"):
        if k in cols:
            cols[k] = cols[k] * 100.0
    results = {k: (float(v.mean()), float(v.std())) for k, v in cols.items()}

    if output_path is not None:
        path = os.path.join(output_path, f"results{seed}.txt")
        for k, (m, s) in results.items():
            log(f"{k}: {m:.6f} +/- {s:.6f}", path, to_console=False)
    return results


def find_unused_seed_results(output_path: str, seed: int) -> int:
    """Seed-collision avoidance: auto-increment until an unused
    results{seed}.txt is found (perturb_main.py:126-132)."""
    while os.path.isfile(os.path.join(output_path, f"results{seed}.txt")):
        seed += 1
    return seed
