"""Validation and benchmark submissions (counterpart of
``understanding_flow_robustness_tpu/training/evaluate.py``; reference:
training/evaluate.py).

``validate_chairs/sintel/kitti`` with the reference metrics (EPE, 1/3/5 px,
KITTI F1 = EPE > 3 px AND EPE/|gt| > 0.05 over valid pixels,
evaluate.py:374-389) and the Sintel (warm-start) / KITTI submission
writers (:200-267).  Models come in as ``FlowModel``s (``models.registry``)
on their device; frames are padded on the host by the InputPadder rule,
one sample at a time (KITTI frames differ in size), and the flow is
unpadded on the host.  The JAX package's mesh-sharded KITTI validation is
not ported yet (ROADMAP A13).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.loader import pad_batch
from ..flowviz.io import write_flo, write_flow_png
from ..models.registry import predict_flow
from ..ops.interp import remove_pad


def _predict_padded(model, img1, img2, mode="sintel") -> np.ndarray:
    """Pad to the model's size multiple, predict, unpad.  NHWC images in
    [0, 1] on the host -> NHWC flow on the host."""
    img1, img2, _, _, pad = pad_batch(
        img1, img2, None, None, multiple=model.size_multiple, mode=mode)
    flow = predict_flow(model, torch.from_numpy(img1).to(model.device),
                        torch.from_numpy(img2).to(model.device))
    return remove_pad(flow.float().cpu().numpy(), pad)


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Warm-start propagation (models/raft/utils/utils.py:33-60): scatter
    the (H, W, 2) flow forward and fill holes by nearest-neighbour
    griddata."""
    from scipy import interpolate

    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    flow_x = interpolate.griddata(
        (x1[valid], y1[valid]), dxf[valid], (x0, y0), method="nearest",
        fill_value=0)
    flow_y = interpolate.griddata(
        (x1[valid], y1[valid]), dyf[valid], (x0, y0), method="nearest",
        fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)


def validate_chairs(model, dataset) -> dict:
    """evaluate.py:271-296."""
    epe_list = []
    for i in range(len(dataset)):
        img1, img2, flow_gt, _ = dataset[i]
        flow = _predict_padded(model, img1[None] / 255.0, img2[None] / 255.0)
        epe = np.sqrt(np.sum((flow[0] - flow_gt) ** 2, axis=-1))
        epe_list.append(epe.reshape(-1))
    epe = float(np.mean(np.concatenate(epe_list)))
    print(f"Validation Chairs EPE: {epe:.3f}")
    return {"chairs": epe}


def validate_sintel(model, dataset_fn) -> dict:
    """evaluate.py:299-345.  dataset_fn(dstype) -> dataset."""
    results = {}
    for dstype in ["clean", "final"]:
        dataset = dataset_fn(dstype)
        epe_list = []
        for i in range(len(dataset)):
            img1, img2, flow_gt, _ = dataset[i]
            flow = _predict_padded(
                model, img1[None] / 255.0, img2[None] / 255.0, mode="sintel")
            epe = np.sqrt(np.sum((flow[0] - flow_gt) ** 2, axis=-1))
            epe_list.append(epe.reshape(-1))
        epe_all = np.concatenate(epe_list)
        print(
            "Validation (%s) EPE: %f, 1px: %f, 3px: %f, 5px: %f"
            % (dstype, epe_all.mean(), (epe_all < 1).mean(),
               (epe_all < 3).mean(), (epe_all < 5).mean()))
        results[dstype] = float(epe_all.mean())
    return results


def validate_kitti(model, dataset, mesh=None) -> dict:
    """evaluate.py:348-392: EPE (mean of the per-sample means) and F1 (the
    share in % of all valid pixels that are outliers: EPE > 3 and
    EPE / |gt| > 0.05, :381)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded KITTI validation is not ported yet (ROADMAP A13)")
    out_list, epe_list = [], []
    for i in range(len(dataset)):
        img1, img2, flow_gt, valid_gt = dataset[i]
        flow = _predict_padded(
            model, img1[None] / 255.0, img2[None] / 255.0, mode="kitti")[0]
        epe = np.sqrt(np.sum((flow - flow_gt) ** 2, axis=-1))
        mag = np.sqrt(np.sum(flow_gt ** 2, axis=-1))
        val = valid_gt >= 0.5
        out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-9)) > 0.05)
        epe_list.append(epe[val].mean())
        out_list.append(out[val])
    epe = float(np.mean(epe_list))
    f1 = 100 * float(np.mean(np.concatenate(out_list)))
    print(f"Validation KITTI: {epe:.6f}, {f1:.6f}")
    return {"kitti-epe": epe, "kitti-f1": f1}


def create_sintel_submission(model, dataset_fn, output_path="sintel_submission",
                             warm_start: bool = False):
    """evaluate.py:200-240: .flo files per scene and frame, with the
    optional warm start (RAFT only): the previous pair's low-resolution
    flow, forward-interpolated, initialises the next pair of a scene."""
    for dstype in ["clean", "final"]:
        dataset = dataset_fn(dstype)
        flow_prev, sequence_prev = None, None
        for i in range(len(dataset)):
            img1, img2, (sequence, frame) = dataset[i]
            if sequence != sequence_prev:
                flow_prev = None
            img1b, img2b, _, _, pad = pad_batch(
                img1[None] / 255.0, img2[None] / 255.0, None, None,
                multiple=model.size_multiple, mode="sintel")
            a = torch.from_numpy(img1b).to(model.device)
            b = torch.from_numpy(img2b).to(model.device)
            if model.is_raft:
                init = None
                if flow_prev is not None and warm_start:
                    init = torch.from_numpy(flow_prev).to(
                        model.device).permute(2, 0, 1)[None]
                with torch.inference_mode():
                    flow_low, flow_pr = model.module(
                        a.permute(0, 3, 1, 2) * 255.0,
                        b.permute(0, 3, 1, 2) * 255.0, flow_init=init)
                flow_pr = flow_pr.permute(0, 2, 3, 1)
                if warm_start:
                    flow_prev = forward_interpolate(
                        flow_low[0].permute(1, 2, 0).float().cpu().numpy())
            else:
                flow_pr = predict_flow(model, a, b)
            flow = remove_pad(flow_pr.float().cpu().numpy(), pad)[0]
            output_dir = os.path.join(output_path, dstype, str(sequence))
            os.makedirs(output_dir, exist_ok=True)
            write_flo(
                os.path.join(output_dir, "frame%04d.flo" % (frame + 1)), flow)
            sequence_prev = sequence


def create_kitti_submission(model, dataset, output_path="kitti_submission"):
    """evaluate.py:243-267: 16-bit KITTI flow PNGs."""
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(dataset)):
        img1, img2, extra = dataset[i]
        frame_id = extra[0] if isinstance(extra, (list, tuple)) else extra
        flow = _predict_padded(
            model, img1[None] / 255.0, img2[None] / 255.0, mode="kitti")[0]
        write_flow_png(os.path.join(output_path, frame_id), flow)
