"""Validation and benchmark submissions (counterpart of
``understanding_flow_robustness_tpu/training/evaluate.py``; reference:
training/evaluate.py).

``validate_chairs/sintel/kitti`` with the reference metrics (EPE, 1/3/5 px,
KITTI F1 = EPE > 3 px AND EPE/|gt| > 0.05 over valid pixels,
evaluate.py:374-389) and the Sintel (warm-start) / KITTI submission
writers (:200-267).  Models come in as ``FlowModel``s (``models.registry``)
on their device; frames are padded on the host by the InputPadder rule,
one sample at a time (KITTI frames differ in size), and the flow is
unpadded on the host.  ``validate_kitti(..., mesh=)`` shards the KITTI
samples over a data-parallel mesh (``parallel``), one sample per rank a
step, padded to one common geometry.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.loader import pad_batch
from ..flowviz.io import write_flo, write_flow_png
from ..flowviz.png import png_size
from ..models.registry import predict_flow
from ..ops.interp import remove_pad
from ..parallel.mesh import gather_objects, is_rank0


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
    EPE / |gt| > 0.05, :381).

    With ``mesh`` (a ``parallel.Mesh``; every rank calls it with the same
    dataset) the samples are padded to one common geometry and spread
    over the ranks, one each a step; the scores are every rank's (see
    ``_validate_kitti_sharded``)."""
    if mesh is not None:
        return _validate_kitti_sharded(model, dataset, mesh)
    out_list, epe_list = [], []
    for i in range(len(dataset)):
        img1, img2, flow_gt, valid_gt = dataset[i]
        flow = _predict_padded(
            model, img1[None] / 255.0, img2[None] / 255.0, mode="kitti")[0]
        epe, out = _kitti_scores(flow, flow_gt, valid_gt)
        epe_list.append(epe)
        out_list.append(out)
    epe = float(np.mean(epe_list))
    f1 = 100 * float(np.mean(np.concatenate(out_list)))
    print(f"Validation KITTI: {epe:.6f}, {f1:.6f}")
    return {"kitti-epe": epe, "kitti-f1": f1}


def _kitti_scores(flow, flow_gt, valid_gt) -> tuple:
    """(mean EPE over the valid pixels, the valid pixels' outlier mask)."""
    epe = np.sqrt(np.sum((flow - flow_gt) ** 2, axis=-1))
    mag = np.sqrt(np.sum(flow_gt ** 2, axis=-1))
    val = valid_gt >= 0.5
    out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-9)) > 0.05)
    return epe[val].mean(), out[val]


def _frame_sizes(dataset) -> list:
    """Every sample's (H, W): from the PNG headers when the dataset lists
    PNG files (``flowviz.png.png_size``, 24 bytes a file), else decoded.
    The headers are trusted only if the first sample decodes to their
    size (a dataset that resized in ``__getitem__`` would not)."""
    pairs = getattr(dataset, "image_list", None)
    if pairs and all(p[0].lower().endswith(".png") for p in pairs):
        sizes = []
        for pair in pairs:
            with open(pair[0], "rb") as f:
                w, h = png_size(f.read(24))
            sizes.append((h, w))
        if tuple(dataset[0][0].shape[:2]) == sizes[0]:
            return sizes
    return [tuple(dataset[i][0].shape[:2]) for i in range(len(dataset))]


def _validate_kitti_sharded(model, dataset, mesh) -> dict:
    """Data-parallel KITTI validation (the JAX package's
    ``_validate_kitti_sharded``, evaluate.py:123-196).  Every sample is
    replicate-padded to one common geometry, the largest frame rounded up
    to the model's size multiple (kitti mode: H at the bottom, W on both
    sides); the samples go out in mesh-sized steps, sample s0 + r to rank
    r, and a ragged last step repeats its last sample on the ranks beyond
    it, whose scores are dropped.  Each rank crops the pad off its flow and
    scores it; the per-sample EPEs and outlier masks are gathered in sample
    order, and rank 0 prints the result."""
    n_dev, rank = mesh.world, mesh.rank
    sizes = _frame_sizes(dataset)
    mult = max(model.size_multiple, 1)
    max_h = max(h for h, _ in sizes)
    max_w = max(w for _, w in sizes)
    pad_h = max_h + (-max_h) % mult
    pad_w = max_w + (-max_w) % mult

    scores = []
    for s0 in range(0, len(dataset), n_dev):
        i = min(s0 + rank, len(dataset) - 1)
        img1, img2, flow_gt, valid_gt = dataset[i]
        h, w = img1.shape[:2]
        t, b, l, r = pad = (0, pad_h - h, (pad_w - w) // 2,
                            pad_w - w - (pad_w - w) // 2)
        a, c = (torch.from_numpy(np.pad(
            x[None] / 255.0, ((0, 0), (t, b), (l, r), (0, 0)),
            mode="edge")).to(model.device) for x in (img1, img2))
        flow = remove_pad(predict_flow(model, a, c).float().cpu().numpy(),
                          pad)[0]
        if s0 + rank < len(dataset):
            scores.append((i,) + _kitti_scores(flow, flow_gt, valid_gt))
    scores = sorted((x for part in gather_objects(mesh, scores) for x in part),
                    key=lambda x: x[0])
    epe = float(np.mean([e for _, e, _ in scores]))
    f1 = 100 * float(np.mean(np.concatenate([o for _, _, o in scores])))
    if is_rank0(mesh):
        print(f"Validation KITTI ({n_dev}-device mesh): {epe:.6f}, {f1:.6f}")
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
