"""Patch evaluation at fixed or random location (counterpart of
``understanding_flow_robustness_tpu/cli/test_patch.py``; reference:
patch_attacks/test_patch.py:131-647).

Evaluates a saved / random / self-correlated patch against a flow net over
an evaluation set; writes ``test_results*.csv`` (aggregate),
``test_result_scenes*.csv`` (per-scene) and per-scene ``viz###.jpg`` panels
(adv target, adv reference, clean/adv/diff flow, adversarial GT).

``--different_pos`` applies independent per-frame patch transforms and
synthesizes the GT from the composed transform
(utils_patch.py:499-757, circle_transform_different).
``--true_motion`` projects the patch into the 3D scene with the KITTI-raw
calib/poses (utils_patch.py:849-997, project_patch_3d_scene).

The same flags as the JAX CLI, plus ``--device``: the card unless asked
for ``cpu`` (no fallback; ``gpu`` means ``cuda``).  Runs on the KITTI /
Sintel evaluation sets (``get_evaluation_set`` at 384x1280, KITTI raw
calib/poses with --true_motion) or on ``--synthetic N`` frames (synthetic
calib/poses with --true_motion).  The viz panels ``viz###.jpg`` are JPEG
at PIL's default quality (75), through the port's own encoder.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from scipy.ndimage import minimum_filter, zoom

from ..attacks.losses import compute_cossim, compute_epe
from ..attacks.patch import (
    circle_transform,
    circle_transform_different,
    create_circular_mask,
    create_correlated_patch,
    create_random_patch,
    square_transform,
)
from ..attacks.patch3d import project_patch_3d_scene
from ..flowviz import flow_to_image
from ..flowviz.jpeg import encode_jpeg
from ..ops.interp import resize_bilinear
from ..utils import AverageMeter, CsvLogger, on_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--flownet", type=str, default="FlowNetC")
    p.add_argument("--pretrained_path", type=str, default="pretrained_models")
    p.add_argument("--valset", type=str, default="kitti2015",
                   choices=["kitti2012", "kitti2015", "sintel"])
    p.add_argument("--kitti-dir", type=str, default="datasets/KITTI/scene_flow")
    p.add_argument("--kitti_raw_dir", type=str, default=None,
                   help="KITTI raw root (calib/poses for --true_motion)")
    p.add_argument("--sintel-dir", type=str, default="datasets/Sintel")
    p.add_argument("--patch_path", type=str, default=None)
    p.add_argument("--patch_name", type=str, default="",
                   help="patch file under {name}/{valset}/{flownet}/"
                        "{instance}/patches/ (reference save-path layout, "
                        "test_patch.py:156-161)")
    p.add_argument("--instance", type=str, default="",
                   help="save-path sub-directory (test_patch.py:40)")
    p.add_argument("--patch_type", type=str, default="circle",
                   choices=["circle", "square"],
                   help="placement transform + default mask shape")
    p.add_argument("--mask_path", type=str, default="",
                   help="image file resized to the patch and /256 as the "
                        "mask (utils_patch.py:24-27)")
    p.add_argument("--compression", type=float, default=0.0,
                   help="accepted for reference CLI parity; unused there "
                        "too (parsed at test_patch.py:63-70, never read)")
    p.add_argument("-j", "--workers", type=int, default=4,
                   help="reference DataLoader workers; accepted for parity "
                        "(this CLI iterates the dataset directly)")
    p.add_argument("--random_patch", type=str, default=None,
                   choices=["", "gaussian", "uniform", "black", "white",
                            "red", "gray", "self"])
    p.add_argument("--self_correlated_patch", type=str, default=None)
    p.add_argument("--patch_size", type=int, default=100,
                   help="pixels (for random/self-correlated patches)")
    p.add_argument("--fixed_loc_x", type=int, default=-1)
    p.add_argument("--fixed_loc_y", type=int, default=-1)
    p.add_argument("--different_pos", action="store_true")
    p.add_argument("--norotate", action="store_true")
    p.add_argument("--true_motion", action="store_true",
                   help="3D-projected patch motion (needs KITTI raw "
                        "calib/poses, or --synthetic)")
    p.add_argument("--ignore_mask_flow", action="store_true",
                   help="ignore flow in mask region (test_patch.py:89)")
    p.add_argument("--homogeneous", "--HOMOGENUOUS", dest="homogeneous",
                   action="store_true",
                   help="0.5-gray images, zero GT (--HOMOGENUOUS upstream)")
    p.add_argument("--example", type=int, default=0)
    p.add_argument("--no_viz", action="store_true",
                   help="skip per-scene viz###.jpg dumps")
    p.add_argument("--name", type=str, default="test_patch")
    p.add_argument("--output", type=str, default="output/patch_attacks")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic-size", type=int, nargs=2, default=(128, 192))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless asked for 'cpu' "
                        "(no fallback); 'gpu' means 'cuda'")
    return p


def _load_patch_file(path):
    """np.load with a torch.load fallback: patches trained by this repo
    are .npy (NHWC); patches from the reference pipeline are torch-saved
    NCHW tensors (utils_patch.py:20)."""
    try:
        arr = np.load(path)
        if not isinstance(arr, np.ndarray):
            raise ValueError("not a plain .npy")  # torch zips load as NpzFile
    except (ValueError, OSError):
        t = torch.load(path, map_location="cpu")
        arr = np.asarray(t.detach().numpy() if hasattr(t, "detach") else t)
        if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
            arr = arr.transpose(0, 2, 3, 1)  # NCHW -> NHWC
    return arr.astype(np.float32)


def load_patch(args):
    if args.self_correlated_patch:
        patch = create_correlated_patch(args.self_correlated_patch,
                                        args.patch_size)
    elif args.random_patch:
        if args.random_patch == "self":
            # the reference lists "self" among the choices but
            # create_random_patch has no such branch (utils_patch.py:38-59
            # raises UnboundLocalError); fail with a clear message instead
            raise SystemExit(
                "--random_patch self has no implementation in the "
                "reference either; use --self_correlated_patch")
        patch = create_random_patch(args.random_patch, args.patch_size)
    elif args.patch_path:
        patch = _load_patch_file(args.patch_path)
    elif args.patch_name:
        # reference save-path layout (test_patch.py:137-161):
        # {name}/{valset}/{flownet}/{instance}/patches/{patch_name}
        path = os.path.join(args.name, args.valset, args.flownet,
                            args.instance, "patches", args.patch_name)
        patch = _load_patch_file(path)
    else:
        raise SystemExit("need --patch_path / --patch_name / "
                         "--random_patch / --self_correlated_patch")
    if args.mask_path:
        # custom mask image, resized to the patch and /256
        # (utils_patch.py:24-27)
        from ..flowviz.io import read_image
        from ..native import resize_bilinear_u8

        m_img = read_image(args.mask_path)
        if m_img.ndim == 2:   # grayscale mask file -> 3 channels
            m_img = np.repeat(m_img[..., None], 3, axis=-1)
        mask = resize_bilinear_u8(
            m_img[..., :3].astype(np.uint8), patch.shape[1], patch.shape[2]
        ).astype(np.float32) / 256.0
        mask = mask[None]
    elif args.patch_type == "square":
        mask = np.ones(patch.shape, np.float32)  # utils_patch.py:32
    else:
        m = create_circular_mask(patch.shape[1],
                                 patch.shape[2]).astype("float32")
        mask = np.tile(m[None, :, :, None], (1, 1, 1, 3))
    return patch, mask, patch.shape


def analysis_patch(args) -> tuple:
    """The patch and its circular mask (1, h, w, 3) of the analysis CLIs
    (test_replace_features.py, test_patch_embeddings.py):
    ``--self_correlated_patch``, else ``--patch_path``, else
    ``--random_patch`` (uniform by default) at ``--patch_size``."""
    if args.self_correlated_patch:
        patch = create_correlated_patch(args.self_correlated_patch,
                                        args.patch_size)
    elif args.patch_path:
        patch = np.load(args.patch_path)
    else:
        patch = create_random_patch(args.random_patch or "uniform",
                                    args.patch_size)
    m = create_circular_mask(patch.shape[1], patch.shape[2]).astype("float32")
    return patch, np.tile(m[None, :, :, None], (1, 1, 1, 3))


def _synthetic_calib(h, w):
    """Identity-ish calib + small forward-motion poses for smoke runs."""
    P = np.vstack([
        np.array([[100.0, 0, w / 2, 0], [0, 100.0, h / 2, 0], [0, 0, 1, 0]]),
        [0, 0, 0, 1.0],
    ])
    calib = {
        "P_imu_cam": np.eye(4),
        "P_imu_img": P[:3],
        "cam": {"focal_length_x": 100.0, "focal_length_y": 100.0,
                "cx": w / 2, "cy": h / 2, "baseline": 0.54},
    }
    drift = np.eye(4)
    drift[0, 3] = 0.3  # small translation between frames
    poses = [np.linalg.inv(drift), np.eye(4), drift]
    return calib, poses


def _val_samples(args):
    """The evaluation set of ``--valset`` at 384x1280 (the JAX CLI's
    geometry), or with --synthetic N the JAX CLI's numpy frames (same
    RandomState draws), zero all-valid GT, constant disparity."""
    if not args.synthetic:
        from argparse import Namespace

        from ..data import get_evaluation_set

        ds = get_evaluation_set(args.valset, Namespace(
            img_height=384, img_width=1280, kitti_dir=args.kitti_dir,
            sintel_dir=args.sintel_dir, true_motion=args.true_motion,
            kitti_raw_dir=args.kitti_raw_dir, example=args.example,
        ))
        for i in range(len(ds)):
            past, tgt, fut, gt_flow, disp, calib, poses = ds[i]
            yield (i, past[None], tgt[None], fut[None], gt_flow[None],
                   np.asarray(disp), calib, poses)
        return
    rng = np.random.RandomState(args.seed)
    h, w = args.synthetic_size
    for i in range(args.synthetic):
        past = rng.rand(1, h, w, 3).astype(np.float32)
        tgt = rng.rand(1, h, w, 3).astype(np.float32)
        fut = rng.rand(1, h, w, 3).astype(np.float32)
        gt = np.zeros((1, h, w, 3), np.float32)
        gt[..., 2] = 1
        disp = np.full((h, w), 8.0, np.float32)
        calib, poses = ({}, {})
        if args.true_motion:
            calib, poses = _synthetic_calib(h, w)
        yield i, past, tgt, fut, gt, disp, calib, poses


def _upsample3(mask_canvas, h_gt, w_gt, device):
    """Bilinear-resize a (1,H,W,3) canvas to GT size (torch upsample)."""
    x = torch.as_tensor(np.asarray(mask_canvas, np.float32),
                        device=device).permute(0, 3, 1, 2)
    return resize_bilinear(x, h_gt, w_gt, align_corners=False).permute(
        0, 2, 3, 1).cpu().numpy()


def _viz_panel(adv_tgt, adv_ref, flow, adv_flow, gt_adv):
    """Reference viz (test_patch.py:468-620): 6 panels concatenated
    horizontally — adv target, adv reference, clean / adversarial / diff
    flow (shared maxrad from the adversarial GT), eroded GT flow."""
    u, v = gt_adv[..., 0].copy(), gt_adv[..., 1].copy()
    unknown = (np.abs(u) > 1e7) | (np.abs(v) > 1e7)
    u[unknown] = 0
    v[unknown] = 0
    maxrad = float(np.sqrt(u ** 2 + v ** 2).max())

    gt_img = flow_to_image(np.dstack([u, v]), maxrad)
    gt_img = minimum_filter(gt_img, size=(3, 3, 1))  # cv2.erode stand-in
    panels = [
        (np.clip(adv_tgt[0], 0, 1) * 255).astype(np.uint8),
        (np.clip(adv_ref[0], 0, 1) * 255).astype(np.uint8),
        flow_to_image(np.asarray(flow[0]), maxrad),
        flow_to_image(np.asarray(adv_flow[0]), maxrad),
        flow_to_image(np.asarray(adv_flow[0] - flow[0]), maxrad),
        gt_img,
    ]
    h = min(p.shape[0] for p in panels)
    w = min(p.shape[1] for p in panels)
    panels = [
        p if p.shape[:2] == (h, w) else
        zoom(p, (h / p.shape[0], w / p.shape[1], 1), order=1)
        for p in panels
    ]
    return np.concatenate(panels, axis=1)


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)

    from ..models import checkpoint_arg, device_arg, fetch_model, predict_flow

    device = device_arg(args.device)

    model = fetch_model(
        args.flownet,
        pretrained_path=checkpoint_arg(args.pretrained_path, args.flownet),
        device=device)

    def predict(a, b):
        return predict_flow(model, on_device(a, device), on_device(b, device))

    patch, mask, patch_shape = load_patch(args)
    out_dir = os.path.join(args.output, args.name)
    suffix = ("_different_pos" if args.different_pos
              else "_true_motion" if args.true_motion else "")
    vis_dir = os.path.join(out_dir, f"images_test{suffix}")
    os.makedirs(vis_dir, exist_ok=True)
    scene_csv = CsvLogger(
        os.path.join(out_dir, f"test_result_scenes{suffix}.csv"),
        ["scene", "epe", "adv_epe", "cos_sim", "adv_cos_sim"],
    )
    errors = AverageMeter(i=4)
    fixed = (args.fixed_loc_x, args.fixed_loc_y)

    # reference seeds np.random with 1337 before the eval loop (:240)
    np.random.seed(1337)

    for i, past, tgt, fut, gt, disp, calib, poses in _val_samples(args):
        if args.homogeneous:
            past = np.ones_like(past) * 0.5
            tgt = np.ones_like(tgt) * 0.5
            fut = np.ones_like(fut) * 0.5
            gt = np.zeros_like(gt)

        flow = predict(tgt, fut)
        bt, h_gt, w_gt = gt.shape[0], gt.shape[1], gt.shape[2]
        margin = int(disp.max()) if calib else 0

        # patch-region GT replacement: zero flow, valid=1 (:397-403)
        forward_patch_flow = np.zeros((bt, h_gt, w_gt, 3), np.float32)
        forward_patch_flow[..., 2] = 1.0
        gt_clean = np.asarray(gt, np.float32)

        if args.different_pos:
            pcs, mcs, flow_full, _, rxs, rys, _ = circle_transform_different(
                patch.copy(), mask, patch.copy(), tgt.shape, patch_shape,
                margin, norotate=args.norotate, fixed_loc=fixed,
            )
            pc_tgt, pc_ref = [p.astype(np.float32) for p in pcs]
            mc_tgt, mc_ref = [m.astype(np.float32) for m in mcs]
            pc_past, mc_past = pc_tgt, mc_tgt
        elif args.patch_type == "square":
            # reference dispatch at test_patch.py:342-350 (square placement
            # has no zoom/fixed-loc; rotation is 90-degree steps)
            pc, mc, _, rx, ry = square_transform(
                patch.copy(), mask.copy(), patch.copy(), tgt.shape,
                patch_shape, norotate=args.norotate,
            )
            pshape2 = patch_shape
            pc_tgt = pc_ref = pc_past = pc.astype(np.float32)
            mc_tgt = mc_ref = mc_past = mc.astype(np.float32)
            if calib and not args.homogeneous:
                pc_ref, mc_ref, pc_past, mc_past, forward_patch_flow = (
                    project_patch_3d_scene(
                        calib, poses, disp, pc_tgt, mc_tgt, rx, ry, pshape2,
                        w_gt, h_gt, forward_patch_flow, device=device,
                    )
                )
        else:
            pc, mc, _, rx, ry, pshape2 = circle_transform(
                patch.copy(), mask, patch.copy(), tgt.shape, patch_shape,
                margin, norotate=args.norotate, fixed_loc=fixed,
            )
            pc_tgt = pc_ref = pc_past = pc.astype(np.float32)
            mc_tgt = mc_ref = mc_past = mc.astype(np.float32)
            if calib and not args.homogeneous:
                # 3D true-motion projection (test_patch.py:371-389)
                pc_ref, mc_ref, pc_past, mc_past, forward_patch_flow = (
                    project_patch_3d_scene(
                        calib, poses, disp, pc_tgt, mc_tgt, rx, ry, pshape2,
                        w_gt, h_gt, forward_patch_flow, device=device,
                    )
                )

        adv_tgt = np.clip((1 - mc_tgt) * tgt + mc_tgt * pc_tgt, 0, 1)
        adv_fut = np.clip((1 - mc_ref) * fut + mc_ref * pc_ref, 0, 1)
        adv_flow = predict(adv_tgt, adv_fut)

        mask_res = _upsample3(mc_tgt, h_gt, w_gt, device)
        if args.ignore_mask_flow:  # zero flow AND valid (:420-429)
            forward_patch_flow = np.zeros((bt, h_gt, w_gt, 3), np.float32)
        if args.different_pos:
            # remove pixels occluded by the frame-2 patch (:430-446)
            mask_ref_res = _upsample3(mc_ref, h_gt, w_gt, device)
            gt_clean = (1 - mask_ref_res) * gt_clean
            # patch displacement becomes the GT inside the patch (:448-453)
            sy = h_gt / flow_full.shape[1]
            sx = w_gt / flow_full.shape[2]
            forward_patch_flow = zoom(
                flow_full, zoom=(1, sy, sx, 1), order=1
            ).astype(np.float32)

        gt_adv = (1 - mask_res) * gt_clean + mask_res * forward_patch_flow

        gt_clean_j = on_device(gt_clean, device)
        gt_adv_j = on_device(gt_adv, device)
        vals = [
            float(compute_epe(gt_clean_j, flow)),
            float(compute_epe(gt_adv_j, adv_flow)),
            float(compute_cossim(gt_clean_j, flow)),
            float(compute_cossim(gt_adv_j, adv_flow)),
        ]
        errors.update(vals)
        scene_csv.write([i] + [round(v, 4) for v in vals])

        if not args.no_viz:
            # the JAX CLI's PIL save: JPEG at PIL's default quality, 75
            panel = _viz_panel(adv_tgt, adv_fut, flow.cpu().numpy(),
                               adv_flow.cpu().numpy(), gt_adv[0])
            with open(os.path.join(vis_dir, f"viz{i:03d}.jpg"), "wb") as f:
                f.write(encode_jpeg(panel, 75))

        if args.homogeneous:
            break

    result_csv = CsvLogger(
        os.path.join(out_dir, f"test_results{suffix}.csv"),
        ["epe", "adv_epe", "cos_sim", "adv_cos_sim"],
    )
    result_csv.write([round(v, 4) for v in errors.avg])
    print("avg:", dict(zip(["epe", "adv_epe", "cos_sim", "adv_cos_sim"],
                           [round(v, 4) for v in errors.avg])))
    return errors.avg


if __name__ == "__main__":
    main()
