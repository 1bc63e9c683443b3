"""Moving-patch location sweep (counterpart of
``understanding_flow_robustness_tpu/cli/test_moving_patch.py``; reference:
patch_attacks/test_moving_patch.py:137-686).

Slides the patch over a stride grid; per location computes the
adversarial EPE against the GT whose patch region is replaced with zero
flow (valid) or ignored (``--ignore_mask_flow``), projecting the patch
into the 3-D scene per location with ``--true_motion``; renders the
per-location EPE heat map over the frame (jet colormap, :474-488), tracks
the worst location, and writes ``moving_results.csv`` and the per-scene
``moving_result_scenes.csv``.  ``--whole_img`` takes the loaded patch and
mask as full-frame canvases and evaluates them once.

The flags of ``test_patch`` plus ``--stride`` and ``--whole_img``; runs
on the card unless ``--device cpu``.  Without matplotlib (the card's
machine has none) the heat map is saved as ``vis/adv_epe_image_###.npy``.
"""

from __future__ import annotations

import os

import numpy as np

from ..attacks.losses import compute_cossim, compute_epe
from ..attacks.patch import circle_transform
from ..attacks.patch3d import project_patch_3d_scene
from ..utils import AverageMeter, CsvLogger, on_device
from .test_patch import _upsample3, _val_samples, load_patch
from .test_patch import build_parser as _base_parser


def build_parser():
    p = _base_parser()
    p.description = __doc__
    p.add_argument("--stride", type=int, default=25)
    p.add_argument("--whole_img", type=float, default=0.0,
                   help="non-zero: the loaded patch/mask are already "
                        "full-image canvases; skip placement "
                        "(test_moving_patch.py:63-68,307-343)")
    return p


def save_heat_map(heat: np.ndarray, frame: np.ndarray, vis_dir: str,
                  i: int) -> str:
    """The heat map of scene ``i`` over its frame's gray levels as
    ``adv_epe_image_{i:03d}.jpg`` (test_moving_patch.py:474-488), or
    without matplotlib the map itself as ``.npy``; returns the path."""
    try:
        import matplotlib
    except ImportError:
        path = os.path.join(vis_dir, f"adv_epe_image_{i:03d}.npy")
        np.save(path, heat)
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.ndimage import zoom

    H, W = frame.shape[:2]
    heat_full = zoom(heat, (H / heat.shape[0], W / heat.shape[1]), order=1)
    plt.imshow(np.dot(frame, [0.299, 0.587, 0.114]), cmap="gray")
    plt.imshow(heat_full, cmap="jet", alpha=0.5)
    plt.axis("off")
    plt.colorbar()
    plt.tight_layout()
    path = os.path.join(vis_dir, f"adv_epe_image_{i:03d}.jpg")
    plt.savefig(path)
    plt.close()
    return path


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
    m_size = patch_shape[2]
    out_dir = os.path.join(args.output, args.name)
    vis_dir = os.path.join(out_dir, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    scene_csv = CsvLogger(
        os.path.join(out_dir, "moving_result_scenes.csv"),
        ["scene", "epe", "adv_epe_avg", "adv_epe_min", "adv_epe_median",
         "adv_epe_max", "cos_sim", "adv_cos_avg", "adv_cos_min",
         "adv_cos_median", "adv_cos_max"],
    )
    errors = AverageMeter(i=4)

    for i, past, tgt, fut, gt, disp, calib, poses in _val_samples(args):
        H, W = tgt.shape[1:3]
        bt, h_gt, w_gt = gt.shape[0], gt.shape[1], gt.shape[2]
        # the true-motion margin keeps the swept patch projectable
        # (test_moving_patch.py:289-291)
        margin = int(np.asarray(disp).max()) if calib else 0
        gt_j = on_device(gt, device)
        flow = predict(tgt, fut)
        epe = float(compute_epe(gt_j, flow))
        cos = float(compute_cossim(gt_j, flow))

        # whole-image canvases (--whole_img) still get one evaluation
        ys = range(0, max(H - m_size, 1), args.stride)
        xs = range(0, max(W - m_size, 1), args.stride)
        heat = np.zeros((len(ys), len(xs)), np.float32)
        scene = AverageMeter(i=4)
        adv_epes, adv_coss = [], []
        worst = (-1.0, None)

        for yi, ry in enumerate(ys):
            for xi, rx in enumerate(xs):
                if args.whole_img == 0:
                    # the swept patch rotates randomly per location unless
                    # --norotate, from the global np.random stream
                    # (test_moving_patch.py:308-343, utils_patch.py:289-296)
                    pc, mc, _, rxa, rya, pshape2 = circle_transform(
                        patch.copy(), mask, patch.copy(), tgt.shape,
                        patch_shape, margin, norotate=args.norotate,
                        fixed_loc=(rx, ry), moving=True,
                    )
                else:
                    pc, mc = patch, mask
                    rxa, rya, pshape2 = rx, ry, patch_shape
                pc = pc.astype(np.float32)
                mc = mc.astype(np.float32)

                # GT in the patch region: zero flow valid=1, or fully
                # ignored (test_moving_patch.py:353-362,413-432)
                patch_flow = np.zeros((bt, h_gt, w_gt, 3), np.float32)
                patch_flow[..., 2] = 1.0

                pc_fut, mc_fut = pc, mc
                if calib:
                    # the patch projected into the 3-D scene per location
                    # (test_moving_patch.py:365-383)
                    pc_fut, mc_fut, _, _, patch_flow = project_patch_3d_scene(
                        calib, poses, disp, pc, mc, rxa, rya, pshape2,
                        w_gt, h_gt, patch_flow, device=device,
                    )

                adv_tgt = np.clip((1 - mc) * tgt + mc * pc, 0, 1)
                adv_fut = np.clip((1 - mc_fut) * fut + mc_fut * pc_fut, 0, 1)
                adv_flow = predict(adv_tgt, adv_fut)

                mres = _upsample3(mc, h_gt, w_gt, device)
                if args.ignore_mask_flow:
                    patch_flow = np.zeros((bt, h_gt, w_gt, 3), np.float32)
                gt_adv = on_device((1 - mres) * gt + mres * patch_flow,
                                   device)

                adv_epe = float(compute_epe(gt_adv, adv_flow))
                adv_cos = float(compute_cossim(gt_adv, adv_flow))
                heat[yi, xi] = adv_epe
                adv_epes.append(adv_epe)
                adv_coss.append(adv_cos)
                scene.update([epe, adv_epe, cos, adv_cos])
                errors.update([epe, adv_epe, cos, adv_cos])
                if adv_epe > worst[0]:
                    worst = (adv_epe, (rx, ry))

        save_heat_map(heat, tgt[0], vis_dir, i)
        scene_csv.write([
            i, round(epe, 4), round(scene.avg[1], 4), round(scene.min[1], 4),
            round(float(np.median(adv_epes)), 4), round(scene.max[1], 4),
            round(cos, 4), round(scene.avg[3], 4), round(scene.min[3], 4),
            round(float(np.median(adv_coss)), 4), round(scene.max[3], 4),
        ])
        print(f"scene {i}: clean epe {epe:.3f}, adv epe "
              f"avg {scene.avg[1]:.3f} max {scene.max[1]:.3f} "
              f"@ {worst[1]}")

    result_csv = CsvLogger(
        os.path.join(out_dir, "moving_results.csv"),
        ["epe", "adv_epe", "cos_sim", "adv_cos_sim"],
    )
    result_csv.write([round(v, 4) for v in errors.avg])
    return errors.avg


if __name__ == "__main__":
    main()
