"""True-motion 3D patch projection (counterpart of
``understanding_flow_robustness_tpu/attacks/patch3d.py``; reference:
patch_attacks/utils_patch.py:849-997).

Places the patch on a 3D plane in the scene (depth sampled from the GT
disparity range inside the patch), projects it into the past/future frames
via camera-pose homographies, and synthesizes the induced GT flow of the
patch motion.  Homography estimation stays on the host (4 points, numpy);
the homography warps are ``grid_sample`` semantics through the port's
``ops.interp`` (``unnormalize_coords`` + ``bilinear_sample``, zeros
padding) on ``device``.
"""

from __future__ import annotations

import numpy as np

from ..ops.interp import bilinear_sample, resize_bilinear, unnormalize_coords
from ..utils import on_device


def _find_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """4-point DLT homography (cv2.findHomography equivalent for the
    exact-4-point case the reference uses)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def project_patch_3d_scene(
    calib: dict,
    poses: list[np.ndarray],
    disp_gt: np.ndarray,          # (H_gt, W_gt) disparity
    patch_canvas: np.ndarray,     # (1, H, W, 3) placed patch canvas
    mask_canvas: np.ndarray,      # (1, H, W, 3)
    random_x: int,
    random_y: int,
    patch_shape,
    flow_w: int,
    flow_h: int,
    forward_patch_flow: np.ndarray,   # (1, H_gt, W_gt, 3), mutated flow
    rng: np.random.RandomState | None = None,
    device="cuda",
):
    """Returns (patch_future, mask_future, patch_past, mask_past) canvases
    plus the updated forward_patch_flow (the patch's induced GT flow), all
    numpy; the resize and the four warps run on ``device``."""
    rng = rng or np.random.RandomState(0)
    imu2cam = np.asarray(calib["P_imu_cam"])
    imu2img = np.asarray(calib["P_imu_img"])
    pose_past, pose_ref, pose_fut = [np.asarray(p) for p in poses]

    ph, pw = patch_shape[1], patch_shape[2]
    patch_disp = disp_gt[random_y : random_y + ph, random_x : random_x + pw]
    valid = patch_disp > 0
    subset = patch_disp[valid]
    min_disp = subset.min() if len(subset) else 0.0
    max_disp = disp_gt.max()
    disparity = rng.uniform(min_disp, max_disp)

    f_x = calib["cam"]["focal_length_x"]
    f_y = calib["cam"]["focal_length_y"]
    depth = f_x * calib["cam"]["baseline"] / max(disparity, 1e-6)
    # the reference anchors the patch plane at WHOLE-METER coordinates:
    # utils_patch.py:900 builds p_cam0 as an int64 array and the float
    # X/Y/Z assignments truncate toward zero — mirror that quirk exactly
    p_cam0 = np.array([0, 0, 0, 1], dtype=np.int64)
    p_cam0[0] = depth * (random_x - calib["cam"]["cx"]) / f_x
    p_cam0[1] = depth * (random_y - calib["cam"]["cy"]) / f_y
    p_cam0[2] = depth
    T_p_cam0 = np.eye(4)
    T_p_cam0[:4, 3] = p_cam0

    # patch corner points on a 0.25m plane, lifted to IMU coordinates
    patch_size_m = -0.25
    pts = np.array([
        [0, 0, 0, 1],
        [0, patch_size_m, 0, 1],
        [patch_size_m, 0, 0, 1],
        [patch_size_m, patch_size_m, 0, 1],
    ]).T
    pts = np.linalg.inv(imu2cam).dot(T_p_cam0.dot(pts))

    def project(pose):
        p = imu2img.dot(pose.dot(pts))
        return (p[:2] / p[2:3]).T  # (4, 2)

    pts_src = project(pose_ref)
    pts_past = project(pose_past)
    pts_fut = project(pose_fut)

    H_past = _find_homography(pts_src, pts_past)
    H_fut = _find_homography(pts_src, pts_fut)

    X, Y = np.meshgrid(np.arange(flow_w), np.arange(flow_h))
    XYhom = np.stack([X, Y, np.ones_like(X)], axis=0).reshape(3, -1)

    def warp_by_homography(H):
        W = H.dot(XYhom)
        xw = (W[0] / (W[2] + 1e-8)).reshape(flow_h, flow_w)
        yw = (W[1] / (W[2] + 1e-8)).reshape(flow_h, flow_w)
        return xw, yw

    xw_f, yw_f = warp_by_homography(H_fut)
    # induced forward GT flow of the patch motion (upsampled to GT size)
    u = (X - xw_f).astype(np.float32)
    v = (Y - yw_f).astype(np.float32)
    flow = on_device(np.stack([u, v], 0)[None], device)
    h_gt, w_gt = forward_patch_flow.shape[1:3]
    flow = resize_bilinear(flow, h_gt, w_gt, align_corners=False)
    flow = (flow[0].permute(1, 2, 0).cpu().numpy()
            * np.array([w_gt / flow_w, h_gt / flow_h], np.float32))
    forward_patch_flow = forward_patch_flow.copy()
    forward_patch_flow[..., :2] = flow

    def sample_grid(canvas, xw, yw):
        # reference grid_sample on a [-1,1]-normalized grid built with
        # (size-1) scaling, sampled align_corners=False zeros
        gx = 2 * (xw / (flow_w - 1) - 0.5)
        gy = 2 * (yw / (flow_h - 1) - 0.5)
        px, py = unnormalize_coords(on_device(gx, device),
                                    on_device(gy, device), flow_h, flow_w,
                                    align_corners=False)
        out = bilinear_sample(on_device(canvas, device).permute(0, 3, 1, 2),
                              px[None], py[None], padding_mode="zeros")
        return out.permute(0, 2, 3, 1).cpu().numpy()

    patch_fut = sample_grid(patch_canvas, xw_f, yw_f)
    mask_fut = sample_grid(mask_canvas, xw_f, yw_f)
    xw_p, yw_p = warp_by_homography(H_past)
    patch_past = sample_grid(patch_canvas, xw_p, yw_p)
    mask_past = sample_grid(mask_canvas, xw_p, yw_p)

    return patch_fut, mask_fut, patch_past, mask_past, forward_patch_flow
