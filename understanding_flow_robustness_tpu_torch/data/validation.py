"""Attack-evaluation datasets (3-frame KITTI / Sintel; counterpart of
``understanding_flow_robustness_tpu/data/validation.py``).

Reference: dataset_utils/validation_flow.py (ValidationFlowKitti2015/2012
returning (ref_past, tgt, ref_future, gtFlow(u,v,valid), gtDisp, calib,
poses)), dataset_utils/validation_sintel.py (MpiSintel 7-tuple), and
dataset_utils/utils.py:6-36 (get_evaluation_set).  Also the pair-style
global-attack datasets of dataset_utils/kitti_datasets.py: image pair
*_10/_11 + full-res GT + a sparse-aware downscaled GT copy.

Samples are NHWC numpy; gtFlow carries (u, v, valid) in the last axis.
Frames are read and resized by the port's own ``flowviz.io`` and host
library: ``get_evaluation_set``'s ``Scale`` with PIL's bilinear semantics,
``KittiPairDataset`` with cv2's ``INTER_LINEAR`` of a float32 image, both
bit for bit.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from ..flowviz import io as fio
from ..native import resize_cv2_linear_f32, resize_sparse_flow
from .transforms import Compose, Scale, ToFloat01


def _load_float(path) -> np.ndarray:
    return fio.read_image(str(path))


def _read_u8(path) -> np.ndarray:
    """An 8-bit image's samples (the pair datasets resize u8 values)."""
    px = fio.read_samples(str(path))
    if px.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit image, got {px.dtype}")
    return px


class ValidationFlowKitti2015:
    """validation_flow.py:121-285.  root points at the scene-flow dir with
    ``<phase>/image_2`` etc.  True-motion calib/pose loading (KITTI raw)
    is exposed via data.kitti_raw when raw_root is given."""

    def __init__(self, root, transform=None, N=200, phase="training",
                 compression=0, raw_root=None, example=0, true_motion=False):
        self.root = root
        self.start = max(0, min(example, N))
        self.N = 1 if example > 0 else N
        self.transform = transform
        self.phase = phase
        self.raw_root = raw_root
        self.mapping = [None] * N
        if true_motion:
            mapping_file = os.path.join(raw_root, "train_mapping.txt")
            if os.path.exists(mapping_file):
                with open(mapping_file, encoding="utf-8") as f:
                    for i, line in enumerate(f.readlines()):
                        if line.strip():
                            scene, seq, frame = line.split(" ")
                            self.mapping[i] = {
                                "Scene": scene, "Sequence": seq,
                                "Frame": int(frame.strip()),
                            }

    def _paths(self, index):
        z = str(index).zfill(6)
        j = os.path.join
        return (
            j(self.root, self.phase, "image_2", z + "_09.png"),
            j(self.root, self.phase, "image_2", z + "_10.png"),
            j(self.root, self.phase, "image_2", z + "_11.png"),
            j(self.root, self.phase, "flow_occ", z + "_10.png"),
            j(self.root, self.phase, "disp_occ_0", z + "_10.png"),
        )

    def __getitem__(self, index):
        index = self.start + index
        past_p, tgt_p, fut_p, flow_p, disp_p = self._paths(index)
        tgt = _load_float(tgt_p)
        past = _load_float(past_p)
        fut = _load_float(fut_p)
        flow, valid = fio.read_flow_png(flow_p)
        gt_flow = np.dstack([flow, valid]).astype(np.float32)
        try:
            gt_disp = fio.read_disparity_png(disp_p)
        except FileNotFoundError:
            gt_disp = np.zeros(tgt.shape[:2], np.float32)

        calib, poses = {}, {}
        if self.mapping[index] is not None:
            from .kitti_raw import load_calib_and_poses

            calib, poses = load_calib_and_poses(
                self.raw_root, self.mapping[index]
            )

        if self.transform is not None:
            in_h, in_w = tgt.shape[:2]
            tgt, past, fut = self.transform([tgt, past, fut])
            out_h, out_w = tgt.shape[:2]
            if calib and (in_h != out_h or in_w != out_w):
                sx = out_h / in_h
                sy = out_w / in_w
                P = calib["cam"]["P_rect_00"]
                P[0, 0] *= sx
                P[1, 1] *= sy
                P[0, 2] *= sx
                P[1, 2] *= sy
        if calib:
            P = calib["cam"]["P_rect_00"]
            calib["cam"]["focal_length_x"] = P[0, 0]
            calib["cam"]["focal_length_y"] = P[1, 1]
            calib["cam"]["cx"] = P[0, 2]
            calib["cam"]["cy"] = P[1, 2]
            calib["P_imu_cam"] = calib["cam"]["R_rect_00"].dot(
                calib["vel2cam"]["RT"].dot(calib["imu2vel"]["RT"])
            )
            calib["P_imu_img"] = calib["cam"]["P_rect_00"].dot(calib["P_imu_cam"])

        return past, tgt, fut, gt_flow, gt_disp, calib, poses

    def __len__(self):
        return self.N


class ValidationFlowKitti2015MV:
    """KITTI 2015 MULTIVIEW loader (validation_flow.py:15-118): the
    20-frame-per-scene multiview split.  index -> scene index//20, frame
    index%20; GT flow/disp exist only for the annotated frame (10) — other
    frames return zero GT, and the past frame is only loaded when the GT
    exists (reference quirk, :84-88)."""

    def __init__(self, root, transform=None, N=4000, phase="training",
                 compression=0, raw_root=None, example=0,
                 true_motion=False):
        self.root = root
        self.start = max(0, min(example, N))
        self.N = 1 if example > 0 else N
        self.transform = transform
        self.phase = phase

    def __getitem__(self, index):
        index = self.start + index
        scene, frame = index // 20, index % 20
        j = os.path.join
        name = f"{scene:06d}_{frame:02d}.png"
        tgt_p = j(self.root, self.phase, "image_2", name)
        past_p = j(self.root, self.phase, "image_2",
                   f"{scene:06d}_{frame - 1:02d}.png")
        fut_p = j(self.root, self.phase, "image_2",
                  f"{scene:06d}_{frame + 1:02d}.png")
        flow_p = j(self.root, self.phase, "flow_occ", name)
        disp_p = j(self.root, self.phase, "disp_occ_0", name)

        tgt = _load_float(tgt_p)
        fut = _load_float(fut_p)
        h, w = tgt.shape[:2]
        if os.path.exists(flow_p):
            past = _load_float(past_p)
            flow, valid = fio.read_flow_png(flow_p)
            gt_flow = np.dstack([flow, valid]).astype(np.float32)
            gt_disp = fio.read_disparity_png(disp_p)
        else:
            past = np.zeros_like(tgt)
            gt_flow = np.zeros((h, w, 3), np.float32)
            gt_disp = np.zeros((h, w), np.float32)

        if self.transform is not None:
            tgt, past, fut = self.transform([tgt, past, fut])
        return past, tgt, fut, gt_flow, gt_disp, {}, {}

    def __len__(self):
        return self.N


class ValidationFlowKitti2012(ValidationFlowKitti2015):
    """validation_flow.py:288-349: same layout, colored_0 images, N=194."""

    def __init__(self, root, transform=None, N=194, phase="training",
                 compression=0, example=0):
        super().__init__(root, transform=transform, N=N, phase=phase,
                         compression=compression, example=example)

    def _paths(self, index):
        z = str(index).zfill(6)
        j = os.path.join
        return (
            j(self.root, self.phase, "colored_0", z + "_09.png"),
            j(self.root, self.phase, "colored_0", z + "_10.png"),
            j(self.root, self.phase, "colored_0", z + "_11.png"),
            j(self.root, self.phase, "flow_occ", z + "_10.png"),
            j(self.root, self.phase, "disp_occ", z + "_10.png"),
        )


class ValidationSintel:
    """validation_sintel.py:19-76: 7-tuple with zero ref_past, empty
    calib/poses, dense .flo GT with valid=1."""

    def __init__(self, root, transform=None, dstype="clean", phase="training"):
        self.transform = transform
        image_root = os.path.join(root, phase, dstype)
        flow_root = os.path.join(root, phase, "flow")
        self.samples = []
        for scene in sorted(os.listdir(image_root)):
            imgs = sorted(glob(os.path.join(image_root, scene, "*.png")))
            flows = sorted(glob(os.path.join(flow_root, scene, "*.flo")))
            for i in range(len(imgs) - 1):
                self.samples.append((imgs[i], imgs[i + 1], flows[i]))

    def __getitem__(self, index):
        img1_p, img2_p, flow_p = self.samples[index]
        tgt = _load_float(img1_p)
        fut = _load_float(img2_p)
        flow = fio.read_flo(flow_p)
        valid = np.ones(flow.shape[:2], np.float32)
        gt_flow = np.dstack([flow, valid]).astype(np.float32)
        past = np.zeros_like(tgt)
        if self.transform is not None:
            tgt, past, fut = self.transform([tgt, past, fut])
        gt_disp = np.zeros(gt_flow.shape[:2], np.float32)
        return past, tgt, fut, gt_flow, gt_disp, {}, {}

    def __len__(self):
        return len(self.samples)


class KittiPairDataset:
    """Global-attack pair dataset (kitti_datasets.py:22-195): image pair
    *_10/_11 resized to (n_height, n_width), full-res GT flow plus a
    sparse-aware downscaled copy for the attack loss."""

    def __init__(self, image0_paths, image1_paths, flow_paths,
                 n_height=256, n_width=640):
        self.image0_paths = image0_paths
        self.image1_paths = image1_paths
        self.flow_paths = flow_paths
        self.shape = (n_height, n_width)

    @classmethod
    def from_lists(cls, list_dir, year="2015", split="train",
                   n_height=256, n_width=640):
        """Path-list txt files produced by setup_dataset_kitti
        (setup/setup_dataset_kitti.py:8-120)."""
        kind = "scene" if year == "2015" else "stereo"
        img0 = fio.read_paths(
            os.path.join(list_dir, f"kitti_{kind}_flow_{split}_image0.txt")
        )
        img1 = fio.read_paths(
            os.path.join(list_dir, f"kitti_{kind}_flow_{split}_image1.txt")
        )
        flow = fio.read_paths(
            os.path.join(list_dir, f"kitti_{kind}_flow_{split}_flow.txt")
        )
        return cls(img0, img1, flow, n_height, n_width)

    def __getitem__(self, index):
        img0 = _read_u8(self.image0_paths[index])
        img1 = _read_u8(self.image1_paths[index])
        if img0.ndim == 2:
            img0 = np.tile(img0[..., None], (1, 1, 3))
            img1 = np.tile(img1[..., None], (1, 1, 3))
        flow, valid = fio.read_flow_png(self.flow_paths[index])
        gt_full = np.dstack([flow, valid]).astype(np.float32)

        h, w = img0.shape[:2]
        nh, nw = self.shape
        img0_r = resize_cv2_linear_f32(img0, nh, nw)
        img1_r = resize_cv2_linear_f32(img1, nh, nw)

        # sparse-aware downscaled GT (kitti_datasets.py:62-105;
        # SparseFlowAugmentor.resize_sparse_flow_map in the host library)
        flow_s, valid_s = resize_sparse_flow(flow, valid, nw / w, nh / h)
        gt_small = np.dstack([flow_s, valid_s]).astype(np.float32)

        return (
            img0_r.astype(np.float32) / 255.0,
            img1_r.astype(np.float32) / 255.0,
            gt_small,
            gt_full,
        )

    def __len__(self):
        return len(self.image0_paths)


def get_evaluation_set(valset: str, args):
    """dataset_utils/utils.py:6-36: Scale + /255 transform, dataset per
    valset name."""
    transform = Compose([Scale(args.img_height, args.img_width), ToFloat01()])
    if valset == "kitti2015":
        return ValidationFlowKitti2015(
            root=args.kitti_dir, transform=transform,
            raw_root=getattr(args, "kitti_raw_dir", None),
            example=getattr(args, "example", 0),
            true_motion=getattr(args, "true_motion", False),
        )
    if valset == "kitti2015mv":
        return ValidationFlowKitti2015MV(
            root=args.kitti_dir, transform=transform,
            example=getattr(args, "example", 0),
        )
    if valset == "kitti2012":
        return ValidationFlowKitti2012(
            root=args.kitti_dir, transform=transform,
            example=getattr(args, "example", 0),
        )
    if valset == "sintel":
        return ValidationSintel(
            root=args.sintel_dir, transform=transform,
            dstype=getattr(args, "sintel_type", "clean"),
        )
    raise ValueError(f"unknown valset {valset}")


def _crawl_img_npy(scenes):
    imgs, gts = [], []
    for scene in scenes:
        simgs = sorted(glob(os.path.join(scene, "*.jpg")))
        for im in simgs:
            gt = im[:-4] + ".npy"
            if os.path.exists(gt):
                imgs.append(im)
                gts.append(gt)
    return imgs, gts


class ValidationSet:
    """Prepared-KITTI scenes with per-frame .npy GT
    (dataset_utils/validation_folders.py:47-84)."""

    def __init__(self, root, transform=None):
        with open(os.path.join(root, "val.txt"), encoding="utf-8") as f:
            scenes = [os.path.join(root, l.strip()) for l in f if l.strip()]
        self.imgs, self.gts = _crawl_img_npy(scenes)
        self.transform = transform

    def __getitem__(self, index):
        img = _load_float(self.imgs[index])
        gt = np.load(self.gts[index]).astype(np.float32)
        if self.transform is not None:
            img = self.transform([img])[0]
        return img, gt

    def __len__(self):
        return len(self.imgs)


class ValidationSetPair(ValidationSet):
    """Consecutive-frame pairs from the same layout
    (dataset_utils/validation_folders.py:86-121)."""

    def __getitem__(self, index):
        index = min(index, len(self.imgs) - 2)
        img1 = _load_float(self.imgs[index])
        img2 = _load_float(self.imgs[index + 1])
        gt = np.load(self.gts[index]).astype(np.float32)
        if self.transform is not None:
            img1, img2 = self.transform([img1, img2])
        return img1, img2, gt

    def __len__(self):
        return max(len(self.imgs) - 1, 0)
