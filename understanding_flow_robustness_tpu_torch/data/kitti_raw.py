"""KITTI raw calibration / OXTS pose loading (counterpart of
``understanding_flow_robustness_tpu/data/kitti_raw.py``; reference:
dataset_utils/raw.py:41-152, 290-440 — pykitti-style).

Provides the calib+pose data the true-motion patch projection needs
(dataset_utils/validation_flow.py:163-241): rectified projection matrices,
velo->cam / imu->velo rigid transforms, stereo baselines, and per-frame
IMU world poses from OXTS packets (Mercator-projected ENU, origin at the
``origin``-indexed frame).
"""

from __future__ import annotations

import glob
import os

import numpy as np


def rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def transform_from_rot_trans(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).reshape(3)
    return T


def read_calib_file(path: str) -> dict:
    """KITTI calib txt: 'key: v v v ...' lines (raw.py:69-84)."""
    data = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.array(
                    [float(x) for x in value.split()]
                )
            except ValueError:
                pass
    return data


def pose_from_oxts_packet(lat, lon, alt, roll, pitch, yaw, scale):
    """Mercator-projected SE(3) pose (raw.py:86-104)."""
    er = 6378137.0
    tx = scale * lon * np.pi * er / 180.0
    ty = scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    t = np.array([tx, ty, alt])
    R = rotz(yaw).dot(roty(pitch).dot(rotx(roll)))
    return transform_from_rot_trans(R, t)


def load_oxts_poses(oxts_files, origin_idx: int = 0) -> list[np.ndarray]:
    """Per-frame T_w_imu, re-based so the origin_idx frame is identity
    (raw.py:106-152)."""
    scale = None
    origin_inv = None
    poses = []
    for path in oxts_files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                vals = [float(x) for x in line.split()[:6]]
                lat, lon, alt, roll, pitch, yaw = vals
                if scale is None:
                    scale = np.cos(lat * np.pi / 180.0)
                T = pose_from_oxts_packet(lat, lon, alt, roll, pitch, yaw,
                                          scale)
                if len(poses) >= origin_idx and origin_inv is None:
                    origin_inv = np.linalg.inv(T)
                    poses = [origin_inv.dot(p) for p in poses]
                if origin_inv is not None:
                    T = origin_inv.dot(T)
                poses.append(T)
    return poses


class KittiRaw:
    """Calib + poses for one drive (subset of raw.py:177-440 — the parts
    the attack suite consumes)."""

    def __init__(self, base_path: str, date: str, drive: str,
                 frames=None, origin: int = 0, dataset: str = "sync"):
        self.drive = f"{date}_drive_{drive}_{dataset}"
        self.calib_path = os.path.join(base_path, date)
        self.data_path = os.path.join(base_path, date, self.drive)
        self.frames = frames
        self._load_calib()
        self._load_oxts(origin)

    def _load_calib(self):
        i2v = read_calib_file(
            os.path.join(self.calib_path, "calib_imu_to_velo.txt")
        )
        v2c = read_calib_file(
            os.path.join(self.calib_path, "calib_velo_to_cam.txt")
        )
        c2c = read_calib_file(
            os.path.join(self.calib_path, "calib_cam_to_cam.txt")
        )
        self.T_velo_imu = transform_from_rot_trans(
            i2v["R"].reshape(3, 3), i2v["T"]
        )
        self.T_cam0_velo_unrect = transform_from_rot_trans(
            v2c["R"].reshape(3, 3), v2c["T"]
        )
        self.P_rect_00 = np.vstack(
            [c2c["P_rect_00"].reshape(3, 4), [0, 0, 0, 1]]
        )
        R_rect = np.eye(4)
        R_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
        self.R_rect_00 = R_rect
        # stereo baselines from the rectified projections (raw.py calib)
        P2 = c2c["P_rect_02"].reshape(3, 4)
        P3 = c2c["P_rect_03"].reshape(3, 4)
        self.b_rgb = (P2[0, 3] - P3[0, 3]) / P2[0, 0]
        P0 = c2c["P_rect_00"].reshape(3, 4)
        P1 = c2c["P_rect_01"].reshape(3, 4)
        self.b_gray = (P0[0, 3] - P1[0, 3]) / P0[0, 0]

    def _load_oxts(self, origin: int):
        files = sorted(
            glob.glob(os.path.join(self.data_path, "oxts", "data", "*.txt"))
        )
        if self.frames is not None:
            files = [files[i] for i in self.frames]
        self.poses = load_oxts_poses(files, origin)


def load_calib_and_poses(raw_root: str, mapping: dict):
    """The calib/pose bundle ValidationFlowKitti2015 returns
    (validation_flow.py:163-241)."""
    seq = mapping["Sequence"][len(mapping["Scene"] + "_drive") + 1 : -5]
    frame = mapping["Frame"]
    ds = KittiRaw(raw_root, mapping["Scene"], seq,
                  frames=range(frame - 1, frame + 2), origin=1)
    calib = {
        "cam": {
            "P_rect_00": ds.P_rect_00.copy(),
            "R_rect_00": ds.R_rect_00,
            "baseline": ds.b_rgb,
        },
        "vel2cam": {"RT": ds.T_cam0_velo_unrect},
        "imu2vel": {"RT": ds.T_velo_imu},
    }
    poses = [ds.poses[0], ds.poses[1], ds.poses[2]]
    return calib, poses
