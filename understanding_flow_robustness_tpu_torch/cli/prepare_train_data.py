"""Prepare KITTI raw for patch-attack training (counterpart of the JAX
package's ``setup/prepare_train_data.py``; reference:
setup/prepare_train_data.py:36-117 + setup/kitti_raw_loader.py), with
neither PIL nor the JAX package.

Crawls the drives ``<dataset_dir>/2011*/*_sync``, drops the frames whose
OXTS speed is below 1 m/s (unless ``--keep_static``), resizes the kept
frames of ``image_<cam>`` with PIL's LANCZOS (``native.
resize_pil_lanczos_u8``, bit for bit) and writes them as JPEGs at quality
95 (``flowviz.jpeg.encode_jpeg``, libjpeg-turbo's bytes) under
``<dump_root>/<scene>/``, with the intrinsics ``P_rect_<cam>`` scaled to
the output size in ``cam.txt``; a drive keeping fewer than 3 frames is not
listed, a drive that fails (a missing calibration file, a corrupt PNG) is
skipped with a warning, and ``train.txt`` / ``val.txt`` split the scenes
(never the only one to val): the layout ``data.SequenceFolder`` reads.
Drives run on a thread pool; the dump does not depend on its size.
Colour frames only (``--cam`` 2 or 3): the JPEG encoder writes RGB.

    python -m understanding_flow_robustness_tpu_torch.cli.prepare_train_data \\
        --dataset_dir datasets/kitti_raw --dump_root datasets/kitti_raw_dump
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from ..data.kitti_raw import read_calib_file
from ..flowviz.io import _as_pil_reads, read_samples
from ..flowviz.jpeg import encode_jpeg
from ..flowviz.png import png_size
from ..native import resize_pil_lanczos_u8

STATIC_FRAMES_SPEED = 1.0  # m/s: below this the frame is considered static
JPEG_QUALITY = 95


def iter_drives(raw_root: str):
    for date in sorted(os.listdir(raw_root)):
        date_dir = os.path.join(raw_root, date)
        if not os.path.isdir(date_dir) or not date.startswith("2011"):
            continue
        for drive in sorted(glob.glob(os.path.join(date_dir, "*_sync"))):
            yield date, drive


def drive_speeds(drive_dir: str) -> np.ndarray:
    files = sorted(glob.glob(os.path.join(drive_dir, "oxts", "data", "*.txt")))
    speeds = []
    for f in files:
        vals = np.genfromtxt(f)
        # oxts fields 8-10 are vf, vl, vu
        speeds.append(float(np.linalg.norm(vals[8:11])))
    return np.asarray(speeds)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--dataset_dir", required=True, help="KITTI raw root")
    p.add_argument("--dump_root", required=True)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=416)
    p.add_argument("--cam", type=int, default=2,
                   help="camera id (2 = RGB left)")
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--keep_static", action="store_true")
    p.add_argument("--num_workers", type=int, default=8)
    return p


def main(argv=None) -> dict:
    """Writes the dump; returns the scenes and the host seconds spent
    reading, resizing and encoding frames (summed over threads)."""
    args = build_parser().parse_args(argv)

    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(args.dump_root, exist_ok=True)
    scenes = []
    seconds = {"read": [], "resize": [], "encode": []}

    def process_drive(date, drive):
        name = os.path.basename(drive)
        img_dir = os.path.join(drive, f"image_{args.cam:02d}", "data")
        images = sorted(glob.glob(os.path.join(img_dir, "*.png")))
        if not images:
            return None
        try:
            speeds = drive_speeds(drive)
        except Exception:
            speeds = np.full(len(images), np.inf)
        out_dir = os.path.join(args.dump_root, name)
        os.makedirs(out_dir, exist_ok=True)

        # scaled intrinsics (setup/kitti_raw_loader.py intrinsics scaling)
        calib = read_calib_file(
            os.path.join(os.path.dirname(drive), "calib_cam_to_cam.txt"))
        P = calib[f"P_rect_{args.cam:02d}"].reshape(3, 4)
        with open(images[0], "rb") as f:
            w0, h0 = png_size(f.read(24))
        K = P[:3, :3].copy()
        K[0] *= args.width / w0
        K[1] *= args.height / h0
        np.savetxt(os.path.join(out_dir, "cam.txt"), K, delimiter=",")

        kept = 0
        for i, path in enumerate(images):
            if (not args.keep_static and i < len(speeds)
                    and speeds[i] < STATIC_FRAMES_SPEED):
                continue
            t0 = time.perf_counter()
            img = _as_pil_reads(read_samples(path))
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"{path}: a {img.shape} frame; only RGB "
                                 "frames are written (the JPEG encoder's)")
            t1 = time.perf_counter()
            img = resize_pil_lanczos_u8(img, args.height, args.width)
            t2 = time.perf_counter()
            data = encode_jpeg(img, JPEG_QUALITY)
            with open(os.path.join(out_dir, f"{kept:07d}.jpg"), "wb") as f:
                f.write(data)
            t3 = time.perf_counter()
            for k, t in (("read", t1 - t0), ("resize", t2 - t1),
                         ("encode", t3 - t2)):
                seconds[k].append(t)
            kept += 1
        return name if kept >= 3 else None

    with ThreadPoolExecutor(args.num_workers) as pool:
        futs = [(d, pool.submit(process_drive, d, dr)) for d, dr in
                iter_drives(args.dataset_dir)]
        for drive, f in futs:
            # per-drive isolation: one incompletely-downloaded drive
            # (missing calib file, corrupt PNG) must not abort the whole
            # prep and discard hours of completed resizing
            try:
                name = f.result()
            except Exception as e:
                print(f"WARNING: skipping drive {drive}: {e}")
                continue
            if name:
                scenes.append(name)

    scenes.sort()
    # never assign the ONLY scene to val (an empty train.txt would make
    # SequenceFolder crawl zero scenes with no error pointing here)
    n_val = (max(1, int(len(scenes) * args.val_fraction))
             if len(scenes) > 1 else 0)
    with open(os.path.join(args.dump_root, "train.txt"), "w") as f:
        f.write("\n".join(scenes[n_val:]) + "\n")
    with open(os.path.join(args.dump_root, "val.txt"), "w") as f:
        f.write("\n".join(scenes[:n_val]) + "\n")
    print(f"prepared {len(scenes)} scenes under {args.dump_root}")
    return {"scenes": scenes, "frames": len(seconds["encode"]),
            "seconds": {k: float(sum(v)) for k, v in seconds.items()}}


if __name__ == "__main__":
    main()
