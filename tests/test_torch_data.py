"""The port's datasets against the JAX package's, on the CPU.

The test writes small KITTI 2015 / 2012 (two frame sizes), Sintel,
FlyingChairs, FlyingThings3D and KITTI-raw layouts with the port's writers
from a numpy seed; every dataset class, ``get_evaluation_set`` and
``KittiPairDataset`` must give the JAX package's arrays bit for bit (the
port resizes with its own host library, PIL's and cv2's semantics without
either).  ``write_layouts`` is shared with ``test_torch_evaluate.py``.
"""

import os
import random
from argparse import Namespace

import numpy as np
import pytest

from understanding_flow_robustness_tpu.data import datasets as jds
from understanding_flow_robustness_tpu.data import kitti_raw as jraw
from understanding_flow_robustness_tpu.data import loader as jloader
from understanding_flow_robustness_tpu.data import transforms as jtr
from understanding_flow_robustness_tpu.data import validation as jval
from understanding_flow_robustness_tpu_torch.data import datasets as tds
from understanding_flow_robustness_tpu_torch.data import kitti_raw as traw
from understanding_flow_robustness_tpu_torch.data import loader as tloader
from understanding_flow_robustness_tpu_torch.data import transforms as ttr
from understanding_flow_robustness_tpu_torch.data import validation as tval
from understanding_flow_robustness_tpu_torch.flowviz import io as fio

# KITTI's frame sizes differ by a few pixels and are no multiples of 8; so
# do these, and they pad (kitti mode) to Sintel's padded size and Chairs'
# own, 64x88, so that a RAFT of the JAX package compiles once for all of
# them (RAFT's fourth pyramid level needs H and W of at least 64)
KITTI_SIZES = ((61, 83), (58, 86))
SINTEL_SIZE = (61, 83)
CHAIRS_SIZE = (64, 88)


def _img(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _kitti_flow(rng, h, w, scale=6.0):
    flow = (rng.randn(h, w, 2) * scale).astype(np.float32)
    valid = (rng.rand(h, w) > 0.4).astype(np.float32)
    return flow, valid


def write_layouts(root, seed=0, n_kitti=3, sintel_frames=3):
    """The datasets' directory layouts under ``root``, frames and GT from
    ``seed``.  Returns the roots by dataset name."""
    rng = np.random.RandomState(seed)
    roots = {k: os.path.join(root, k) for k in
             ("kitti", "kitti2012", "sintel", "chairs", "things", "raw",
              "lists")}
    for split in ("training", "testing"):
        for year, img_dir, disp_dir in (("kitti", "image_2", "disp_occ_0"),
                                        ("kitti2012", "colored_0",
                                         "disp_occ")):
            base = os.path.join(roots[year], split)
            for d in (img_dir, "flow_occ", disp_dir):
                os.makedirs(os.path.join(base, d), exist_ok=True)
            for i in range(n_kitti):
                h, w = KITTI_SIZES[i % len(KITTI_SIZES)]
                for f in ("09", "10", "11"):
                    fio.write_image(os.path.join(
                        base, img_dir, f"{i:06d}_{f}.png"), _img(rng, h, w))
                fio.write_flow_png(os.path.join(
                    base, "flow_occ", f"{i:06d}_10.png"),
                    *_kitti_flow(rng, h, w))
                fio.write_image(os.path.join(base, disp_dir,
                                             f"{i:06d}_10.png"),
                                (rng.rand(h, w) * 9000).astype(np.uint16))
    for split, passes in (("training", ("clean", "final")),
                          ("test", ("clean", "final"))):
        for scene in ("alley", "cave"):
            h, w = SINTEL_SIZE
            for dstype in passes:
                d = os.path.join(roots["sintel"], split, dstype, scene)
                os.makedirs(d, exist_ok=True)
                for k in range(sintel_frames):
                    fio.write_image(os.path.join(d, f"frame_{k + 1:04d}.png"),
                                    _img(rng, h, w))
            if split == "training":
                d = os.path.join(roots["sintel"], split, "flow", scene)
                os.makedirs(d, exist_ok=True)
                for k in range(sintel_frames - 1):
                    fio.write_flo(os.path.join(d, f"frame_{k + 1:04d}.flo"),
                                  (rng.randn(h, w, 2) * 4).astype(np.float32))
    d = os.path.join(roots["chairs"], "data")
    os.makedirs(d, exist_ok=True)
    for i in range(4):
        h, w = CHAIRS_SIZE
        fio.write_image(os.path.join(d, f"{i + 1:05d}_img1.ppm"),
                        _img(rng, h, w))
        fio.write_image(os.path.join(d, f"{i + 1:05d}_img2.ppm"),
                        _img(rng, h, w))
        fio.write_flo(os.path.join(d, f"{i + 1:05d}_flow.flo"),
                      (rng.randn(h, w, 2) * 3).astype(np.float32))
    with open(os.path.join(roots["chairs"], "chairs_split.txt"), "w") as f:
        f.write("1\n2\n2\n1\n")
    for cam_dir, kind in (("frames_cleanpass/TRAIN/A/0000/left", "png"),
                          ("optical_flow/TRAIN/A/0000/into_future/left",
                           "pfm"),
                          ("optical_flow/TRAIN/A/0000/into_past/left",
                           "pfm")):
        d = os.path.join(roots["things"], cam_dir)
        os.makedirs(d, exist_ok=True)
        for k in range(3):
            if kind == "png":
                fio.write_image(os.path.join(d, f"{k:04d}.png"),
                                _img(rng, 32, 48))
            else:
                fio.write_pfm(os.path.join(d, f"{k:04d}.pfm"),
                              (rng.randn(32, 48, 3) * 2).astype(np.float32))
    _write_raw(roots["raw"], rng)
    os.makedirs(roots["lists"], exist_ok=True)
    kt = os.path.join(roots["kitti"], "training")
    for name, sub, suffix in (("image0", "image_2", "_10"),
                              ("image1", "image_2", "_11"),
                              ("flow", "flow_occ", "_10")):
        fio.write_paths(
            os.path.join(roots["lists"],
                         f"kitti_scene_flow_train_{name}.txt"),
            [os.path.join(kt, sub, f"{i:06d}{suffix}.png")
             for i in range(n_kitti)])
    return roots


def _write_raw(raw, rng):
    """A KITTI raw drive: the three calibration files, OXTS packets for
    frames 0-3 and the scene-flow -> raw mapping of scene 0."""
    date, drive = "2011_09_26", "2011_09_26_drive_0005_sync"
    os.makedirs(os.path.join(raw, date, drive, "oxts", "data"),
                exist_ok=True)

    def row(n):
        return " ".join(f"{v:.6e}" for v in rng.randn(n))

    with open(os.path.join(raw, date, "calib_imu_to_velo.txt"), "w") as f:
        f.write(f"calib_time: x\nR: {row(9)}\nT: {row(3)}\n")
    with open(os.path.join(raw, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write(f"R: {row(9)}\nT: {row(3)}\n")
    with open(os.path.join(raw, date, "calib_cam_to_cam.txt"), "w") as f:
        for k in ("P_rect_00", "P_rect_01", "P_rect_02", "P_rect_03"):
            p = rng.randn(12)
            p[0] = 700 + rng.rand()
            f.write(f"{k}: " + " ".join(f"{v:.6e}" for v in p) + "\n")
        f.write(f"R_rect_00: {row(9)}\n")
    for k in range(4):
        lat, lon = 49.0 + 1e-5 * k, 8.4 + 1e-5 * k
        vals = [lat, lon, 110.0 + k, *(0.01 * rng.randn(3))] + [0.0] * 24
        with open(os.path.join(raw, date, drive, "oxts", "data",
                               f"{k:010d}.txt"), "w") as f:
            f.write(" ".join(f"{v:.9f}" for v in vals) + "\n")
    with open(os.path.join(raw, "train_mapping.txt"), "w") as f:
        f.write(f"{date} {drive} 1\n\n\n")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return write_layouts(str(tmp_path_factory.mktemp("layouts")))


def _same(a, b):
    """Nested samples (arrays, dicts, tuples) equal bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (str, int)):
        assert a == b
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        assert np.array_equal(x, y)


def _same_sets(jset, tset):
    assert len(jset) == len(tset) > 0
    for i in range(len(jset)):
        _same(jset[i], tset[i])


@pytest.mark.parametrize("split", ["training", "testing"])
def test_kitti(roots, split):
    _same_sets(jds.KITTI(split=split, root=roots["kitti"]),
               tds.KITTI(split=split, root=roots["kitti"]))


@pytest.mark.parametrize("split", ["training", "test"])
def test_sintel(roots, split):
    for dstype in ("clean", "final"):
        _same_sets(jds.MpiSintel(split=split, root=roots["sintel"],
                                 dstype=dstype),
                   tds.MpiSintel(split=split, root=roots["sintel"],
                                 dstype=dstype))


def test_chairs_things_concat_subset(roots):
    kw = {"root": os.path.join(roots["chairs"], "data"),
          "split_file": os.path.join(roots["chairs"], "chairs_split.txt")}
    for split in ("training", "validation"):
        _same_sets(jds.FlyingChairs(split=split, **kw),
                   tds.FlyingChairs(split=split, **kw))
    jt = jds.FlyingThings3D(root=roots["things"])
    tt = tds.FlyingThings3D(root=roots["things"])
    _same_sets(jt, tt)
    _same_sets(jt + 2 * jds.KITTI(root=roots["kitti"]),
               tt + 2 * tds.KITTI(root=roots["kitti"]))
    _same_sets(jds.Subset(jt, [3, 0]), tds.Subset(tt, [3, 0]))
    # the transforms branch: Scale, then the finite-flow mask
    _same_sets(
        jds.FlyingThings3D(root=roots["things"], transforms=jtr.Compose(
            [jtr.Scale(20, 30), jtr.ToFloat01()])),
        tds.FlyingThings3D(root=roots["things"], transforms=ttr.Compose(
            [ttr.Scale(20, 30), ttr.ToFloat01()])))


def test_refusals(roots):
    """HD1K raises, as in the reference; an unknown stage raises.  (The
    training augmentors are ported: aug_params builds the augmentor.)"""
    with pytest.raises(NotImplementedError, match="HD1K"):
        tds.HD1K(root=roots["kitti"])
    assert type(tds.KITTI({"crop_size": (32, 32)}, root=roots["kitti"])
                .augmentor).__name__ == "SparseFlowAugmentor"
    with pytest.raises(ValueError, match="unknown stage"):
        tds.fetch_dataset("hd1k", (32, 32))


@pytest.mark.parametrize("valset", ["kitti2015", "kitti2012", "sintel"])
def test_evaluation_sets(roots, valset):
    """get_evaluation_set: Scale (PIL bilinear) + /255, at a size that
    up- and downscales."""
    args = Namespace(img_height=40, img_width=80, kitti_dir=(
        roots["kitti"] if valset == "kitti2015" else roots["kitti2012"]),
        sintel_dir=roots["sintel"], example=0)
    j, t = (m.get_evaluation_set(valset, args) for m in (jval, tval))
    if valset != "sintel":
        j.N = t.N = 3  # the layout holds 3 of KITTI's 200 / 194 scenes
    _same_sets(j, t)


def test_kitti_true_motion_and_multiview(roots):
    """--true_motion: the calib and poses of KITTI raw through the
    scene-flow mapping, scaled with the frames; the multiview split."""
    args = Namespace(img_height=40, img_width=80, kitti_dir=roots["kitti"],
                     kitti_raw_dir=roots["raw"], example=0, true_motion=True)
    j, t = (m.get_evaluation_set("kitti2015", args) for m in (jval, tval))
    j.N = t.N = 1
    _same_sets(j, t)
    assert t[0][5]["cam"]["P_rect_00"].shape == (4, 4)
    j, t = (m.ValidationFlowKitti2015MV(roots["kitti"], N=2)
            for m in (jval, tval))
    for i in (0, 1):
        for s in (j, t):
            s.start = 10 - i  # frames 10 (with GT) and 9 (without)
        _same(j[0], t[0])


def test_kitti_raw(roots):
    mapping = {"Scene": "2011_09_26", "Sequence": "2011_09_26_drive_0005_sync",
               "Frame": 1}
    _same(jraw.load_calib_and_poses(roots["raw"], mapping),
          traw.load_calib_and_poses(roots["raw"], mapping))
    _same(jraw.read_calib_file(os.path.join(roots["raw"], "2011_09_26",
                                            "calib_cam_to_cam.txt")),
          traw.read_calib_file(os.path.join(roots["raw"], "2011_09_26",
                                            "calib_cam_to_cam.txt")))


@pytest.mark.parametrize("size", [(16, 40), (45, 70), (60, 90)])
def test_kitti_pair_dataset(roots, size):
    """cv2.INTER_LINEAR frames and the sparse-aware gt_small, bit for bit,
    from the attack CLI's path lists."""
    j, t = (m.KittiPairDataset.from_lists(roots["lists"], n_height=size[0],
                                          n_width=size[1])
            for m in (jval, tval))
    _same_sets(j, t)
    assert t[0][2].shape == size + (3,) and t[0][2][..., 2].any()


def test_random_transforms_draw_in_order(roots):
    img = [np.random.RandomState(1).randint(0, 256, (30, 40, 3)).astype(
        np.float32) for _ in range(2)]
    random.seed(3)
    np.random.seed(3)
    want = [jtr.RandomHorizontalFlip()(img) for _ in range(4)]
    want += [jtr.RandomScaleCrop(24, 32)(img) for _ in range(3)]
    want += [jtr.RandomCrop(20, 20)(img) for _ in range(3)]
    py, nps = random.Random(3), np.random.RandomState(3)
    got = [ttr.RandomHorizontalFlip(py)(img) for _ in range(4)]
    got += [ttr.RandomScaleCrop(24, 32, nps)(img) for _ in range(3)]
    got += [ttr.RandomCrop(20, 20, nps)(img) for _ in range(3)]
    _same(want, got)
    norm = ([0.5] * 3, [0.2] * 3)
    _same(jtr.Compose([jtr.ToFloat(), jtr.Normalize(*norm)])(img),
          ttr.Compose([ttr.ToFloat(), ttr.Normalize(*norm)])(img))


@pytest.mark.parametrize("mode", ["kitti", "sintel"])
def test_pad_batch(mode):
    rng = np.random.RandomState(8)
    args = (rng.rand(2, 45, 70, 3).astype(np.float32),
            rng.rand(2, 45, 70, 3).astype(np.float32),
            rng.randn(2, 45, 70, 2).astype(np.float32),
            (rng.rand(2, 45, 70) > 0.5).astype(np.float32))
    _same(jloader.pad_batch(*args, multiple=8, mode=mode),
          tloader.pad_batch(*args, multiple=8, mode=mode))
