"""KITTI raw preparation in the PyTorch port against the JAX package's
``setup/prepare_train_data.py``, on the CPU: ``native.
resize_pil_lanczos_u8`` against Pillow's LANCZOS, bit for bit, and the
port's ``cli.prepare_train_data`` against the setup script (run here with
PIL) on a KITTI raw tree the test writes: 375x1242 PNG frames, OXTS files
with static frames, ``calib_cam_to_cam.txt``, a drive with fewer than 3
moving frames and a drive whose calibration is missing.  The two dumps
hold the same scenes, split, ``cam.txt`` files and JPEG bytes, and the
port's ``SequenceFolder`` reads the port's."""

import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image

from understanding_flow_robustness_tpu_torch.cli import (
    prepare_train_data as tprep,
)
from understanding_flow_robustness_tpu_torch.data import SequenceFolder
from understanding_flow_robustness_tpu_torch.flowviz import io as fio
from understanding_flow_robustness_tpu_torch.flowviz.png import png_size
from understanding_flow_robustness_tpu_torch.native import (
    resize_pil_lanczos_u8,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 375, 1242


def _setup_script():
    spec = importlib.util.spec_from_file_location(
        "setup_prepare_train_data",
        os.path.join(REPO, "setup", "prepare_train_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _natural(rng, h, w, c=3):
    """Smooth structure, edges and noise, like a street frame."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = [120 + 90 * np.sin(xx / (17 + 9 * k) + yy / (23 + 5 * k))
            + 25 * np.cos(yy / 7.0) for k in range(c)]
    img = np.stack(base, -1) + rng.randn(h, w, c) * 12
    img[h // 3:h // 2, w // 5:w // 3] = 250  # a flat, saturated block
    img[: h // 8] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_lanczos(img, oh, ow):
    return np.asarray(Image.fromarray(img).resize((ow, oh), Image.LANCZOS))


@pytest.mark.parametrize("kind,src,dst", [
    ("natural", (H, W), (128, 416)),
    ("flat", (H, W), (128, 416)),
    ("natural", (61, 83), (140, 190)),     # upsampling
    ("noise", (37, 53), (19, 29)),         # odd sizes
    ("noise", (1, 90), (1, 31)),           # 1 x N
    ("noise", (70, 1), (23, 1)),
    ("natural", (64, 96), (64, 96)),       # the same size: a copy
])
@pytest.mark.parametrize("channels", [3, 1])
def test_lanczos_matches_pillow(kind, src, dst, channels):
    rng = np.random.RandomState(sum(src) + channels)
    if kind == "natural":
        img = _natural(rng, *src, channels)
    elif kind == "flat":  # 0 / 255 blocks: the lobes overshoot both ends
        img = np.zeros(src + (channels,), np.uint8)
        img[:, src[1] // 2:] = 255
        img[src[0] // 3: src[0] // 2, 50:300] = 255
        img[src[0] // 2:, 700:900] = 0
    else:
        img = rng.randint(0, 256, src + (channels,)).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    got = resize_pil_lanczos_u8(img, *dst)
    want = _pil_lanczos(img, *dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_lanczos_refusals():
    with pytest.raises(ValueError):
        resize_pil_lanczos_u8(np.zeros((4, 4, 4), np.uint8), 2, 2)
    with pytest.raises(ValueError):
        resize_pil_lanczos_u8(np.zeros((4, 4, 3), np.uint8), 0, 2)


CALIB = ("calib_time: 09-Jan-2012 13:57:47\n"
         "corner_dist: 9.950000e-02\n"
         "P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 "
         "0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 "
         "0.000000e+00 1.000000e+00 2.745884e-03\n"
         "P_rect_03: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 "
         "0.000000e+00 7.215377e+02 1.728540e+02 2.199936e+00 0.000000e+00 "
         "0.000000e+00 1.000000e+00 2.729905e-03\n")

# date -> drive -> the speeds of its frames (m/s); "2011_09_28" has no
# calib_cam_to_cam.txt
DRIVES = {
    "2011_09_26": {"2011_09_26_drive_0001_sync": [5.0, 0.2, 7.5, 9.0, 3.3],
                   "2011_09_26_drive_0002_sync": [0.1, 8.0, 0.5, 6.0],
                   "2011_09_26_drive_0005_sync": [2.0, 2.5, 3.0, 0.9]},
    "2011_09_28": {"2011_09_28_drive_0001_sync": [4.0, 4.0, 4.0]},
}


def write_raw_tree(root, drives=DRIVES, h=H, w=W, seed=0):
    """A KITTI raw tree: per date a calibration (but the last date), per
    drive image_02/data/*.png and oxts/data/*.txt (30 fields, vf/vl/vu at
    8-10)."""
    rng = np.random.RandomState(seed)
    for d, (date, ds) in enumerate(drives.items()):
        os.makedirs(os.path.join(root, date))
        if d < len(drives) - 1:
            with open(os.path.join(root, date, "calib_cam_to_cam.txt"),
                      "w") as f:
                f.write(CALIB)
        for drive, speeds in ds.items():
            img_dir = os.path.join(root, date, drive, "image_02", "data")
            oxts_dir = os.path.join(root, date, drive, "oxts", "data")
            os.makedirs(img_dir)
            os.makedirs(oxts_dir)
            for i, v in enumerate(speeds):
                fio.write_image(os.path.join(img_dir, f"{i:010d}.png"),
                                _natural(rng, h, w))
                vals = rng.randn(30)
                vals[8:11] = np.array([0.8, 0.36, 0.48]) * v
                np.savetxt(os.path.join(oxts_dir, f"{i:010d}.txt"),
                           vals[None], fmt="%.6f")


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kitti_raw")
    write_raw_tree(str(tmp / "raw"))
    argv = ["--dataset_dir", str(tmp / "raw"), "--val_fraction", "0.5"]
    _setup_script().main(argv + ["--dump_root", str(tmp / "jax")])
    res = {w: tprep.main(argv + ["--dump_root", str(tmp / f"port{w}"),
                                 "--num_workers", str(w)])
           for w in (1, 8)}
    return tmp, res


def test_prepared_dump_equals_the_setup_scripts(dumps, capsys):
    """Scenes, split, cam.txt and every JPEG, byte for byte; the short
    drive is left out of the lists and the uncalibrated one skipped."""
    tmp, res = dumps
    want, got = _tree(tmp / "jax"), _tree(tmp / "port8")
    assert sorted(got) == sorted(want)
    jpgs = [k for k in want if k.endswith(".jpg")]
    assert len(jpgs) == 4 + 2 + 3  # kept frames of drives 0001, 0002, 0005
    for k in sorted(want):
        assert got[k] == want[k], k
    assert want["train.txt"] == b"2011_09_26_drive_0005_sync\n"
    assert want["val.txt"] == b"2011_09_26_drive_0001_sync\n"
    assert res[8]["scenes"] == ["2011_09_26_drive_0001_sync",
                                "2011_09_26_drive_0005_sync"]
    assert res[8]["frames"] == 9
    assert all(v > 0 for v in res[8]["seconds"].values())
    # the JPEGs decode to the resized frames' encodings' pixels
    j = Image.open(io.BytesIO(want[jpgs[0]]))
    assert j.size == (416, 128) and j.mode == "RGB"


def test_dump_does_not_depend_on_the_workers(dumps):
    tmp, res = dumps
    assert _tree(tmp / "port1") == _tree(tmp / "port8")
    assert res[1]["scenes"] == res[8]["scenes"]


def test_skipped_drive_warns_as_the_setup_script(tmp_path, capsys):
    """The uncalibrated drive gets the setup script's warning line."""
    drives = {"2011_09_26": {"2011_09_26_drive_0001_sync": [5.0] * 3},
              "2011_09_28": {"2011_09_28_drive_0001_sync": [5.0] * 3}}
    write_raw_tree(str(tmp_path / "raw"), drives, h=40, w=60)
    argv = ["--dataset_dir", str(tmp_path / "raw"), "--height", "16",
            "--width", "24"]
    outs = []
    for name, fn in (("jax", _setup_script().main), ("port", tprep.main)):
        capsys.readouterr()
        fn(argv + ["--dump_root", str(tmp_path / name)])
        outs.append(capsys.readouterr().out.replace(str(tmp_path / name),
                                                    "<dump>"))
    assert outs[0] == outs[1] and "WARNING: skipping drive" in outs[0]
    # the only scene goes to train
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port" / "val.txt").read_text() == "\n"


def test_sequence_folder_reads_the_dump(dumps):
    tmp, _ = dumps
    train = SequenceFolder(str(tmp / "port8"), seed=0, train=True)
    val = SequenceFolder(str(tmp / "port8"), seed=0, train=False)
    assert len(train) == 3 - 2 and len(val) == 4 - 2
    tgt, refs, k = val[0]
    assert tgt.shape == (128, 416, 3) and len(refs) == 2
    cam = np.genfromtxt(str(tmp / "port8" / "2011_09_26_drive_0001_sync" /
                            "cam.txt"), delimiter=",")
    np.testing.assert_allclose(k, cam.astype(np.float32))
    assert abs(k[0, 0] - 721.5377 * 416 / W) < 1e-3


def test_png_size_reads_the_header(tmp_path):
    img = np.zeros((7, 11, 3), np.uint8)
    fio.write_image(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    assert png_size(data[:24]) == (11, 7) == Image.open(tmp_path / "a.png").size
    with pytest.raises(ValueError):
        png_size(b"GIF89a" + bytes(18))
