"""The port's baseline JPEG decoder (``native/src/ufr_jpeg.cpp``) against
PIL's libjpeg-turbo, on the CPU: bit-equal samples on the committed
KITTI-raw fixtures and on files this test writes with PIL (sizes that are no
multiples of 8 or 16, 4:4:4 / 4:2:2 / 4:2:0, grey, quality 50-95, restart
intervals), a clear error on the kinds it does not take, and the readers of
``flowviz.io`` and ``SequenceFolder`` on JPEG frames.

``make_kitti_raw_fixture`` is the helper that made the fixtures under
``understanding_flow_robustness_tpu_torch/data/fixtures/kitti_raw_jpeg``:
one prepared-KITTI-raw scene of four 375x1242 frames (PIL's defaults,
quality 75, 4:2:0) of smooth seeded content moving right, the scene lists
and ``cam.txt``, and the sha256 of PIL's decode of each frame.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from understanding_flow_robustness_tpu.flowviz import io as jio
from understanding_flow_robustness_tpu_torch import native
from understanding_flow_robustness_tpu_torch.data import fixtures_dir
from understanding_flow_robustness_tpu_torch.flowviz import io as tio

FIXTURE = fixtures_dir("kitti_raw_jpeg")
SCENE = "2011_09_26_drive_0001_sync_02"


def _smooth_frames(n, h, w, seed, shift=6):
    """n frames of smooth random blobs with fine texture, each the last
    moved ``shift`` px right."""
    rng = np.random.RandomState(seed)
    big_w = w + shift * n
    lo = rng.rand(h // 25 + 2, big_w // 25 + 2, 3)
    ys = np.linspace(0, lo.shape[0] - 1.001, h)
    xs = np.linspace(0, lo.shape[1] - 1.001, big_w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    canvas = ((1 - fy) * ((1 - fx) * lo[y0][:, x0] + fx * lo[y0][:, x0 + 1])
              + fy * ((1 - fx) * lo[y0 + 1][:, x0]
                      + fx * lo[y0 + 1][:, x0 + 1])) * 200 + 20
    canvas += rng.randn(h, big_w, 3) * 9
    canvas = np.clip(canvas, 0, 255).astype(np.uint8)
    start = shift * (n - 1)
    return [canvas[:, start - k * shift: start - k * shift + w]
            for k in range(n)]


def make_kitti_raw_fixture(root, seed=0, n=4, size=(375, 1242)):
    """Writes the fixture tree under ``root``; returns the decode hashes."""
    scene = os.path.join(root, SCENE)
    os.makedirs(scene, exist_ok=True)
    hashes = {}
    for k, frame in enumerate(_smooth_frames(n, *size, seed)):
        name = f"{k:010d}.jpg"
        path = os.path.join(scene, name)
        Image.fromarray(frame).save(path)  # quality 75, 4:2:0
        hashes[f"{SCENE}/{name}"] = hashlib.sha256(
            np.array(Image.open(path)).tobytes()).hexdigest()
    with open(os.path.join(scene, "cam.txt"), "w") as f:
        f.write("721.5377,0.0,609.5593\n0.0,721.5377,172.854\n0.0,0.0,1.0\n")
    for split in ("train.txt", "val.txt"):
        with open(os.path.join(root, split), "w") as f:
            f.write(SCENE + "\n")
    with open(os.path.join(root, "decoded_sha256.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
    return hashes


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data):
    return np.array(Image.open(io.BytesIO(data)))


def test_fixtures_decode_as_recorded():
    with open(os.path.join(FIXTURE, "decoded_sha256.json")) as f:
        hashes = json.load(f)
    assert len(hashes) == 4
    for rel, want in hashes.items():
        path = os.path.join(FIXTURE, rel)
        got = tio.read_samples(path)
        assert got.shape == (375, 1242, 3) and got.dtype == np.uint8
        assert hashlib.sha256(got.tobytes()).hexdigest() == want
        assert np.array_equal(got, np.array(Image.open(path)))


def test_fixture_helper_writes_the_layout(tmp_path):
    hashes = make_kitti_raw_fixture(str(tmp_path), n=3, size=(40, 70))
    assert len(hashes) == 3
    assert sorted(os.listdir(tmp_path / SCENE)) == [
        "0000000000.jpg", "0000000001.jpg", "0000000002.jpg", "cam.txt"]


# (h, w) sizes: MCU multiples, ragged edges, chroma widths of 1-3
SIZES = [(16, 16), (8, 24), (17, 31), (33, 47), (61, 83), (5, 3), (2, 5),
         (100, 9), (375, 124)]


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_colour_files_match_pil(size, subsampling):
    rng = np.random.RandomState(hash(size) % 1000 + subsampling)
    h, w = size
    img = _smooth_frames(1, h, w, rng.randint(1 << 30), shift=0)[0]
    for quality in (50, 75, 95):
        data = _jpeg(img, quality=quality, subsampling=subsampling)
        assert np.array_equal(native.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("blocks", [1, 2, 5])
def test_restart_intervals_match_pil(blocks):
    img = np.random.RandomState(blocks).randint(0, 256, (45, 77, 3)).astype(
        np.uint8)
    for subsampling in (0, 2):
        data = _jpeg(img, quality=80, subsampling=subsampling,
                     restart_marker_blocks=blocks)
        assert b"\xff\xdd" in data
        assert np.array_equal(native.decode_jpeg(data), _pil(data))


def test_grey_and_noise_match_pil():
    rng = np.random.RandomState(3)
    for h, w in ((1, 1), (9, 17), (64, 65)):
        grey = rng.randint(0, 256, (h, w)).astype(np.uint8)
        data = _jpeg(grey, quality=90)
        got = native.decode_jpeg(data)
        assert got.shape == (h, w) and np.array_equal(got, _pil(data))
        # noise drives the IDCT to its range limits
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        data = _jpeg(rgb, quality=95, subsampling=2)
        assert np.array_equal(native.decode_jpeg(data), _pil(data))


def test_readers_on_jpeg(tmp_path):
    img = _smooth_frames(1, 37, 58, 5, shift=0)[0]
    path = str(tmp_path / "a.jpg")
    Image.fromarray(img).save(path)
    want = np.array(Image.open(path))
    assert np.array_equal(tio.read_image(path), jio.read_image(path))
    assert tio.read_image(path).dtype == np.float32
    assert np.array_equal(tio.read_gen(path), want)
    assert np.array_equal(tio.read_gen(path), np.array(jio.read_gen(path)))


def test_refuses_what_it_does_not_decode(tmp_path):
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="progressive"):
        native.decode_jpeg(_jpeg(img, progressive=True))
    cmyk = io.BytesIO()
    Image.new("CMYK", (16, 16)).save(cmyk, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        native.decode_jpeg(cmyk.getvalue())
    with pytest.raises(ValueError, match="not a JPEG"):
        native.decode_jpeg(b"\x89PNG\r\n")
    path = str(tmp_path / "p.jpg")
    with open(path, "wb") as f:
        f.write(_jpeg(img, progressive=True))
    with pytest.raises(ValueError, match="p.jpg: progressive"):
        tio.read_image(path)
