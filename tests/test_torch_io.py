"""The port's readers, writers, PNG codec and host library on the CPU.

Files written by cv2 (adaptive row filters), by PIL and by the port's own
writer must read back bit-equal through the port, through the JAX
package's ``flowviz/io.py`` and through cv2 / PIL; the host library's
functions must equal the JAX package's ``native`` bit for bit, and its two
resizes PIL's ``BILINEAR`` and cv2's ``INTER_LINEAR`` (of a float32 image)
bit for bit.  A last test reads every format of the evaluation path in an
interpreter where ``cv2`` and ``PIL`` cannot be imported.
"""

import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from understanding_flow_robustness_tpu import native as jnative
from understanding_flow_robustness_tpu.data.augmentor import (
    SparseFlowAugmentor,
)
from understanding_flow_robustness_tpu.flowviz import flow_viz as jviz
from understanding_flow_robustness_tpu.flowviz import io as jio
from understanding_flow_robustness_tpu_torch import native as tnative
from understanding_flow_robustness_tpu_torch.data import imresize
from understanding_flow_robustness_tpu_torch.flowviz import flow_viz as tviz
from understanding_flow_robustness_tpu_torch.flowviz import io as tio
from understanding_flow_robustness_tpu_torch.flowviz import png as tpng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smooth(rng, shape, dtype=np.uint8):
    """A blurred random image: cv2's and PIL's encoders pick other row
    filters for it than 0."""
    hi = np.iinfo(dtype).max
    x = cv2.GaussianBlur(rng.rand(*shape).astype(np.float32), (0, 0), 2)
    x = (x - x.min()) / (x.max() - x.min() + 1e-9)
    return (x * hi).astype(dtype)


def _filter_types(path):
    """The filter type byte of every row of a PNG file."""
    data = open(path, "rb").read()
    chunks = dict(tpng._chunks(data))
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    idat = b"".join(b for t, b in tpng._chunks(data) if t == b"IDAT")
    raw = zlib.decompress(idat)
    row = 1 + w * tpng.CHANNELS[colour] * depth // 8
    return {raw[y * row] for y in range(h)}


def _unfilter_oracle(raw, h, row_bytes, bpp):
    """The PNG spec's reconstruction, one byte at a time."""
    out = np.zeros((h, row_bytes), np.int64)
    for y in range(h):
        t = int(raw[y * (row_bytes + 1)])
        src = raw[y * (row_bytes + 1) + 1:(y + 1) * (row_bytes + 1)]
        for i in range(row_bytes):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if (y and i >= bpp) else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else (b if pb <= pc else c)][t]
            out[y, i] = (int(src[i]) + pred) % 256
    return out.astype(np.uint8)


def _filter_rows(rows, types, bpp):
    """The PNG spec's forward filters, one type per row (numpy)."""
    x = rows.astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) // 2, paeth]
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    for y, t in enumerate(types):
        out[y, 0] = t
        out[y, 1:] = (x[y] - preds[t][y]) % 256
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_matches_the_spec(bpp):
    rng = np.random.RandomState(bpp)
    h, row_bytes = 11, 7 * bpp
    rows = rng.randint(0, 256, (h, row_bytes)).astype(np.uint8)
    types = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 4]
    raw = _filter_rows(rows, types, bpp)
    assert np.array_equal(_unfilter_oracle(raw.ravel(), h, row_bytes, bpp),
                          rows)
    assert np.array_equal(
        tnative.png_unfilter(raw.ravel(), h, row_bytes, bpp), rows)
    raw[4, 0] = 5
    with pytest.raises(ValueError, match="row 4 has filter type 5"):
        tnative.png_unfilter(raw.ravel(), h, row_bytes, bpp)


CV2_CASES = [("rgb8", (37, 53, 3), np.uint8), ("grey8", (37, 53), np.uint8),
             ("rgba8", (37, 53, 4), np.uint8),
             ("rgb16", (37, 53, 3), np.uint16),
             ("grey16", (37, 53), np.uint16)]


@pytest.mark.parametrize("name,shape,dtype", CV2_CASES)
def test_reads_cv2_files(tmp_path, name, shape, dtype):
    """cv2's default write (Sub on every row) and its adaptive choice
    among all five filters; the port reads the file's own channel order
    (cv2 stores BGR(A) as RGB(A))."""
    img = _smooth(np.random.RandomState(1), shape, dtype)
    for flags in ([], [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]):
        path = str(tmp_path / f"{name}{len(flags)}.png")
        cv2.imwrite(path, img, flags)
        if flags:
            assert len(_filter_types(path)) > 1
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if want.ndim == 3:
            want = want[..., [2, 1, 0, 3][:want.shape[2]]]
        got = tio.read_samples(path)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # and as the JAX package reads images (16-bit colour: PIL's high
        # byte)
        assert np.array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "I;16"])
def test_reads_pil_files(tmp_path, mode):
    rng = np.random.RandomState(2)
    shape = {"RGB": (29, 41, 3), "L": (29, 41), "RGBA": (29, 41, 4),
             "LA": (29, 41, 2), "I;16": (29, 41)}[mode]
    img = _smooth(rng, shape, np.uint16 if mode == "I;16" else np.uint8)
    path = str(tmp_path / "pil.png")
    Image.fromarray(img).convert(mode).save(path)
    want = np.array(Image.open(path))
    got = tio.read_samples(path)
    assert np.array_equal(got, want) and got.dtype == want.dtype
    assert np.array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize("shape,dtype", [((23, 31, 3), np.uint8),
                                         ((23, 31), np.uint8),
                                         ((23, 31, 4), np.uint8),
                                         ((23, 31, 3), np.uint16),
                                         ((23, 31), np.uint16)])
def test_port_writer_round_trips(tmp_path, shape, dtype):
    """Filter 0 on every row; cv2, PIL and the port decode what was
    written."""
    img = np.random.RandomState(3).randint(
        0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "port.png")
    tio.write_image(path, img)
    assert _filter_types(path) == {0}
    assert np.array_equal(tio.read_samples(path), img)
    cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if cv.ndim == 3:
        cv = cv[..., [2, 1, 0, 3][:cv.shape[2]]]
    assert np.array_equal(cv, img)
    if dtype == np.uint8 or len(shape) == 2:
        assert np.array_equal(np.array(Image.open(path)), img)


def test_kitti_flow_and_disparity_png(tmp_path):
    """KITTI's 16-bit flow (sparse valid mask) and disparity PNGs: written
    by cv2 through the JAX package and by the port, read equal by both."""
    rng = np.random.RandomState(4)
    flow = (rng.randn(37, 53, 2) * 40).astype(np.float32)
    valid = (rng.rand(37, 53) > 0.6).astype(np.float32)
    disp = (rng.rand(37, 53) * 200).astype(np.float32)
    for writer in (jio, tio):
        p = str(tmp_path / f"{writer.__name__}.png")
        writer.write_flow_png(p, flow, valid)
        jf, jv = jio.read_flow_png(p)
        tf, tv = tio.read_flow_png(p)
        assert np.array_equal(jf, tf) and np.array_equal(jv, tv)
        assert np.array_equal(tv, valid)
        assert np.abs(tf - flow).max() <= 1 / 64
    p = str(tmp_path / "disp.png")
    cv2.imwrite(p, (disp * 256).astype(np.uint16))
    assert np.array_equal(tio.read_disparity_png(p), jio.read_disparity_png(p))
    with pytest.raises(ValueError, match="16-bit RGB"):
        tio.read_flow_png(p)


def test_flo_pfm_ppm_pgm(tmp_path):
    rng = np.random.RandomState(5)
    flow = rng.randn(13, 17, 2).astype(np.float32)
    for w, r in ((jio, tio), (tio, jio)):
        p = str(tmp_path / f"{w.__name__}.flo")
        w.write_flo(p, flow)
        assert np.array_equal(r.read_flo(p), flow)
        for img in (rng.randn(13, 17, 3).astype(np.float32),
                    rng.randn(13, 17).astype(np.float32)):
            p = str(tmp_path / f"{w.__name__}.pfm")
            w.write_pfm(p, img)
            assert np.array_equal(r.read_pfm(p), img)
            assert np.array_equal(np.asarray(tio.read_gen(p)),
                                  np.asarray(jio.read_gen(p)))
    img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    for ext, x in ((".ppm", img), (".pgm", img[..., 0])):
        p = str(tmp_path / f"cv{ext}")
        cv2.imwrite(p, x[..., ::-1] if x.ndim == 3 else x)
        assert np.array_equal(tio.read_samples(p), x)
        assert np.array_equal(tio.read_image(p), jio.read_image(p))
        q = str(tmp_path / f"port{ext}")
        tio.write_image(q, x)
        assert np.array_equal(np.array(Image.open(q)), x)
        assert np.array_equal(tio.read_samples(q), x)
    # a comment in the header, as some writers put one
    p = str(tmp_path / "c.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n# made by hand\n17 13\n255\n" + img.tobytes())
    assert np.array_equal(tio.read_samples(p), img)
    assert np.array_equal(tio.read_gen(p), np.array(jio.read_gen(p)))


def test_png_refusals(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    p = str(tmp_path / "pal.png")
    Image.fromarray(img).convert("P").save(p)
    with pytest.raises(ValueError, match="palette"):
        tio.read_samples(p)
    data = bytearray(tpng.encode_png(img))
    data[-20] ^= 1  # inside IDAT: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        tpng.decode_png(bytes(data))
    ihdr = struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 1)
    with pytest.raises(ValueError, match="interlaced"):
        tpng.decode_png(tpng.SIGNATURE + struct.pack(">I4s", 13, b"IHDR")
                        + ihdr + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
                        + tpng.encode_png(img)[33:])
    # JPEG is read now (tests/test_torch_jpeg.py); a progressive one raises
    Image.fromarray(img).save(str(tmp_path / "x.jpg"), progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        tio.read_image(str(tmp_path / "x.jpg"))


@pytest.mark.skipif(not jnative.available(),
                    reason="the JAX package's native library does not build")
def test_native_matches_jax_native():
    rng = np.random.RandomState(6)
    x = rng.randint(0, 256, (2, 37, 45, 3)).astype(np.uint8)
    assert np.array_equal(tnative.batch_u8_to_float01_pad(x, 40, 48, 0, 1),
                          jnative.batch_u8_to_float01_pad(x, 40, 48, 0, 1))
    f = rng.randn(2, 37, 45, 2).astype(np.float32)
    for zero in (False, True):
        assert np.array_equal(tnative.batch_f32_pad(f, 40, 48, 1, 2, zero),
                              jnative.batch_f32_pad(f, 40, 48, 1, 2, zero))
    flow = (rng.randn(37, 45, 2) * 10).astype(np.float32)
    valid = (rng.rand(37, 45) > 0.5).astype(np.float32)
    for got, want in zip(tnative.resize_sparse_flow(flow, valid, 0.51, 0.7),
                         jnative.resize_sparse_flow(flow, valid, 0.51, 0.7)):
        assert np.array_equal(got, want)
    for shape in ((37, 45, 3), (37, 45)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        assert np.array_equal(tnative.resize_bilinear_u8(img, 20, 61),
                              jnative.resize_bilinear_u8(img, 20, 61))
    u = rng.randint(0, 65536, (37, 45, 3)).astype(np.uint16)
    for got, want in zip(tnative.decode_kitti_flow_u16(u),
                         jnative.decode_kitti_flow_u16(u)):
        assert np.array_equal(got, want)


RESIZES = [((375, 1242), (384, 1280)), ((375, 1242), (256, 640)),
           ((370, 1224), (384, 1280)), ((20, 31), (7, 9)),
           ((7, 9), (20, 31)), ((16, 16), (8, 8)), ((33, 47), (33, 20)),
           ((33, 47), (10, 47)), ((5, 3), (17, 2)), ((4, 6), (4, 6))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resizes_match_pil_and_cv2(src, dst):
    """Bit-equal: ``imresize`` to PIL's BILINEAR (u8), the KITTI pair
    resize to cv2's INTER_LINEAR of the float32 image, grey and RGB."""
    rng = np.random.RandomState(7)
    (h, w), (oh, ow) = src, dst
    for shape in ((h, w, 3), (h, w)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        pil = np.array(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        assert np.array_equal(imresize(img, (oh, ow)), pil)
        cv = cv2.resize(img.astype(np.float32), (ow, oh),
                        interpolation=cv2.INTER_LINEAR)
        got = tnative.resize_cv2_linear_f32(img, oh, ow)
        assert got.shape == cv.shape and np.array_equal(got, cv)
    with pytest.raises(ValueError, match="premultiplied|ported"):
        tnative.resize_pil_bilinear_u8(np.zeros((4, 4, 4), np.uint8), 2, 2)


def test_cv2_resize_sweep():
    """Over a sweep of small shapes, 2-127 px, up- and downscales to 25x:
    the KITTI resize differs from cv2 in 0.145 % of the samples (4742 of
    3279552, measured on this sweep), each by at most 2 float32 ulps of 255
    (3.1e-5 of a grey level): OpenCV's vector code blends some upscaled columns as
    s0 (1 - f) + s1 f instead of s0 + f (s1 - s0).  The KITTI geometry
    and every case of ``test_resizes_match_pil_and_cv2`` are bit-equal."""
    rng = np.random.RandomState(11)
    n_diff = n = 0
    for h in range(5, 70, 9):
        for w in range(5, 90, 11):
            for oh, ow in ((3, 2), (16, 40), (45, 83), (100, 127)):
                img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                cv = cv2.resize(img.astype(np.float32), (ow, oh),
                                interpolation=cv2.INTER_LINEAR)
                d = np.abs(tnative.resize_cv2_linear_f32(img, oh, ow) - cv)
                assert d.max() <= 2 * np.spacing(np.float32(255))
                n_diff += int((d > 0).sum())
                n += d.size
    assert n_diff / n <= 2e-3, n_diff / n


# (h, w), (fx, fy): the attack datasets' KITTI downscale to 256x640 (many
# samples collide in a target pixel: the last one wins), an upscale, the
# identity and off-ratio scales
SPARSE = [((375, 1242), (640 / 1242, 256 / 375)),
          ((370, 1224), (640 / 1224, 256 / 370)),
          ((23, 31), (2.5, 1.7)), ((23, 31), (1.0, 1.0)),
          ((40, 57), (0.51, 0.7)), ((9, 5), (0.6, 0.34))]


@pytest.mark.parametrize("src,scale", SPARSE)
def test_resize_sparse_flow_matches_numpy(src, scale):
    """The host library's sparse-aware flow resize, which
    ``KittiPairDataset`` runs, bit-equal to the JAX package's numpy
    ``SparseFlowAugmentor.resize_sparse_flow_map``, with a valid mask of
    0, 1 and fractional values (only those >= 1 count)."""
    rng = np.random.RandomState(12)
    flow = (rng.randn(*src, 2) * 20).astype(np.float32)
    valid = rng.choice([0.0, 0.5, 1.0], src, p=[0.4, 0.1, 0.5]).astype(
        np.float32)
    got = tnative.resize_sparse_flow(flow, valid, *scale)
    want = SparseFlowAugmentor.resize_sparse_flow_map(flow, valid, *scale)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[1].sum() > 0


@pytest.mark.parametrize("logscale,scaledown", [(True, 6), (False, 40),
                                                (True, 0.5)])
def test_flow_viz_matches_jax(logscale, scaledown):
    """The colour wheel of ``flowviz.flow_viz`` bit-equal to the JAX
    package's, inside and outside the unit radius, one image and a batch."""
    rng = np.random.RandomState(13)
    uv = (rng.randn(2, 17, 23, 2) * 30).astype(np.float32)
    uv[0, :3, :3] = 0
    assert np.array_equal(tviz.make_colorwheel(), jviz.make_colorwheel())
    assert np.array_equal(
        tviz.compute_flow_image(uv[0, ..., 0], uv[0, ..., 1], logscale,
                                scaledown),
        jviz.compute_flow_image(uv[0, ..., 0], uv[0, ..., 1], logscale,
                                scaledown))
    assert np.array_equal(
        tviz.batch_compute_flow_image(uv, logscale, scaledown),
        np.asarray(jviz.batch_compute_flow_image(uv, logscale, scaledown)))


def test_reads_without_cv2_and_pil(tmp_path):
    """The card's machine has neither cv2 nor PIL: with both blocked, the
    port writes and reads every format of the evaluation path and its
    datasets resize frames."""
    code = f"""
import sys
sys.modules['cv2'] = None
sys.modules['PIL'] = None
import numpy as np
from understanding_flow_robustness_tpu_torch.flowviz import io
from understanding_flow_robustness_tpu_torch.data import (
    KittiPairDataset, imresize)
from understanding_flow_robustness_tpu_torch.native import (
    resize_cv2_linear_f32)
d = {str(tmp_path)!r}
rng = np.random.RandomState(0)
img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
for name, x in (('a.png', img), ('g.png', img[..., 0]),
                ('a4.png', np.dstack([img, img[..., :1]])),
                ('g16.png', img[..., 0].astype(np.uint16) * 257),
                ('a.ppm', img), ('g.pgm', img[..., 0])):
    io.write_image(d + '/' + name, x)
    assert np.array_equal(io.read_samples(d + '/' + name), x), name
flow = rng.randn(9, 11, 2).astype(np.float32)
io.write_flow_png(d + '/f.png', flow)
io.write_flo(d + '/f.flo', flow)
io.write_pfm(d + '/f.pfm', img[..., 0].astype(np.float32))
assert np.abs(io.read_flow_png(d + '/f.png')[0] - flow).max() <= 1 / 64
assert np.array_equal(io.read_flo(d + '/f.flo'), flow)
io.read_pfm(d + '/f.pfm'); io.read_disparity_png(d + '/g16.png')
assert io.read_image(d + '/a4.png').shape == (9, 11, 4)
assert imresize(img, (5, 7)).shape == (5, 7, 3)
assert resize_cv2_linear_f32(img, 5, 7).shape == (5, 7, 3)
ds = KittiPairDataset([d + '/a.png'], [d + '/a.ppm'], [d + '/f.png'], 8, 16)
assert ds[0][0].shape == (8, 16, 3)
assert 'cv2' not in [m for m in sys.modules if sys.modules[m] is not None]
print('ok')
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
