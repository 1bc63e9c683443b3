"""The port's image writers against the JAX package's PIL-written files, on
the CPU: the attack CLI's ``--write_out`` PNGs (``log_utils``), its
``--show_evolve`` GIFs (``perturb_runner._write_evolution_gifs`` over
``flowviz/gif.py``) and ``test_patch``'s ``viz###.jpg`` panels
(``flowviz/jpeg.py``).  Every file is read back with PIL.

The GIFs: the JAX copy hands PIL RGB noise frames, which PIL quantises to
an adaptive 256-colour palette; the port writes the frames' luminance
(PIL's ``convert("L")``) under a grey palette.  So each frame is held bit
for bit to PIL's luminance of the JAX copy's normalised frame, and the
JAX file's decoded frame, converted to L, to within the palette's
quantisation of it (``GIF_L_MEAN``, ``GIF_L_P99``); the frame delays and
the loop count equal the JAX files'.
"""

import io

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image, ImageSequence

from understanding_flow_robustness_tpu.attacks import log_utils as jlog
from understanding_flow_robustness_tpu.attacks import perturb_runner as jrunner
from understanding_flow_robustness_tpu_torch import models as tmodels
from understanding_flow_robustness_tpu_torch.attacks import log_utils as tlog
from understanding_flow_robustness_tpu_torch.attacks import (
    perturb_runner as trunner,
)
from understanding_flow_robustness_tpu_torch.cli import test_patch as tcli
from understanding_flow_robustness_tpu_torch.flowviz.gif import (
    decode_gif,
    encode_gif,
    luminance,
)
from understanding_flow_robustness_tpu_torch.flowviz.io import read_samples
from understanding_flow_robustness_tpu_torch.flowviz.jpeg import encode_jpeg

# the JAX files' frames (PIL's adaptive 256-colour median cut of RGB
# noise) against their exact luminance, in grey levels; the test prints
# the largest it measured
GIF_L_MEAN = 5.0
GIF_L_P99 = 24


def _frames(path):
    im = Image.open(path)
    return ([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)],
            im.info.get("duration"), im.info.get("loop"))


def test_write_out_sample_pngs_match_jax(tmp_path):
    """Images, min-max normalised noises and flow renderings: the same PNG
    files, by PIL's reading and by the port's own reader, as the JAX
    copy's PIL-written ones."""
    rng = np.random.RandomState(0)
    h, w = 37, 53
    kw = dict(image0=rng.rand(h, w, 3), image1=rng.rand(h, w, 3),
              noise0=rng.randn(h, w, 3) * 0.01, noise1=rng.randn(h, w, 3),
              flow_output=rng.randn(h, w, 2) * 5,
              flow_origin=rng.randn(h, w, 2) * 5,
              flow_output_noise=rng.randn(h, w, 2) * 5)
    jp = jlog.create_write_folder_structure(str(tmp_path / "jax"))
    tp = tlog.create_write_folder_structure(str(tmp_path / "torch"))
    jlog.write_out_sample(jp, 3, **kw)
    tlog.write_out_sample(tp, 3, **kw)
    n = 0
    for sub in tp:
        jf, tf = tmp_path / "jax" / sub / "00003.png", \
            tmp_path / "torch" / sub / "00003.png"
        if not jf.exists():
            assert not tf.exists(), sub
            continue
        want = np.asarray(Image.open(jf))
        np.testing.assert_array_equal(np.asarray(Image.open(tf)), want,
                                      err_msg=sub)
        np.testing.assert_array_equal(read_samples(str(tf)), want,
                                      err_msg=sub)
        n += 1
    assert n >= 7


@pytest.mark.parametrize("steps", [1, 3, 5])
def test_evolution_gifs_match_jax(tmp_path, steps):
    """viz{ctr}_{0,1}.gif: one frame per step, PIL's luminance of the JAX
    copy's min-max normalised frames (the JAX file's palette frames within
    its quantisation of it), its delay and loop count, and the next free
    ctr on a second call."""
    rng = np.random.RandomState(steps)
    worst = [0.0, 0.0]
    tr0 = rng.randn(steps, 1, 29, 41, 3).astype(np.float32)
    tr1 = rng.randn(steps, 1, 29, 41, 3).astype(np.float32)
    for _ in range(2):
        jrunner._write_evolution_gifs(str(tmp_path / "jax"), tr0, tr1)
        trunner._write_evolution_gifs(str(tmp_path / "torch"), tr0, tr1)
    for ctr in (0, 1):
        for suffix, tr in (("0", tr0), ("1", tr1)):
            name = f"viz{ctr}_{suffix}.gif"
            jframes, jdur, jloop = _frames(tmp_path / "jax" / name)
            tframes, tdur, tloop = _frames(tmp_path / "torch" / name)
            assert (tdur, tloop) == (jdur, jloop) and len(tframes) == steps
            assert len(jframes) == steps
            for step, (frame, jframe) in enumerate(zip(tframes, jframes)):
                n = tr[step, 0]
                lo, hi = n.min(), n.max()
                u8 = np.uint8((n - lo) / (hi - lo + 1e-12) * 255.0)
                want = np.asarray(Image.fromarray(u8).convert("L"))
                for c in range(3):
                    np.testing.assert_array_equal(frame[..., c], want)
                jl = np.asarray(Image.fromarray(jframe).convert("L"))
                err = np.abs(jl.astype(int) - want)
                worst = [max(worst[0], err.mean()),
                         max(worst[1], np.percentile(err, 99))]
                assert worst[0] <= GIF_L_MEAN and worst[1] <= GIF_L_P99
            own = decode_gif((tmp_path / "torch" / name).read_bytes())
            assert own["loop"] == jloop
            assert own["durations"] == [jdur] * steps
            for a, b in zip(own["frames"], tframes):
                np.testing.assert_array_equal(a, b)
    print(f"JAX GIF frames against PIL's luminance: mean error up to "
          f"{worst[0]:.2f}, 99th percentile up to {worst[1]:.1f} levels")


def test_luminance_is_pils_convert_l():
    """``luminance`` is PIL's ``convert("L")`` on every one of the 2^24
    RGB colours."""
    cube = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([cube >> 16, (cube >> 8) & 255, cube & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(
        luminance(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


def test_encode_gif_grey_frames_match_pil(tmp_path):
    """Grey frames are written losslessly: PIL reads back the frames PIL
    itself would have written, a repeated frame merged into the one
    before it, with the same delays and loop count; the port's reader
    reads PIL's file too."""
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, (64, 96)).astype(np.uint8)
              for _ in range(3)]
    frames.insert(1, frames[0].copy())
    ours = encode_gif(frames, 666, loop=0)
    bio = io.BytesIO()
    pil = [Image.fromarray(f) for f in frames]
    pil[0].save(bio, "GIF", save_all=True, append_images=pil[1:],
                duration=666, loop=0)
    (tmp_path / "ours.gif").write_bytes(ours)
    (tmp_path / "pil.gif").write_bytes(bio.getvalue())
    a, b = _frames(tmp_path / "ours.gif"), _frames(tmp_path / "pil.gif")
    assert a[1:] == b[1:] and len(a[0]) == len(b[0]) == 3
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    theirs = decode_gif(bio.getvalue())
    mine = decode_gif(ours)
    assert theirs["durations"] == mine["durations"] == [1330, 660, 660]
    for x, y in zip(theirs["frames"], mine["frames"]):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="uint8"):
        encode_gif([np.zeros((4, 4, 3), np.uint8)], 10)


def _ttoy(img1, img2):
    d = ((img1 - img2)[..., :2] * 5.0).permute(0, 3, 1, 2)
    k = torch.ones((2, 1, 3, 3), dtype=img1.dtype) / 9.0
    return F.conv2d(d, k, padding=1, groups=2).permute(0, 2, 3, 1)


def test_test_patch_viz_jpeg_is_pils(tmp_path, monkeypatch):
    """test_patch's viz###.jpg: each panel written as PIL's save writes it
    at its default quality (75): the same entropy-coded bytes and
    samples."""
    panels = []
    real = tcli.encode_jpeg

    def spy(img, quality):
        panels.append((np.array(img), quality))
        return real(img, quality)

    monkeypatch.setattr(tcli, "encode_jpeg", spy)
    monkeypatch.setattr(tmodels, "fetch_model", lambda *a, **k: None)
    monkeypatch.setattr(tmodels, "predict_flow", lambda m, a, b: _ttoy(a, b))
    tcli.main(["--device", "cpu", "--self_correlated_patch", "circle",
               "--patch_size", "40", "--synthetic", "2", "--synthetic-size",
               "128", "192", "--output", str(tmp_path)])
    files = sorted((tmp_path / "test_patch" / "images_test").glob("viz*.jpg"))
    assert len(files) == len(panels) == 2
    for f, (panel, quality) in zip(files, panels):
        assert quality == 75
        data = f.read_bytes()
        assert data == encode_jpeg(panel, 75)
        bio = io.BytesIO()
        Image.fromarray(panel).save(bio, "JPEG")
        pil = bio.getvalue()
        sos = [d.index(b"\xff\xda") for d in (data, pil)]
        assert data[sos[0]:] == pil[sos[1]:]
        np.testing.assert_array_equal(np.asarray(Image.open(f)),
                                      np.asarray(Image.open(io.BytesIO(pil))))
        np.testing.assert_array_equal(read_samples(str(f)),
                                      np.asarray(Image.open(f)))
