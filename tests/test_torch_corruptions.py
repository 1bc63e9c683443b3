"""The port's image corruptions (``attacks/corruptions.py``, its own copy)
against the JAX package's, on the CPU: every corruption at every severity
bit for bit from the same seed (the JAX copy draws from numpy's global
state, the port from the ``np.random.RandomState`` it is given), a sweep
of all of them in one seeded sequence, ``frost`` on its procedural texture
and on a texture directory the test writes, ``corrupt_pair``, the runner's
corruption branch against the JAX runner on FlowNetS, the attack CLI's
severity sweep, and the cv2 / PIL corruptions with cv2 and PIL blocked.

The JAX copy calls cv2 and PIL; the port calls its host library
(``native/cv.py``), so every comparison here is between two
implementations, cv2 at its defaults.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu.attacks import corruptions as J
from understanding_flow_robustness_tpu.attacks import perturb_runner as jrunner
from understanding_flow_robustness_tpu.attacks.global_attacks import (
    PerturbConfig as JPerturbConfig,
)
from understanding_flow_robustness_tpu.cli import run_perturb_model as jcli
from understanding_flow_robustness_tpu.models import flownet2 as jfn2
from understanding_flow_robustness_tpu_torch.attacks import (
    PerturbConfig,
    RunConfig,
    run_perturbation_eval,
)
from understanding_flow_robustness_tpu_torch.attacks import corruptions as T
from understanding_flow_robustness_tpu_torch.cli import run_perturb_model as tcli
from understanding_flow_robustness_tpu_torch.models import (
    FlowModel,
    FlowNetS2,
    flownet_s_state_dict_from_jax,
    predict_flow_differentiable,
)

# the corruptions that need cv2 (or PIL, pixelate) and those that need
# only numpy and scipy
CV2 = ("defocus_blur", "frost", "brightness", "saturate",
       "elastic_transform", "jpeg_compression", "spatter")
NUMPY = tuple(n for n in J.get_corruption_names("all")
              if n not in CV2 + ("pixelate",))
# the runner's metrics: the same corrupted pair (bit-equal) through
# FlowNetS in both packages, f32 summation orders apart
METRIC_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _img(h=48, w=80, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _both(name, seed, img=None, **kwargs):
    """Severities 1-5 of ``name`` in one sequence: the JAX copy after
    np.random.seed(seed), the port on RandomState(seed)."""
    img = _img() if img is None else img
    np.random.seed(seed)
    ref = [J.corrupt(img, name, s, **kwargs) for s in range(1, 6)]
    rng = np.random.RandomState(seed)
    got = [T.corrupt(img, name, s, rng=rng, **kwargs) for s in range(1, 6)]
    return got, ref


def test_names_match_jax():
    for subset in ("common", "all"):
        assert T.get_corruption_names(subset) == J.get_corruption_names(subset)
    assert set(NUMPY) == {"gaussian_noise", "shot_noise", "impulse_noise",
                          "speckle_noise", "gaussian_blur", "glass_blur",
                          "motion_blur", "zoom_blur", "snow", "fog",
                          "contrast"}


@pytest.mark.parametrize("name", NUMPY)
def test_numpy_scipy_corruption_bit_equal(name):
    got, ref = _both(name, seed=len(name))
    for s, (g, r) in enumerate(zip(got, ref), start=1):
        assert g.dtype == np.uint8 and g.shape == r.shape
        np.testing.assert_array_equal(g, r, err_msg=f"{name} severity {s}")


@pytest.mark.parametrize("name", CV2 + ("pixelate",))
def test_cv2_corruption_bit_equal(name):
    """The same cv2 (and PIL, for pixelate) calls on both sides."""
    got, ref = _both(name, seed=len(name) + 1)
    for s, (g, r) in enumerate(zip(got, ref), start=1):
        np.testing.assert_array_equal(g, r, err_msg=f"{name} severity {s}")


def test_sweep_in_one_seeded_sequence():
    """Every corruption at every severity drawn from ONE state in one
    order: an extra or a missing draw anywhere shifts everything after."""
    img = _img(40, 56, seed=3)
    names = J.get_corruption_names("all")
    np.random.seed(21)
    ref = [J.corrupt(img, n, s) for n in names for s in range(1, 6)]
    rng = np.random.RandomState(21)
    got = [T.corrupt(img, n, s, rng=rng) for n in names for s in range(1, 6)]
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r, err_msg=names[i // 5])
    # the default, numpy's global state, draws as the JAX copy does
    np.random.seed(21)
    again = [T.corrupt(img, n, s) for n in names[:3] for s in range(1, 6)]
    for g, r in zip(again, ref):
        np.testing.assert_array_equal(g, r)


def test_frost_procedural_and_texture_dir(tmp_path):
    """frost without a texture directory (the procedural plasma texture),
    with a directory of frost photos that this test writes (read raw,
    BGR, resized in uint8), and with a fixed index (perturb_mode 'same';
    index 0 is redrawn, the fork's falsy-index quirk)."""
    import cv2

    rng = np.random.RandomState(5)
    for i, name in enumerate(["frost1.png", "frost2.png", "frost3.png",
                              "frost4.jpg", "frost5.jpg", "frost6.jpg"]):
        tex = rng.randint(0, 256, (90 + 7 * i, 120 + 5 * i, 3), np.uint8)
        cv2.imwrite(str(tmp_path / name), tex)
    img = _img(64, 96, seed=7)
    for kwargs in ({}, {"frost_dir": str(tmp_path)}, {"idx": 3},
                   {"idx": 0, "frost_dir": str(tmp_path)}):
        got, ref = _both("frost", seed=11, img=img, **kwargs)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r, err_msg=str(kwargs))
    # the photos are what frost blends in: another directory, another image
    other = tmp_path / "other"
    other.mkdir()
    for f in os.listdir(tmp_path):
        if f.startswith("frost"):
            cv2.imwrite(str(other / f), 255 - cv2.imread(str(tmp_path / f)))
    a = T.corrupt(img, "frost", 3, rng=np.random.RandomState(2), idx=2,
                  frost_dir=str(tmp_path))
    b = T.corrupt(img, "frost", 3, rng=np.random.RandomState(2), idx=2,
                  frost_dir=str(other))
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("name,mode", [("frost", "same"), ("frost", "both"),
                                       ("gaussian_noise", "both"),
                                       ("snow", "same")])
def test_corrupt_pair_matches_jax(name, mode):
    """``corrupt_pair`` on a batch-2 [0, 1] pair: both frames corrupted in
    every mode; 'same' shares one frost texture index across the frames."""
    rng = np.random.RandomState(4)
    a = rng.rand(2, 40, 64, 3).astype(np.float32)
    b = rng.rand(2, 40, 64, 3).astype(np.float32)
    np.random.seed(8)
    ref = J.corrupt_pair(a, b, name, 2, mode=mode)
    got = T.corrupt_pair(a, b, name, 2, mode=mode,
                         rng=np.random.RandomState(8))
    for g, r, x in zip(got, ref, (a, b)):
        assert g.dtype == np.float32 and g.shape == x.shape
        np.testing.assert_array_equal(g, r)
        assert not np.array_equal(g, x)


@pytest.mark.parametrize("name", CV2 + ("pixelate",))
def test_corruption_without_cv2_or_pil_matches_jax(monkeypatch, name):
    """With cv2 and PIL unimportable, each corruption the JAX copy takes
    from them runs at severities 1-5 and equals the JAX copy's output from
    cv2 / PIL bit for bit."""
    img = _img(48, 80, seed=len(name) + 2)
    np.random.seed(len(name) + 3)
    ref = [J.corrupt(img, name, s) for s in range(1, 6)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    T._FROST_CACHE.clear()
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    rng = np.random.RandomState(len(name) + 3)
    got = [T.corrupt(img, name, s, rng=rng) for s in range(1, 6)]
    for s, (g, r) in enumerate(zip(got, ref), start=1):
        assert g.dtype == np.uint8 and g.shape == r.shape
        np.testing.assert_array_equal(g, r, err_msg=f"{name} severity {s}")


def _natural_image(h=384, w=1280, seed=0):
    """A photo-like u8 frame: 1/f noise with a colour tint, hard-edged
    objects, sensor noise and a sky that clips at 255."""
    rng = np.random.RandomState(seed)
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.rfftfreq(w)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))
    base = np.fft.irfft2(amp * np.exp(2j * np.pi * rng.rand(h, w // 2 + 1)),
                         s=(h, w))
    base = (base - base.mean()) / base.std()
    img = (110 + 45 * base[..., None] * rng.uniform(0.7, 1.3, 3)
           + rng.normal(0, 4, (h, w, 3)))
    for _ in range(12):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        hh, ww = rng.randint(10, h // 3), rng.randint(10, w // 5)
        patch = img[y0:y0 + hh, x0:x0 + ww]
        patch[:] = rng.uniform(0, 255, 3) + rng.normal(0, 6, patch.shape)
    yy = np.arange(h // 5)[:, None, None]
    img[: h // 5] += 120 * (1 - yy / (h / 5))
    return np.clip(img, 0, 255).astype(np.uint8)


def _flat_saturated_image(h=384, w=1280, seed=1):
    """Flat regions of exactly 0, 255 and 128, a saturated magenta block
    and a field of 0/255 speckle: where a sum that lands on an integer
    decides the uint8 truncation."""
    img = np.full((h, w, 3), 128, np.uint8)
    img[:, : w // 4] = 0
    img[:, w // 4 : w // 2] = 255
    img[h // 2 :, w // 2 : 3 * w // 4] = (255, 0, 255)
    img[: h // 2, 3 * w // 4 :] = np.random.RandomState(seed).choice(
        [0, 255], (h // 2, w - 3 * w // 4, 3))
    return img


@pytest.mark.parametrize("image", ["natural", "flat_saturated"])
@pytest.mark.parametrize("name", CV2 + ("pixelate", "frost_dir"))
def test_corruption_full_size_matches_jax(tmp_path, name, image):
    """The 8 ported corruptions at 384x1280, the sweep's and chip_smoke's
    size, severities 1-5, bit for bit with the JAX copy on cv2 / PIL: on a
    photo-like frame and on one of flat and saturated regions.
    ``frost_dir``: frost blending photo textures (written here, 512x768,
    so the uint8 INTER_CUBIC upscales them 1.83x)."""
    img = (_natural_image() if image == "natural"
           else _flat_saturated_image())
    kwargs = {}
    if name == "frost_dir":
        import cv2

        name, kwargs = "frost", {"frost_dir": str(tmp_path)}
        for i, f in enumerate(["frost1.png", "frost2.png", "frost3.png",
                               "frost4.jpg", "frost5.jpg", "frost6.jpg"]):
            cv2.imwrite(str(tmp_path / f),
                        _natural_image(512, 768, seed=10 + i)[..., ::-1])
    got, ref = _both(name, seed=len(name) + 4, img=img, **kwargs)
    for s, (g, r) in enumerate(zip(got, ref), start=1):
        assert g.dtype == np.uint8 and g.shape == r.shape == img.shape
        np.testing.assert_array_equal(g, r, err_msg=f"{name} severity {s}")


@pytest.mark.parametrize("severity", [0, 6, 2.5])
def test_severity_outside_one_to_five_is_refused(severity):
    """The port refuses a severity outside 1-5 (the JAX copy indexes its
    tables with severity - 1, so a 0 silently runs severity 5)."""
    with pytest.raises(ValueError, match="1-5"):
        T.corrupt(_img(), "contrast", severity)


@pytest.fixture(scope="module")
def flownet_s():
    """The registry's FlowNetS in both packages on the same weights."""
    jm = jfn2.FlowNetS2()
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    m = FlowNetS2()
    m.load_state_dict(flownet_s_state_dict_from_jax(v), strict=True)
    return jax.jit(lambda a, b: jm.apply(v, a, b)), FlowModel(
        "FlowNetS", m.eval(), torch.device("cpu"), is_raft=False,
        size_multiple=64)


@pytest.mark.parametrize("method,severity,mode", [
    ("gaussian_noise", 3, "both"), ("zoom_blur", 2, "both"),
    ("frost", 4, "same")])
def test_runner_corruption_branch_matches_jax(tmp_path, flownet_s, method,
                                              severity, mode):
    """``run`` with a corruption on two synthetic pairs through FlowNetS:
    the corrupted pairs are bit-equal to the JAX runner's (numpy's global
    state seeded there, the same seed in ``corruption_rng`` here), so the
    metrics agree to FlowNetS's f32 parity; results0.txt has the same
    keys."""
    jpredict, model = flownet_s
    rng = np.random.RandomState(6)
    samples = []
    for _ in range(2):
        a = rng.rand(1, 64, 64, 3).astype(np.float32)
        b = rng.rand(1, 64, 64, 3).astype(np.float32)
        gt = np.concatenate([rng.randn(1, 64, 64, 2).astype(np.float32),
                             np.ones((1, 64, 64, 1), np.float32)], -1)
        samples.append((a, b, gt, gt))
    np.random.seed(30)
    ref = jrunner.run(jpredict, samples, jrunner.RunConfig(
        flownet="FlowNetS", n_height=64, n_width=64,
        perturb=JPerturbConfig(perturb_method=method, perturb_mode=mode,
                               output_norm=severity),
        output_path=str(tmp_path / "j")))
    got = run_perturbation_eval(
        lambda x, y: predict_flow_differentiable(model, x, y), samples,
        RunConfig(flownet="FlowNetS", n_height=64, n_width=64,
                  perturb=PerturbConfig(perturb_method=method,
                                        perturb_mode=mode,
                                        output_norm=severity),
                  output_path=str(tmp_path / "t"), device="cpu",
                  corruption_rng=np.random.RandomState(30)))
    assert [k for k in got if k != "time_per_frame"] == \
        [k for k in ref if k != "time_per_frame"]
    for k in ref:
        if k != "time_per_frame":
            # (mean, spread): the spread over the pairs cancels, so its
            # bound is relative to the mean
            np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL,
                                       atol=METRIC_RTOL * abs(ref[k][0]),
                                       err_msg=k)
    assert got["noise0_l0pix"][0] > 0
    keys = [line.split(":")[0] for line in
            (tmp_path / "t" / "results0.txt").read_text().splitlines()]
    assert keys == [line.split(":")[0] for line in
                    (tmp_path / "j" / "results0.txt").read_text().splitlines()]


def test_cli_severity_sweep(tmp_path):
    """``--perturb_method gaussian_noise``: severities 1-5, each in its
    folder under the JAX CLI's taxonomy, each with results0.txt and
    log0.txt; the noise grows with the severity."""
    argv = ["--device", "cpu", "--flownet", "FlowNetS", "--synthetic", "1",
            "--n_height", "64", "--n_width", "64", "--perturb_method",
            "gaussian_noise", "--output_path", str(tmp_path)]
    base = jcli._output_path(jcli.build_parser().parse_args(argv))
    assert base == tcli._output_path(tcli.build_parser().parse_args(argv))
    assert base == os.path.join(str(tmp_path), "kitti2015", "FlowNetS",
                                "both", "gaussian_noise")
    seen = []
    run = tcli.run

    def spy(predict, samples, cfg):
        res = run(predict, samples, cfg)
        seen.append((cfg.perturb.output_norm, cfg.output_path, res))
        return res

    tcli.run = spy
    try:
        last = tcli.main(argv)
    finally:
        tcli.run = run
    assert [s for s, _, _ in seen] == [1, 2, 3, 4, 5]
    for severity, path, res in seen:
        assert path == os.path.join(base, str(int(severity)))
        assert os.path.isfile(os.path.join(path, "results0.txt"))
        assert os.path.isfile(os.path.join(path, "log0.txt"))
        assert np.isfinite(res["flow_epe"][0])
    assert last is seen[-1][2]
    l1 = [res["noise0_l1pix"][0] for _, _, res in seen]
    assert l1 == sorted(l1) and l1[0] < l1[-1]
