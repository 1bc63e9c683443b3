"""The PyTorch port's patch placement, true-motion projection, meters and
patch/universal CLIs against the JAX package's, on the CPU.

Placement is host-side numpy in both packages, drawn from the global
``np.random`` stream: under the same seed every canvas, location and shape
is bit-equal, and after each call the next draw of the stream is the same
in both (the draw order is what seeded placement parity rests on).  The
true-motion projection runs its warps through each package's sampler on
the CLI's synthetic calibration.  The CLIs run with ``--device cpu`` on
FlowNetS / FlowNetC at 64x128 and write the JAX CLIs' file layout
(tests/test_cli_smoke.py); their refusals name the ROADMAP item that lifts
them.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import understanding_flow_robustness_tpu.models as jmodels
import understanding_flow_robustness_tpu.utils as jutils
import understanding_flow_robustness_tpu_torch.models as tmodels
from understanding_flow_robustness_tpu.attacks import patch as jpatch
from understanding_flow_robustness_tpu.attacks import patch3d as jpatch3d
from understanding_flow_robustness_tpu.cli import test_patch as jtest_patch
from understanding_flow_robustness_tpu.utils import meters as jmeters
from understanding_flow_robustness_tpu_torch.attacks import patch as tpatch
from understanding_flow_robustness_tpu_torch.attacks import patch3d as tpatch3d
from understanding_flow_robustness_tpu_torch.cli import patch_attack as tcli_patch
from understanding_flow_robustness_tpu_torch.cli import run_perturb_model as tcli_perturb
from understanding_flow_robustness_tpu_torch.cli import test_patch as tcli_test
from understanding_flow_robustness_tpu_torch.cli import (
    universal_perturbation as tcli_universal,
)
from understanding_flow_robustness_tpu_torch.flowviz import io as fio
from understanding_flow_robustness_tpu_torch.utils import meters as tmeters

# the projection's warps: the same f32 coordinates and weights in both
# samplers, the GT flow's bilinear resize as matrices (JAX) or
# F.interpolate (port): f32 sums in other orders
PATCH3D_ATOL = 1e-5
# test_patch's reported numbers: the toy net's flows (a 3x3 box filter,
# XLA vs torch, ~1e-7), the GT canvases (PATCH3D_ATOL where the projection
# writes them) and the epe / cos_sim means over them; the CSVs round to
# four decimals, so a value on a rounding edge may differ by one unit
TEST_PATCH_ATOL = 1e-5
CSV_ATOL = 1e-4 + 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(got, ref):
    """Bit-equal, recursively through the tuples and lists placement
    returns."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def _both(seed, call):
    """Run ``call(module)`` for the JAX package's patch module and the
    port's under the same seed; both results and the next draws."""
    out = []
    for mod in (jpatch, tpatch):
        np.random.seed(seed)
        res = call(mod)
        out.append((res, np.random.random()))
    return out


def _patch_parts(mod, seed=0, size=40, circle=True):
    np.random.seed(seed)
    if circle:
        patch, mask, shape = mod.init_patch_circle(size, 0.5)
    else:
        patch, shape = mod.init_patch_square(size, 0.5)
        mask = np.ones(shape, np.float32)
    return patch, mask, patch.copy(), shape


@pytest.mark.parametrize("h,w,center,radius", [
    (20, 20, None, None), (17, 31, None, None), (24, 24, [5, 9], 4),
    (3, 3, None, None)])
def test_circular_mask_equal(h, w, center, radius):
    _same(tpatch.create_circular_mask(h, w, center, radius),
          jpatch.create_circular_mask(h, w, center, radius))


@pytest.mark.parametrize("fn", ["init_patch_square", "init_patch_circle"])
def test_init_patch_equal(fn):
    (ref, ref_next), (got, got_next) = _both(
        3, lambda m: getattr(m, fn)(100, 0.32))
    _same(got, ref)
    assert got_next == ref_next


@pytest.mark.parametrize("kind", ["gaussian", "uniform", "black", "white",
                                  "red", "gray"])
def test_random_patch_equal(kind):
    (ref, ref_next), (got, got_next) = _both(
        4, lambda m: m.create_random_patch(kind, 24))
    _same(got, ref)
    assert got_next == ref_next
    with pytest.raises(ValueError):
        tpatch.create_random_patch("self", 24)


@pytest.mark.parametrize("kind", jpatch.get_self_correlated_patches() + [
    "vstripes_strip3", "vstripes_rot30", "vstripes_Bcol0.3_col0.7",
    "vstripes_Bcol0.25", "vstripes_col0.5"])
def test_correlated_patch_equal(kind):
    assert tpatch.get_self_correlated_patches() == \
        jpatch.get_self_correlated_patches()
    (ref, ref_next), (got, got_next) = _both(
        5, lambda m: m.create_correlated_patch(kind, 48))
    _same(got, ref)
    assert got_next == ref_next


@pytest.mark.parametrize("kw", [
    {"self_correlated": "checkered"}, {"random_type": "uniform"},
    {"random_type": "gray", "patch_type": "square"}])
def test_get_patch_and_mask_equal(kw):
    (ref, ref_next), (got, got_next) = _both(
        6, lambda m: m.get_patch_and_mask(patch_size=32, **kw))
    _same(got, ref)
    assert got_next == ref_next


def test_get_patch_and_mask_from_file_and_refusals(tmp_path):
    path = str(tmp_path / "p.npy")
    np.save(path, np.random.RandomState(0).rand(1, 20, 20, 3))
    _same(tpatch.get_patch_and_mask(patch_path=path),
          jpatch.get_patch_and_mask(patch_path=path))
    with pytest.raises(ValueError):
        tpatch.get_patch_and_mask(patch_size=8)
    # a mask and a patch from image files (tests/test_torch_train_data.py
    # holds them against the JAX package); a .npy is no image file
    mask_png = str(tmp_path / "m.png")
    fio.write_image(mask_png, (np.random.RandomState(1).rand(9, 11, 3)
                               * 255).astype(np.uint8))
    _same(tpatch.get_patch_and_mask(patch_path=path, mask_path=mask_png),
          jpatch.get_patch_and_mask(patch_path=path, mask_path=mask_png))
    with pytest.raises(ValueError, match="not a PNG"):
        tpatch.get_patch_and_mask(patch_path=path, mask_path=path)
    with pytest.raises(ValueError, match="not a PNG"):
        tpatch.init_patch_from_image(path, path, 64, 0.1)


@pytest.mark.parametrize("kw", [
    {"margin": 1}, {"center": True}, {"norotate": True},
    {"fixed_loc": (7, 9)}, {"moving": True}, {"margin": 3, "norotate": True}])
def test_circle_transform_equal(kw):
    data_shape = (1, 96, 128, 3)

    def call(m):
        patch, mask, init, shape = _patch_parts(m)
        return m.circle_transform(patch, mask, init, data_shape, shape, **kw)

    (ref, ref_next), (got, got_next) = _both(7, call)
    _same(got, ref)
    assert got_next == ref_next


@pytest.mark.parametrize("kw", [{}, {"norotate": True}, {"center": True},
                                {"fixed_loc": (11, 4)}])
def test_circle_transform_two_patches_equal(kw):
    data_shape = (1, 96, 128, 3)

    def call(m):
        patch, mask, init, shape = _patch_parts(m)
        other = np.full_like(patch, 0.5)
        return m.circle_transform_two_patches(
            [patch, other], mask, [init, other.copy()], data_shape, shape,
            margin=2, **kw)

    (ref, ref_next), (got, got_next) = _both(8, call)
    _same(got, ref)
    assert got_next == ref_next


@pytest.mark.parametrize("kw", [{}, {"norotate": True}, {"center": True},
                                {"fixed_loc": (30, 40)}])
def test_circle_transform_different_equal(kw):
    """Both frames' canvases and the synthesized GT flow canvas."""
    data_shape = (1, 128, 192, 3)

    def call(m):
        patch, mask, init, shape = _patch_parts(m)
        return m.circle_transform_different(patch, mask, init, data_shape,
                                            shape, margin=1, **kw)

    (ref, ref_next), (got, got_next) = _both(9, call)
    _same(got, ref)
    assert got_next == ref_next
    assert np.abs(ref[2]).max() > 0  # the GT flow canvas is not trivial


@pytest.mark.parametrize("norotate", [False, True])
def test_square_transform_equal_and_rotates_inputs_in_place(norotate):
    data_shape = (1, 64, 96, 3)
    outs = []
    for m in (jpatch, tpatch):
        patch, mask, init, shape = _patch_parts(m, circle=False)
        mask = np.random.RandomState(1).rand(*mask.shape)  # not symmetric
        before = [x.copy() for x in (patch, mask, init)]
        np.random.seed(10)
        res = m.square_transform(patch, mask, init, data_shape, shape,
                                 norotate=norotate)
        outs.append((res, [patch, mask, init], np.random.random()))
        moved = [not np.array_equal(a, b)
                 for a, b in zip(before, (patch, mask, init))]
        # the caller's arrays are rotated in place (utils_patch.py:781-846)
        assert any(moved) != norotate
    (ref, ref_args, ref_next), (got, got_args, got_next) = outs
    _same(got, ref)
    _same(got_args, ref_args)
    assert got_next == ref_next


def test_extract_and_rezoom_equal():
    rng = np.random.RandomState(11)
    canvas = rng.rand(1, 50, 60, 3)
    patch = tpatch.extract_patch(canvas, 7, 5, (1, 21, 23, 3))
    _same(patch, jpatch.extract_patch(canvas, 7, 5, (1, 21, 23, 3)))
    patch[...] = 0  # a copy, not a view of the canvas
    assert canvas[0, 5, 7].max() > 0
    args = (rng.rand(1, 21, 23, 3), (rng.rand(1, 21, 23, 3) > 0.5) * 1.0,
            rng.rand(1, 21, 23, 3), (1, 21, 23, 3), (1, 20, 20, 3))
    _same(tpatch.rezoom_to(*args), jpatch.rezoom_to(*args))


@pytest.mark.parametrize("h,w", [(64, 128), (96, 160)])
def test_project_patch_3d_scene_matches_jax(h, w):
    """On the test_patch CLI's synthetic calibration (the same helper in
    both packages): the four warped canvases and the induced GT flow."""
    calib, poses = tcli_test._synthetic_calib(h, w)
    jcalib, jposes = jtest_patch._synthetic_calib(h, w)
    _same(calib["P_imu_img"], jcalib["P_imu_img"])
    np.random.seed(12)
    patch, mask, shape = tpatch.init_patch_circle(h, 0.4)
    pc, mc, _, rx, ry, pshape = tpatch.circle_transform(
        patch, mask, patch.copy(), (1, h, w, 3), shape, margin=8)
    disp = np.full((h, w), 8.0, np.float32)
    fpf = np.zeros((1, h, w, 3), np.float32)
    fpf[..., 2] = 1
    args = (disp, pc.astype(np.float32), mc.astype(np.float32), rx, ry,
            pshape, w, h, fpf)
    got = tpatch3d.project_patch_3d_scene(calib, poses, *args, device="cpu")
    ref = jpatch3d.project_patch_3d_scene(jcalib, jposes, *args)
    assert not fpf[..., :2].any()  # the caller's flow is copied
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=0, atol=PATCH3D_ATOL)
    assert np.abs(ref[4][..., :2]).max() > 1  # the patch moves
    assert np.abs(ref[0]).max() > 0


def test_meters_equal(tmp_path):
    """AverageMeter's statistics and repr, and CsvLogger's bytes, equal to
    the JAX package's (header once, also after a zero-byte leftover)."""
    vals = [[1.5, 2.0], [0.25, 7.0], [3.0, -1.0]]
    meters = [m.AverageMeter(i=2, precision=4) for m in (jmeters, tmeters)]
    for v in vals:
        for m in meters:
            m.update(v, n=2)
    for k in ("val", "avg", "sum", "min", "max", "count"):
        assert getattr(meters[1], k) == getattr(meters[0], k)
    assert repr(meters[1]) == repr(meters[0])
    paths = []
    for name, m in (("j", jmeters), ("t", tmeters)):
        path = tmp_path / name / "r.csv"
        path.parent.mkdir()
        path.write_bytes(b"")
        for _ in range(2):
            log = m.CsvLogger(str(path), ["scene", "epe"])
            log.write([0, round(1.23456, 4)])
            log.close()
        paths.append(path)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    assert paths[0].read_bytes().count(b"scene") == 1
    term = tmeters.TermLogger(n_epochs=2, train_size=3, valid_size=0)
    term.reset_train_bar()
    term.train_bar.update(3)


# --- the CLIs on the CPU ----------------------------------------------------

def test_patch_attack_cli_layout_and_refusals(tmp_path, capsys):
    out = tmp_path / "patch"
    argv = ["--device", "cpu", "--flownet", "FlowNetC", "--synthetic", "2",
            "--synthetic-size", "64", "128", "--image-size", "64",
            "--patch-size", "0.3", "--epochs", "2", "--max-count", "2",
            "--patch-type", "square", "--output", str(out), "--name", "r"]
    patch, mask = tcli_patch.main(argv)
    assert patch.shape == (1, 19, 19, 3) and mask.shape == patch.shape
    for f in ("args.json", "patches/epoch_0.npy", "patches/epoch_1.npy"):
        assert (out / "r" / f).exists(), f
    np.testing.assert_array_equal(np.load(out / "r" / "patches" / "epoch_1.npy"),
                                  patch)
    assert "avg over 2 epochs" in capsys.readouterr().out
    # a patch from image files (ported; tests/test_torch_train_clis.py
    # holds it against the JAX CLI), and missing files raise
    png = str(tmp_path / "p.png")
    fio.write_image(png, (np.random.RandomState(2).rand(30, 30, 3) * 255)
                    .astype(np.uint8))
    patch, mask = tcli_patch.main(argv + ["--patch-path", png,
                                          "--mask-path", png])
    assert patch.shape == mask.shape == (1, 35, 35, 3)
    with pytest.raises(FileNotFoundError):
        tcli_patch.main(argv + ["--patch-path", str(tmp_path / "x.png"),
                                "--mask-path", png])
    i = argv.index("--synthetic")
    with pytest.raises(FileNotFoundError, match="train.txt"):
        tcli_patch.main(argv[:i] + argv[i + 2:]
                        + ["--data", str(tmp_path / "none")])


def test_test_patch_cli_modes_and_refusals(tmp_path):
    patch_path = str(tmp_path / "p.npy")
    np.save(patch_path, np.random.RandomState(0).rand(1, 21, 21, 3))
    out = tmp_path / "eval"
    base = ["--device", "cpu", "--flownet", "FlowNetS", "--patch_path",
            patch_path, "--synthetic", "2", "--synthetic-size", "64", "128",
            "--output", str(out)]
    for extra, suffix in (([], ""), (["--true_motion"], "_true_motion"),
                          (["--different_pos"], "_different_pos")):
        avg = tcli_test.main(base + extra)
        assert len(avg) == 4 and all(np.isfinite(avg))
        d = out / "test_patch"
        rows = (d / f"test_result_scenes{suffix}.csv").read_text().splitlines()
        assert rows[0] == "scene,epe,adv_epe,cos_sim,adv_cos_sim"
        assert len(rows) == 3
        assert (d / f"test_results{suffix}.csv").exists()
        assert (d / f"images_test{suffix}" / "viz001.jpg").exists()
    # the square mode, a random patch, and the reference's torch-saved
    # NCHW patches through _load_patch_file
    avg = tcli_test.main(base[:4] + ["--random_patch", "gray", "--patch_size",
                                     "16", "--patch_type", "square",
                                     "--no_viz", "--homogeneous"] + base[6:])
    assert all(np.isfinite(avg))
    nchw = str(tmp_path / "p.pt")
    torch.save(torch.rand(1, 3, 9, 9), nchw)
    assert tcli_test._load_patch_file(nchw).shape == (1, 9, 9, 3)
    with pytest.raises(SystemExit):
        tcli_test.main(base[:4] + ["--random_patch", "self"] + base[6:])
    # --mask_path and the dataset branch read files (absent here; they run
    # in tests/test_torch_dataset_clis.py)
    with pytest.raises(FileNotFoundError, match="m.png"):
        tcli_test.main(base + ["--mask_path", "m.png"])
    with pytest.raises(FileNotFoundError, match="scene_flow"):
        tcli_test.main(base[:6] + base[-2:])


def _jtoy(img1, img2):
    """tests/test_attacks.py:27-39: a smoothed image difference."""
    d = (img1 - img2)[..., :2] * 5.0
    k = jnp.ones((3, 3, 1, 1), img1.dtype) / 9.0
    return jnp.concatenate([
        jax.lax.conv_general_dilated(
            d[..., c:c + 1], k, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        for c in range(2)], axis=-1)


def _ttoy(img1, img2):
    d = ((img1 - img2)[..., :2] * 5.0).permute(0, 3, 1, 2)
    k = torch.ones((2, 1, 3, 3), dtype=img1.dtype) / 9.0
    return F.conv2d(d, k, padding=1, groups=2).permute(0, 2, 3, 1)


def _recorder(fn, calls):
    """``fn`` that appends its (gt, flow) arguments, as numpy, to
    ``calls``."""
    def wrapped(gt, flow):
        calls.append([np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                                 else x) for x in (gt, flow)])
        return fn(gt, flow)
    return wrapped


@pytest.mark.parametrize("extra", [
    [], ["--ignore_mask_flow"], ["--true_motion"],
    ["--true_motion", "--patch_type", "square"],
    ["--true_motion", "--ignore_mask_flow", "--norotate"],
    ["--different_pos"], ["--different_pos", "--ignore_mask_flow"],
    ["--patch_type", "square", "--homogeneous"],
    ["--fixed_loc_x", "40", "--fixed_loc_y", "12", "--norotate"],
], ids=lambda e: "".join(e).replace("--", "_") or "default")
def test_test_patch_cli_matches_jax(tmp_path, monkeypatch, extra):
    """The CLI's own arithmetic against the JAX CLI's, with the toy flow
    net in both on the same --synthetic frames: the gt_adv composite over
    the upsampled mask, --ignore_mask_flow, --different_pos's occlusion
    removal and GT zoom, --true_motion's projection with the margin taken
    from disparity.  Every GT and flow that reaches epe / cos_sim, the
    per-scene CSV values and the averages."""
    patch_path = str(tmp_path / "p.npy")
    np.save(patch_path, np.random.RandomState(0).rand(1, 21, 21, 3))
    argv = ["--patch_path", patch_path, "--synthetic", "2",
            "--synthetic-size", "64", "128", "--no_viz"] + extra
    jcalls, tcalls = [], []
    monkeypatch.setattr(jmodels, "fetch_model", lambda *a, **k:
                        types.SimpleNamespace(predict=jax.jit(_jtoy)))
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jtest_patch, "compute_epe",
                        _recorder(jtest_patch.compute_epe, jcalls))
    monkeypatch.setattr(tmodels, "fetch_model", lambda *a, **k: None)
    monkeypatch.setattr(tmodels, "predict_flow", lambda m, a, b: _ttoy(a, b))
    monkeypatch.setattr(tcli_test, "compute_epe",
                        _recorder(tcli_test.compute_epe, tcalls))
    ref = jtest_patch.main(argv + ["--output", str(tmp_path / "jax")])
    got = tcli_test.main(argv + ["--output", str(tmp_path / "torch"),
                                 "--device", "cpu"])

    # two scenes (one with --homogeneous), each a clean and an adversarial
    # epe: (gt_clean, flow), (gt_adv, adv_flow)
    assert len(tcalls) == len(jcalls) == (2 if "--homogeneous" in extra
                                          else 4)
    for (tg, tf), (jg, jf) in zip(tcalls, jcalls):
        assert tg.shape == jg.shape and tf.shape == jf.shape
        np.testing.assert_allclose(tg, jg, rtol=0, atol=TEST_PATCH_ATOL)
        np.testing.assert_allclose(tf, jf, rtol=0, atol=TEST_PATCH_ATOL)
    if "--different_pos" in extra or ("--true_motion" in extra
                                      and "--ignore_mask_flow" not in extra):
        # the patch's own motion reached the adversarial GT
        assert np.abs(jcalls[1][0][..., :2]).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=TEST_PATCH_ATOL)
    suffix = ("_different_pos" if "--different_pos" in extra
              else "_true_motion" if "--true_motion" in extra else "")
    for name in (f"test_result_scenes{suffix}.csv",
                 f"test_results{suffix}.csv"):
        rows = [(tmp_path / pkg / "test_patch" / name).read_text()
                .splitlines() for pkg in ("jax", "torch")]
        assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1])
        vals = [np.array([r.split(",") for r in rs[1:]], float)
                for rs in rows]
        np.testing.assert_allclose(vals[1], vals[0], rtol=0, atol=CSV_ATOL)


def test_universal_cli_layout_and_evaluation(tmp_path):
    """The JAX CLI's taxonomy (tests/test_cli_smoke.py:158-175), then the
    attack CLI's --universal_evaluation reading the snapshot."""
    tcli_universal.main([
        "--device", "cpu", "--flownet", "FlowNetS", "--n_height", "64",
        "--n_width", "128", "--epochs", "1", "--epoch_size", "1",
        "--n_step", "1", "--synthetic", "1", "--seed", "3", "--DEBUG",
        "--output_path", str(tmp_path)])
    out = (tmp_path / "DEBUG" / "kitti2015" / "FlowNetS" / "universal"
           / "both" / "ifgsm_cossim" / "0.02" / "0.002_1_3")
    assert (out / "perturbations" / "epoch_0.npy").exists()
    assert (out / "args.json").exists()
    n0, n1 = tcli_universal.main([
        "--device", "cpu", "--flownet", "FlowNetC", "--n_height", "64",
        "--n_width", "128", "--epochs", "2", "--n_step", "2",
        "--synthetic", "2", "--seed", "5", "--flow_loss", "l2",
        "--output_path", str(tmp_path)])
    run_dir = (tmp_path / "kitti2015" / "FlowNetC" / "universal" / "both"
               / "ifgsm_l2" / "0.02" / "0.002_2_5")
    snap = np.load(run_dir / "perturbations" / "epoch_1.npy")
    assert snap.shape == (1, 2, 64, 128, 3)
    np.testing.assert_array_equal(snap[:, 0], n0)
    assert 0 < np.abs(n0).max() <= 0.02 + 1e-6
    res = tcli_perturb.main([
        "--device", "cpu", "--flownet", "FlowNetC", "--universal_evaluation",
        "--folder_name", "0.002_2_5", "--epoch_number", "1",
        "--perturb_method", "ifgsm", "--flow_loss", "l2", "--n_height", "64",
        "--n_width", "128", "--synthetic", "2", "--output_path",
        str(tmp_path)])
    assert np.isfinite(res["flow_epe"][0])
    assert (run_dir / "results0.txt").exists()
    for bad in (["--disparity"], ["--flow_loss", "corr"]):
        with pytest.raises(NotImplementedError):
            tcli_universal.main(["--device", "cpu", "--synthetic", "1"] + bad)
    # the dataset branch is ported (tests/test_torch_train_clis.py): with no
    # SequenceFolder on disk it raises reading its scene list
    with pytest.raises(FileNotFoundError, match="train.txt"):
        tcli_universal.main([
            "--device", "cpu", "--flownet", "FlowNetS", "--n_height", "64",
            "--n_width", "128", "--epochs", "1", "--seed", "3",
            "--data", str(tmp_path / "none"), "--kitti_dir",
            str(tmp_path / "none"), "--output_path", str(tmp_path)])
