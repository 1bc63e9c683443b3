"""The dataset branches of the attack CLI and the patch-evaluation CLI
against the JAX CLIs', on the CPU.

Both CLIs read the KITTI layout of ``test_torch_data.py`` (2 scenes at two
frame sizes): ``run_perturb_model`` through ``KittiPairDataset.from_lists``
(cv2 ``INTER_LINEAR`` frames, the sparse-aware downscaled GT for the attack
and the full-resolution GT for the metrics), ``test_patch`` through
``get_evaluation_set`` at 384x1280 (PIL bilinear frames, KITTI-raw calib
and poses with ``--true_motion``).  The flow net is the toy net of
``tests/test_attacks.py`` in both packages, so the comparison holds the
data path and the CLIs' arithmetic at the bounds the synthetic branches
use (``tests/test_torch_perturb_runner.py``, ``tests/test_torch_patch.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_data import write_layouts

import understanding_flow_robustness_tpu.models as jmodels
import understanding_flow_robustness_tpu.utils as jutils
import understanding_flow_robustness_tpu_torch.models as tmodels
from understanding_flow_robustness_tpu import data as jdata
from understanding_flow_robustness_tpu.cli import run_perturb_model as jperturb
from understanding_flow_robustness_tpu.cli import test_patch as jtest_patch
from understanding_flow_robustness_tpu_torch import data as tdata
from understanding_flow_robustness_tpu_torch.cli import (
    run_perturb_model as tperturb,
)
from understanding_flow_robustness_tpu_torch.cli import test_patch as ttest_patch
from understanding_flow_robustness_tpu_torch.flowviz import io as fio

torch.set_num_threads(2)

# the metrics: tests/test_torch_perturb_runner.py's key-by-key bound; in
# results0.txt, which rounds to six decimals, one unit more
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-7
FILE_ATOL = 1e-6 + METRIC_ATOL
# test_patch's values and CSVs: tests/test_torch_patch.py's bounds
TEST_PATCH_ATOL = 1e-5
CSV_ATOL = 1e-4 + 1e-6


def _jtoy(img1, img2):
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


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return write_layouts(str(tmp_path_factory.mktemp("layouts")), n_kitti=2)


@pytest.fixture
def toy(monkeypatch):
    """The toy net in both packages' CLIs."""
    monkeypatch.setattr(jmodels, "fetch_model", lambda *a, **k:
                        types.SimpleNamespace(predict=jax.jit(_jtoy)))
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(tmodels, "fetch_model", lambda *a, **k: None)
    monkeypatch.setattr(tmodels, "predict_flow", lambda m, a, b: _ttoy(a, b))
    monkeypatch.setattr(tmodels, "predict_flow_differentiable",
                        lambda m, a, b: _ttoy(a, b))


def _results(path):
    out = {}
    for line in open(path).read().splitlines():
        k, v = line.split(":", 1)
        out[k] = np.array([float(x) for x in v.replace("+/-", " ").split()])
    return out


@pytest.mark.parametrize("dataset,extra", [
    ("kitti2015", ["--perturb_method", "ifgsm", "--n_step", "3"]),
    ("kitti2015", ["--perturb_method", "ifgm", "--flow_loss", "cossim",
                   "--perturb_mode", "left", "--n_step", "2"]),
])
def test_attack_cli_dataset_branch_matches_jax(tmp_path, roots, toy,
                                               monkeypatch, dataset, extra):
    argv = ["--dataset", dataset, "--data_list_dir", roots["lists"],
            "--n_height", "40", "--n_width", "56"] + extra
    runs = []  # the JAX CLI returns nothing: keep what its run returns
    monkeypatch.setattr(jperturb, "run", lambda *a, _run=jperturb.run, **k:
                        runs.append(_run(*a, **k)) or runs[-1])
    jperturb.main(argv + ["--output_path", str(tmp_path / "j")])
    ref = runs[0]
    res = tperturb.main(argv + ["--output_path", str(tmp_path / "t"),
                                "--device", "cpu"])
    for k in ref:
        if k != "time_per_frame":
            # (mean, spread): the spread over the pairs cancels, so its
            # bound is relative to the mean (tests/test_torch_corruptions.py)
            np.testing.assert_allclose(
                res[k], ref[k], rtol=METRIC_RTOL,
                atol=max(METRIC_ATOL, METRIC_RTOL * abs(ref[k][0])),
                err_msg=k)
    want, got = (_results(
        jperturb._output_path(jperturb.build_parser().parse_args(
            argv + ["--output_path", str(tmp_path / d)])) + "/results0.txt")
        for d in ("j", "t"))
    assert list(got) == list(want) and len(got) == 10
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0,
            atol=FILE_ATOL + METRIC_RTOL * abs(want[k][0]), err_msg=k)
    # the attack moved the flow away from the full-resolution GT
    assert res["flow_epe"][0] > res["flow_epe_origin"][0] > 0


def _two_scenes(monkeypatch):
    """The evaluation set cut to the layout's 2 of KITTI's 200 scenes."""
    for pkg in (jdata, tdata):
        def two_scenes(valset, args, fn=pkg.get_evaluation_set):
            ds = fn(valset, args)
            ds.N = 2
            return ds
        monkeypatch.setattr(pkg, "get_evaluation_set", two_scenes)


@pytest.mark.parametrize("extra", [[], ["--different_pos", "--norotate"]],
                         ids=["default", "different_pos"])
def test_test_patch_dataset_branch_matches_jax(tmp_path, roots, toy,
                                               monkeypatch, extra):
    """2 KITTI 2015 scenes, frames at 384x1280, GT at the files' size, a
    mask from a PNG file (``--mask_path``)."""
    _two_scenes(monkeypatch)
    patch_path = str(tmp_path / "p.npy")
    np.save(patch_path, np.random.RandomState(0).rand(1, 41, 41, 3))
    mask_path = str(tmp_path / "mask.png")
    fio.write_image(mask_path, np.random.RandomState(1).randint(
        0, 256, (30, 30)).astype(np.uint8))
    argv = ["--patch_path", patch_path, "--valset", "kitti2015",
            "--kitti-dir", roots["kitti"], "--kitti_raw_dir", roots["raw"],
            "--mask_path", mask_path, "--no_viz"] + extra
    ref = jtest_patch.main(argv + ["--output", str(tmp_path / "jax")])
    got = ttest_patch.main(argv + ["--output", str(tmp_path / "torch"),
                                   "--device", "cpu"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=TEST_PATCH_ATOL)
    suffix = "_different_pos" if "--different_pos" in extra else ""
    for name in (f"test_result_scenes{suffix}.csv",
                 f"test_results{suffix}.csv"):
        rows = [(tmp_path / pkg / "test_patch" / name).read_text()
                .splitlines() for pkg in ("jax", "torch")]
        assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1])
        vals = [np.array([r.split(",") for r in rs[1:]], float)
                for rs in rows]
        np.testing.assert_allclose(vals[1], vals[0], rtol=0, atol=CSV_ATOL)
    assert len(rows[1]) == 2  # the averages' header and row
    assert np.isfinite(got).all() and got[0] > 0


def test_test_patch_true_motion_on_a_dataset_fails_as_in_jax(
        tmp_path, roots, toy, monkeypatch):
    """--true_motion on the KITTI set: scene 0 has its KITTI-raw calib and
    poses, and the 3-D projection draws the patch canvases at the GT's
    size (the files' 61x83 here, 375x1242 on KITTI) while the frames are at
    384x1280, so both CLIs fail on the same broadcast (ROADMAP C)."""
    _two_scenes(monkeypatch)
    patch_path = str(tmp_path / "p.npy")
    np.save(patch_path, np.random.RandomState(0).rand(1, 41, 41, 3))
    argv = ["--patch_path", patch_path, "--valset", "kitti2015",
            "--kitti-dir", roots["kitti"], "--kitti_raw_dir", roots["raw"],
            "--true_motion", "--no_viz"]
    for cli, extra in ((jtest_patch, []), (ttest_patch, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="broadcast"):
            cli.main(argv + extra + ["--output", str(tmp_path / "o")])
