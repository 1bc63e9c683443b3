"""The patch-analysis CLIs of the PyTorch port against the JAX package's,
on the CPU: ``test_moving_patch`` (the JAX smokes' four modes, ``--whole_img``
and the KITTI dataset branch, with the toy flow net of
tests/test_torch_dataset_clis.py in both packages), ``test_replace_features``
and ``test_patch_embeddings`` (FlowNetC on one shared checkpoint: JAX
variables written as a reference ``.pth`` that both packages load), file by
file at 128x192, the JAX smokes' size (tests/test_cli_smoke.py).  Without
matplotlib, as on the card's machine, both packages save the heat maps and
t-SNE points as ``.npy``; ``chip_smoke.py``'s checks of these files run
here on the port's.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dataset_clis import _jtoy, _ttoy, _two_scenes, roots  # noqa: F401

import chip_smoke
import understanding_flow_robustness_tpu.models as jmodels
import understanding_flow_robustness_tpu.utils as jutils
import understanding_flow_robustness_tpu_torch.models as tmodels
from understanding_flow_robustness_tpu.cli import test_moving_patch as jmoving
from understanding_flow_robustness_tpu.cli import (
    test_patch_embeddings as jembed,
)
from understanding_flow_robustness_tpu.cli import (
    test_replace_features as jreplace,
)
from understanding_flow_robustness_tpu.models import flownet_family as jfn
from understanding_flow_robustness_tpu_torch.cli import (
    test_moving_patch as tmoving,
)
from understanding_flow_robustness_tpu_torch.cli import (
    test_patch_embeddings as tembed,
)
from understanding_flow_robustness_tpu_torch.cli import (
    test_replace_features as treplace,
)
from understanding_flow_robustness_tpu_torch.models import (
    flownet_c_state_dict_from_jax,
)

# the toy net's values and the CSVs: tests/test_torch_patch.py's bounds
# (the flows ~1e-7 apart, the true-motion canvases 1e-5; the CSVs round
# to four decimals, so a value on a rounding edge moves by one unit)
TEST_PATCH_ATOL = 1e-5
CSV_ATOL = 1e-4 + 1e-6
# FlowNetC on one checkpoint: its flows and taps agree within 1e-5
# relative L2 (tests/test_torch_flownet.py MODEL_REL_L2), so do the EPE
# and cosine means; the CSVs round to four decimals
MODEL_RTOL = 1e-5
# mmd.csv rounds to six decimals; the MMDs of channel means that agree to
# ~1e-7 relative
MMD_ATOL = 1e-6 + 1e-6
SIZE = ["--synthetic-size", "128", "192"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """``import matplotlib`` raises, as on the card's machine."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.fixture
def toy(monkeypatch):
    """The toy net in both packages' CLIs."""
    monkeypatch.setattr(jmodels, "fetch_model", lambda *a, **k:
                        types.SimpleNamespace(predict=jax.jit(_jtoy)))
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(tmodels, "fetch_model", lambda *a, **k: None)
    monkeypatch.setattr(tmodels, "predict_flow", lambda m, a, b: _ttoy(a, b))


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


def _same_csv(got_path, ref_path, atol, rtol=0.0, text_cols=0):
    (gh, grows), (rh, rrows) = _csv(got_path), _csv(ref_path)
    assert gh == rh and len(grows) == len(rrows) > 0
    for g, r in zip(grows, rrows):
        assert g[:text_cols] == r[:text_cols]
        np.testing.assert_allclose(np.array(g[text_cols:], float),
                                   np.array(r[text_cols:], float),
                                   rtol=rtol, atol=atol)


def _run_both(jcli, tcli, argv, tmp_path):
    """Both CLIs on ``argv`` under ``--output tmp_path/{jax,torch}``: their
    returns and the global np.random stream's next draw after each."""
    ref = jcli.main(argv + ["--output", str(tmp_path / "jax")])
    ref_next = np.random.random()
    got = tcli.main(argv + ["--output", str(tmp_path / "torch"),
                            "--device", "cpu"])
    assert np.random.random() == ref_next  # the placements' draw order
    return ref, got


MOVING = ["--flownet", "FlowNetS", "--pretrained_path", "/nonexistent",
          "--random_patch", "gray", "--patch_size", "24", "--synthetic", "1",
          *SIZE, "--stride", "80", "--name", "smoke", "--no_viz"]


@pytest.mark.parametrize("extra", [
    ["--norotate"], [], ["--true_motion"],
    ["--ignore_mask_flow", "--norotate"]],
    ids=["norotate", "rotate", "true_motion", "ignore_mask_flow"])
def test_moving_patch_matches_jax(tmp_path, toy, no_matplotlib, extra):
    """The JAX smokes' four modes (tests/test_cli_smoke.py:49-71): a 24 px
    gray patch swept with stride 80 over 128x192, 2 x 3 locations, each
    rotated at random from the global stream unless --norotate, projected
    per location with --true_motion; the averages, both CSVs and the heat
    map.  ``chip_smoke.moving_patch_files`` reads the port's files."""
    ref, got = _run_both(jmoving, tmoving, MOVING + extra, tmp_path)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TEST_PATCH_ATOL)
    out = {pkg: tmp_path / pkg / "smoke" for pkg in ("jax", "torch")}
    for name in ("moving_results.csv", "moving_result_scenes.csv"):
        _same_csv(out["torch"] / name, out["jax"] / name, CSV_ATOL)
    heat = [np.load(out[pkg] / "vis" / "adv_epe_image_000.npy")
            for pkg in ("jax", "torch")]
    assert heat[1].shape == heat[0].shape == (2, 3)
    np.testing.assert_allclose(heat[1], heat[0], rtol=0, atol=TEST_PATCH_ATOL)
    files = chip_smoke.moving_patch_files(out["torch"], 1, (2, 3))
    np.testing.assert_allclose(files["averages"], got, rtol=0, atol=CSV_ATOL)
    # the patch moved the flow at some location
    assert heat[1].max() > heat[1].min()


def test_moving_patch_whole_img_matches_jax(tmp_path, toy, no_matplotlib):
    """--whole_img: the loaded patch and mask are full-frame canvases,
    evaluated once (tests/test_cli_smoke.py:74-96)."""
    patch = np.random.RandomState(0).rand(1, 128, 192, 3).astype(np.float32)
    np.save(tmp_path / "whole.npy", patch)
    argv = ["--patch_path", str(tmp_path / "whole.npy"), "--synthetic", "1",
            *SIZE, "--stride", "80", "--name", "smoke", "--whole_img", "1"]
    ref, got = _run_both(jmoving, tmoving, argv, tmp_path)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TEST_PATCH_ATOL)
    for name in ("moving_results.csv", "moving_result_scenes.csv"):
        _same_csv(tmp_path / "torch" / "smoke" / name,
                  tmp_path / "jax" / "smoke" / name, CSV_ATOL)
    chip_smoke.moving_patch_files(tmp_path / "torch" / "smoke", 1, (1, 1))


def test_moving_patch_heat_map_image(tmp_path, toy):
    """With matplotlib the heat map over the frame is a .jpg, as in the JAX
    CLI; the check of chip_smoke.py takes it."""
    pytest.importorskip("matplotlib")
    tmoving.main(MOVING + ["--norotate", "--output", str(tmp_path),
                           "--device", "cpu"])
    assert (tmp_path / "smoke" / "vis" / "adv_epe_image_000.jpg").exists()
    chip_smoke.moving_patch_files(tmp_path / "smoke", 1, (2, 3))


def test_moving_patch_kitti_branch_matches_jax(tmp_path, roots, toy,
                                               no_matplotlib, monkeypatch):
    """The KITTI 2015 dataset branch (tests/test_torch_dataset_clis.py):
    2 scenes, frames at 384x1280, GT at the files' size; a 41 px patch
    swept with stride 500: 3 locations a scene."""
    _two_scenes(monkeypatch)
    patch_path = str(tmp_path / "p.npy")
    np.save(patch_path, np.random.RandomState(0).rand(1, 41, 41, 3))
    argv = ["--patch_path", patch_path, "--valset", "kitti2015",
            "--kitti-dir", roots["kitti"], "--stride", "500", "--name", "k"]
    ref, got = _run_both(jmoving, tmoving, argv, tmp_path)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TEST_PATCH_ATOL)
    for name in ("moving_results.csv", "moving_result_scenes.csv"):
        _same_csv(tmp_path / "torch" / "k" / name,
                  tmp_path / "jax" / "k" / name, CSV_ATOL)
    chip_smoke.moving_patch_files(tmp_path / "torch" / "k", 2, (1, 3))


def test_moving_patch_true_motion_on_a_dataset_fails_as_in_jax(
        tmp_path, roots, toy, monkeypatch):
    """--true_motion on the KITTI set: the 3-D projection draws the patch
    canvases at the GT's size (the files' 61x83 here, 375x1242 on KITTI)
    while the frames are at 384x1280, so both CLIs fail on the same
    broadcast, as test_patch does (ROADMAP C)."""
    _two_scenes(monkeypatch)
    patch_path = str(tmp_path / "p.npy")
    np.save(patch_path, np.random.RandomState(0).rand(1, 41, 41, 3))
    argv = ["--patch_path", patch_path, "--valset", "kitti2015",
            "--kitti-dir", roots["kitti"], "--kitti_raw_dir", roots["raw"],
            "--true_motion", "--stride", "500"]
    for cli, extra in ((jmoving, []), (tmoving, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="broadcast"):
            cli.main(argv + extra + ["--output", str(tmp_path / "o")])


@pytest.fixture(scope="module")
def flownetc_pth(tmp_path_factory):
    """JAX FlowNetC variables with perturbed biases, written as a reference
    state dict (``.pth``) that both packages' fetch_model load."""
    v = jax.jit(jfn.FlowNetC(div_flow=20.0).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32)
        if x.ndim == 1 else x, v)
    path = tmp_path_factory.mktemp("ckpt") / "flownetc.pth"
    torch.save(flownet_c_state_dict_from_jax(v), path)
    return str(path)


def test_replace_features_matches_jax(tmp_path, flownetc_pth, monkeypatch):
    """Two synthetic pairs, ``-fk corr conv_redir --all_key_subsets``: the
    uniform and test patches under identical transforms, the capture, the
    injection, ``key_sets.json`` and ``results.csv`` row by row."""
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    argv = ["--flownet", "FlowNetC", "--pretrained_path", flownetc_pth,
            "--random_patch", "uniform", "--patch_size", "24",
            "--synthetic", "2", *SIZE, "--name", "smoke", "-fk", "corr",
            "conv_redir", "--all_key_subsets"]
    ref, got = _run_both(jreplace, treplace, argv, tmp_path)
    np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=1e-6)
    out = {pkg: tmp_path / pkg / "smoke" for pkg in ("jax", "torch")}
    key_sets = [["corr"], ["conv_redir"], ["corr", "conv_redir"]]
    for pkg in out:
        assert json.loads((out[pkg] / "key_sets.json").read_text()) == \
            key_sets
    _same_csv(out["torch"] / "results.csv", out["jax"] / "results.csv",
              atol=1e-4 + 1e-6, rtol=MODEL_RTOL, text_cols=1)
    rows = chip_smoke.replace_features_files(out["torch"], key_sets)
    # the uniform patch's features moved the test patch's flow
    assert any(abs(v[2] - v[1]) > 1e-4 for v in rows.values())


def test_replace_features_injection_is_flownetc_only(tmp_path, monkeypatch):
    """PWC-Net's taps are capture-only: both CLIs get through the capture
    and raise a TypeError at the injection."""
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    argv = ["--flownet", "PWCNet", "--pretrained_path", "/nonexistent",
            "--random_patch", "uniform", "--patch_size", "24",
            "--synthetic", "1", "--synthetic-size", "64", "64", "-fk",
            "corr6"]
    for cli, extra in ((jreplace, []), (treplace, ["--device", "cpu"])):
        with pytest.raises(TypeError, match="overrides"):
            cli.main(argv + extra + ["--output", str(tmp_path)])


def test_patch_embeddings_matches_jax(tmp_path, flownetc_pth, monkeypatch,
                                      no_matplotlib):
    """Three synthetic pairs on FlowNetC: the channel-mean embeddings with
    and without the patch, ``mmd.csv`` per key and the t-SNE points of
    each key (without matplotlib, ``tsne_{key}.npy``)."""
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    keys = ["conv3a", "corr", "conv_redir", "conv3_1"]
    argv = ["--flownet", "FlowNetC", "--pretrained_path", flownetc_pth,
            "--random_patch", "uniform", "--patch_size", "24",
            "--synthetic", "3", "--max_samples", "3", *SIZE,
            "--name", "smoke", "--feature_keys", *keys]
    _, got = _run_both(jembed, tembed, argv, tmp_path)
    out = {pkg: tmp_path / pkg / "smoke" for pkg in ("jax", "torch")}
    _same_csv(out["torch"] / "mmd.csv", out["jax"] / "mmd.csv",
              atol=MMD_ATOL, text_cols=1)
    mmd = chip_smoke.embedding_files(out["torch"], keys, 6)
    assert list(got) == keys
    for k in keys:
        assert abs(mmd[k] - got[k]) <= 1e-6
        # the t-SNE points only by their shape: 300 iterations with early
        # exaggeration carry the ~1e-7 relative difference of the two
        # packages' embeddings to points hundreds of units apart (the t-SNE
        # itself is equal to 1e-12 on equal inputs,
        # tests/test_torch_embedding.py)
        pts = [np.load(out[pkg] / f"tsne_{k}.npy") for pkg in out]
        assert pts[1].shape == pts[0].shape == (6, 2)


def test_patch_embeddings_on_pwcnet_taps(tmp_path, no_matplotlib):
    """PWC-Net's taps feed the embeddings (the JAX CLI reads any model's
    return_features dict the same way)."""
    keys = ["c13", "corr6", "conv2_4", "dc_conv6"]
    got = tembed.main([
        "--flownet", "PWCNet", "--random_patch", "uniform",
        "--patch_size", "24", "--synthetic", "2", "--max_samples", "2",
        "--synthetic-size", "64", "128", "--feature_keys", *keys,
        "--output", str(tmp_path), "--name", "pwc", "--device", "cpu"])
    assert list(got) == keys
    chip_smoke.embedding_files(tmp_path / "pwc", keys, 4)


def test_chip_smoke_checks_refuse_bad_files(tmp_path):
    """The checks chip_smoke.py runs on the CLIs' files fail a run whose
    files are missing a row or hold a NaN."""
    out = tmp_path / "m"
    (out / "vis").mkdir(parents=True)
    (out / "moving_results.csv").write_text(
        "epe,adv_epe,cos_sim,adv_cos_sim\n1.0,nan,0.5,0.4\n")
    (out / "moving_result_scenes.csv").write_text("scene,epe\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="non-finite"):
        chip_smoke.moving_patch_files(out, 1, (1, 1))
    (out / "mmd.csv").write_text("layer,mmd\ncorr,0.1\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="layers"):
        chip_smoke.embedding_files(out, ["corr", "conv3a"], 4)
    (out / "key_sets.json").write_text('[["corr"]]')
    with pytest.raises(chip_smoke.SmokeFailure, match="key_sets.json"):
        chip_smoke.replace_features_files(out, [("conv3a",)])
