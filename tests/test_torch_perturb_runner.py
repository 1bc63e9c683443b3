"""The PyTorch port's attack runner, logs and CLI against the JAX package's,
on the CPU: ``validate`` on the same arrays, the arbitrary targets, ``run``
on a toy flow model through every branch the port has, and the CLI on RAFT
with ``--device cpu`` writing where the JAX CLI's output taxonomy says."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from understanding_flow_robustness_tpu.attacks import log_utils as jlog
from understanding_flow_robustness_tpu.attacks import perturb_runner as jrunner
from understanding_flow_robustness_tpu.cli import run_perturb_model as jcli
from understanding_flow_robustness_tpu_torch.attacks import (
    PerturbConfig,
    RunConfig,
    build_arbitrary_gt,
    log_utils,
    run_perturbation_eval,
)
from understanding_flow_robustness_tpu_torch.cli import run_perturb_model as tcli


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def toy_predict(img1, img2):
    """tests/test_attacks.py:27-39's toy flow model in torch."""
    d = ((img1 - img2)[..., :2] * 5.0).permute(0, 3, 1, 2)
    k = torch.ones((2, 1, 3, 3), dtype=img1.dtype) / 9.0
    return F.conv2d(d, k, padding=1, groups=2).permute(0, 2, 3, 1)


def _samples(n=3, h=16, w=24, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.rand(1, h, w, 3).astype(np.float32)
        b = rng.rand(1, h, w, 3).astype(np.float32)
        gt = np.concatenate([rng.randn(1, h, w, 2).astype(np.float32),
                             np.ones((1, h, w, 1), np.float32)], -1)
        out.append((a, b, gt, gt))
    return out


def test_validate_matches_jax_key_by_key(tmp_path):
    rng = np.random.RandomState(1)
    n = 3
    noises0 = [rng.randn(8, 12, 3).astype(np.float32) * 0.02 for _ in range(n)]
    noises1 = [rng.randn(8, 12, 3).astype(np.float32) * 0.02 for _ in range(n)]
    origins = [rng.randn(8, 12, 2).astype(np.float32) for _ in range(n)]
    outputs = [rng.randn(4, 6, 2).astype(np.float32) for _ in range(n)]
    gts = []
    for _ in range(n):
        gt = rng.randn(8, 12, 3).astype(np.float32)
        gt[..., 2] = rng.rand(8, 12) > 0.2
        gts.append(gt)
    gts[0][0, :4, 0] = np.nan  # compute_l1's non-NaN mean
    got = log_utils.validate(noises0, noises1, origins, outputs, gts,
                             output_path=str(tmp_path / "t"), seed=3)
    ref = jlog.validate(noises0, noises1, origins, outputs, gts,
                        output_path=str(tmp_path / "j"), seed=3)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    lines_t = (tmp_path / "t" / "results3.txt").read_text().splitlines()
    lines_j = (tmp_path / "j" / "results3.txt").read_text().splitlines()
    assert [x.split(":")[0] for x in lines_t] == [x.split(":")[0] for x in lines_j]
    # disparity mode's numpy metrics, D1 in percent
    disp = [np.abs(rng.randn(8, 12)).astype(np.float32) * 10 for _ in range(n)]
    got = log_utils.validate(noises0, noises1, disp, disp[::-1], disp,
                             is_disparity=True)
    ref = jlog.validate(noises0, noises1, disp, disp[::-1], disp,
                        is_disparity=True)
    assert got == ref


@pytest.mark.parametrize("kind", ["fun", "uniform_8"])
def test_build_arbitrary_gt_matches_jax(kind):
    helper = np.zeros((256, 640, 3), np.float32)
    got = build_arbitrary_gt(kind, helper)
    ref = jrunner.build_arbitrary_gt(kind, helper)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        build_arbitrary_gt("circle", helper)


def test_run_on_the_toy_model(tmp_path):
    out = str(tmp_path / "run")
    cfg = RunConfig(perturb=PerturbConfig(perturb_method="ifgsm",
                                          flow_loss="l2", output_norm=0.05,
                                          n_step=3, learning_rate=0.01),
                    output_path=out, write_out_frequency=2, device="cpu",
                    show_evolve_path=os.path.join(out, "evolve"))
    res = run_perturbation_eval(toy_predict, _samples(), cfg)
    assert res["flow_epe"][0] > res["flow_epe_origin"][0]
    assert res["noise0_l0pix"][0] <= 0.05 + 1e-6
    assert res["time_per_frame"][0] > 0
    assert os.path.isfile(os.path.join(out, "results0.txt"))
    log = open(os.path.join(out, "log0.txt")).read().splitlines()
    assert len(log) == 4 and log[-1].startswith("time_per_frame")
    # samples 0 and 2 dumped; three GIF pairs of 3 frames
    assert sorted(os.listdir(os.path.join(out, "flow_output"))) == [
        "00000.png", "00002.png"]
    assert len(os.listdir(os.path.join(out, "evolve"))) == 6
    # a second run picks the next unused seed
    run_perturbation_eval(toy_predict, _samples(1), cfg)
    assert os.path.isfile(os.path.join(out, "results1.txt"))


def test_run_fixed_noise_branches(tmp_path):
    """The uniform-noise baseline, a universal perturbation from .npy, a
    fixed noise pair and the homogeneous experiment."""
    samples = _samples(2)
    base = dict(perturb=PerturbConfig(perturb_method="ifgsm",
                                      output_norm=0.05), device="cpu",
                n_height=16, n_width=24)
    res = run_perturbation_eval(toy_predict, samples, RunConfig(
        output_path=str(tmp_path / "u"), uniform_noise=True, **base))
    assert 0.04 < res["noise0_l0pix"][0] <= 0.05  # U[-eps, eps), clipped
    uni = np.full((1, 2, 16, 24, 3), 0.01, np.float32)
    np.save(tmp_path / "uni.npy", uni)
    res = run_perturbation_eval(toy_predict, samples, RunConfig(
        output_path=str(tmp_path / "v"),
        universal_perturbation_path=str(tmp_path / "uni.npy"), **base))
    np.testing.assert_allclose(res["noise0_l0pix"][0], 0.01, rtol=1e-4)
    fixed = np.stack([np.full((16, 24, 3), -0.02, np.float32),
                      np.full((16, 24, 3), 0.03, np.float32)])
    res = run_perturbation_eval(toy_predict, samples, RunConfig(
        output_path=str(tmp_path / "w"), arbitrary_noise=fixed, **base))
    np.testing.assert_allclose(res["noise1_l0pix"][0], 0.03, rtol=1e-4)
    res = run_perturbation_eval(toy_predict, samples, RunConfig(
        output_path=str(tmp_path / "h"), homogeneous=True, **base))
    assert res["flow_epe_origin"] == (0.0, 0.0)  # one sample, zero GT & flow


def test_run_refuses_corruptions_and_unknown_methods(tmp_path):
    """A corruption's severity is int(output_norm), 1-5: the attacks'
    default eps 0.02 is refused (the JAX runner would take its 0 as
    severity 5), as an unknown method is, before any output is made."""
    cfg = RunConfig(perturb=PerturbConfig(perturb_method="snow"),
                    output_path=str(tmp_path / "c"), device="cpu")
    with pytest.raises(ValueError, match="severity must be 1-5"):
        run_perturbation_eval(toy_predict, _samples(1), cfg)
    cfg = RunConfig(perturb=PerturbConfig(perturb_method="pgd"),
                    output_path=str(tmp_path / "p"), device="cpu")
    with pytest.raises(ValueError, match="Invalid perturbation method"):
        run_perturbation_eval(toy_predict, _samples(1), cfg)
    assert not os.path.exists(tmp_path / "c") and not os.path.exists(
        tmp_path / "p")


@pytest.mark.parametrize("argv", [
    [],
    ["--DEBUG", "--targeted", "--perturb_mode", "left", "--flow_loss", "cossim"],
    ["--homogeneous", "--arbitrary_gt_index", "fun", "--output_norm", "0.01"],
    ["--arbitrary_noise_index", "1", "--perturb_method", "mifgsm"],
    ["--universal_evaluation", "--uniform_noise"],
    ["--universal_evaluation", "--folder_name", "run7"],
    ["--perturb_method", "snow", "--homogeneous"],
])
def test_output_path_taxonomy_matches_jax(argv):
    argv = ["--flownet", "RAFT"] + argv
    assert tcli._output_path(tcli.build_parser().parse_args(argv)) == \
        jcli._output_path(jcli.build_parser().parse_args(argv))


def test_cli_runs_raft_on_the_cpu(tmp_path):
    argv = ["--device", "cpu", "--flownet", "RAFT", "--synthetic", "2",
            "--n_step", "2", "--n_height", "64", "--n_width", "64",
            "--perturb_method", "ifgsm", "--output_path", str(tmp_path)]
    res = tcli.main(argv)
    out = jcli._output_path(jcli.build_parser().parse_args(argv))
    assert out == os.path.join(str(tmp_path), "kitti2015", "RAFT", "both",
                               "ifgsm_l2", "0.02")
    keys = [line.split(":")[0] for line in open(
        os.path.join(out, "results0.txt")).read().splitlines()]
    assert keys == [k for k in res if k != "time_per_frame"]
    assert keys == ["noise0_l0pix", "noise0_l1pix", "noise1_l0pix",
                    "noise1_l1pix", "flow_epe_origin", "flow_epe",
                    "flow_cossim_unattacked", "flow_cossim_attacked",
                    "flow_l1_unattacked", "flow_l1_attacked"]
    assert 0 < res["noise0_l0pix"][0] <= 0.02 + 1e-6
    assert np.isfinite(res["flow_epe"][0])


def test_cli_runs_its_default_flownetc_on_the_cpu(tmp_path):
    """The default ``--flownet`` is FlowNetC (ported, ROADMAP A7)."""
    argv = ["--device", "cpu", "--synthetic", "1", "--n_step", "2",
            "--n_height", "64", "--n_width", "64", "--perturb_method",
            "ifgsm", "--output_path", str(tmp_path)]
    assert tcli.build_parser().parse_args([]).flownet == "FlowNetC"
    res = tcli.main(argv)
    out = os.path.join(str(tmp_path), "kitti2015", "FlowNetC", "both",
                       "ifgsm_l2", "0.02", "results0.txt")
    assert os.path.exists(out)
    assert 0 < res["noise0_l0pix"][0] <= 0.02 + 1e-6
    assert np.isfinite(res["flow_epe"][0])


@pytest.mark.parametrize("argv,err,match", [
    (["--synthetic", "1", "--flownet", "FlowNet3"], KeyError,
     "unknown model"),
    # the dataset branch reads the path lists of --data_list_dir (here
    # the default, absent): tests/test_torch_dataset_clis.py runs it
    (["--flownet", "RAFT"], FileNotFoundError, "kitti_scene_flow_train"),
    # the corruption sweep reads the same dataset branch
    (["--flownet", "RAFT", "--perturb_method", "fog"], FileNotFoundError,
     "kitti_scene_flow_train"),
    (["--flownet", "RAFT", "--disparity"], NotImplementedError, "disparity"),
    (["--flownet", "RAFT", "--flow_loss", "corr"], NotImplementedError,
     "corr"),
    (["--flownet", "RAFT", "--synthetic", "1", "--perturb_mode", "same"],
     ValueError, "invalid perturbation mode"),
])
def test_cli_refusals(tmp_path, argv, err, match):
    base = ["--device", "cpu", "--n_height", "64", "--n_width", "64",
            "--n_step", "1", "--output_path", str(tmp_path)]
    with pytest.raises(err, match=match):
        tcli.main(base + argv)
