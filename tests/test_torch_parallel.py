"""The port's data parallelism (``parallel``) against the JAX package's
2-device virtual CPU mesh and against itself on one device, on the CPU:
the losses' global counts, the sharded KITTI validation
(``cli.evaluate --n_devices``), ``make_sharded_attack``, the runner's mesh
mode, the adversarial trainer and the time limit at world 2, and
``launch``'s failure and refusal paths.

One launch of two gloo ranks runs all the world-2 work
(``torch_parallel_workers.parallel_suite``); the one-device references run
in this process, the JAX package on two of conftest's eight CPU devices.
The train step's modes: tests/test_torch_grad_transport.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_workers as workers
from test_torch_data import write_layouts

from understanding_flow_robustness_tpu import parallel as jparallel
from understanding_flow_robustness_tpu import training as jtraining
from understanding_flow_robustness_tpu.attacks.global_attacks import (
    PerturbConfig as JPerturbConfig,
)
from understanding_flow_robustness_tpu.attacks.global_attacks import (
    make_sharded_attack as j_make_sharded_attack,
)
from understanding_flow_robustness_tpu.cli import evaluate as jcli
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu_torch import parallel
from understanding_flow_robustness_tpu_torch.attacks import PerturbConfig
from understanding_flow_robustness_tpu_torch.attacks import perturb_runner
from understanding_flow_robustness_tpu_torch.cli import evaluate as tcli
from understanding_flow_robustness_tpu_torch.cli import infer as tinfer
from understanding_flow_robustness_tpu_torch.cli import train as cli_train
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    raft_state_dict_from_jax,
)
from understanding_flow_robustness_tpu_torch.models.layers import (
    GlobalBatchNorm2d,
    global_batch_norm,
)

# the bars of tests/test_torch_training.py::test_losses_match_jax and
# tests/test_torch_evaluate.py::test_validate_kitti (port vs JAX); the
# port against itself, world 2 vs world 1: the same per-sample work
LOSS_TOL = 1e-5
EPE_REL = 1e-4
WORLD_REL = 1e-6
ATTACK_ATOL = 1e-5   # the JAX package's own (tests/test_parallel_eval.py)
LAUNCH_TIMEOUT = 600  # s: a hung rank fails the test instead of the run


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _loss_cases():
    """test_losses_match_jax's ten cases at batch 4, the counts uneven
    across the two shards: rank 0's half has most of the NaN predictions,
    the |gt| >= MAX_FLOW pixel and half its pixels invalid."""
    rng = np.random.RandomState(0)
    H, W = 23, 31
    cases = {}
    for loss_name in ("sequence", "multiscale"):
        for branch in ("raft", "flownetc", "pwc", "weighing", "div_flow"):
            gt = (rng.randn(4, H, W, 2) * 5).astype(np.float32)
            gt[0, 0, 0] = [300.0, 300.0]
            valid = np.ones((4, H, W), np.float32)
            valid[:2] = rng.rand(2, H, W) > 0.5
            valid[2:] = rng.rand(2, H, W) > 0.05
            sizes = ([(H, W)] * 3 if branch == "raft"
                     else [(12, 16), (6, 8), (3, 4), (2, 2)])
            preds = [(rng.randn(4, h, w, 2) * 3).astype(np.float32)
                     for h, w in sizes]
            if branch != "raft":  # the per-scale losses skip NaNs
                preds[-1][0, 0, 0, 0] = np.nan
                preds[0][1, :3, :5, 1] = np.nan
                preds[0][3, 0, 0, 0] = np.nan
            kw = {"flownetc": branch in ("flownetc", "weighing", "div_flow"),
                  "pwc": branch == "pwc",
                  "flownetc_weighing": branch == "weighing",
                  "div_flow": 20.0 if branch == "div_flow" else 1.0,
                  "gamma": 0.8}
            cases[f"{loss_name}-{branch}"] = (loss_name, preds, gt, valid, kw)
    return cases


def _images(rng, b=8, h=16, w=32):
    return [rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32),
            np.concatenate([rng.randn(b, h, w, 2), np.ones((b, h, w, 1))],
                           -1).astype(np.float32)]


ATTACK_CFGS = {
    "ifgsm": PerturbConfig(perturb_method="ifgsm", n_step=3,
                           output_norm=0.02),
    "gaussian": PerturbConfig(perturb_method="gaussian", output_norm=0.02),
    "uniform": PerturbConfig(perturb_method="uniform", output_norm=0.02),
}


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """The world-2 launch and what it is held against: a KITTI tree of 3
    samples at two frame sizes, seeded perturbed JAX RAFT weights in a
    .pth, and the inputs of every case."""
    tmp = tmp_path_factory.mktemp("parallel")
    roots = write_layouts(str(tmp))
    rng = np.random.RandomState(0)
    jm = JRAFT(iters=2, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * rng.uniform(0.8, 1.2, np.shape(x)).astype(
            np.float32) + 0.01 * rng.randn(*np.shape(x)).astype(np.float32),
        jax.device_get(v))
    pth = str(tmp / "raft.pth")
    torch.save(raft_state_dict_from_jax(v), pth)
    evaluate_argv = ["--model", pth, "--iters", "2", "--dataset", "kitti",
                     "--data_roots", '{"kitti": "%s"}' % roots["kitti"]]
    job = {"losses": _loss_cases(),
           "images": _images(np.random.RandomState(3)),
           "attack_cfgs": ATTACK_CFGS,
           "runner_path": str(tmp / "mesh_run"),
           "adv_dir": str(tmp / "adv2"),
           "clock_dir": str(tmp / "clock"),
           "evaluate_argv": evaluate_argv + ["--n_devices", "2", "--device",
                                             "cpu"]}
    out = parallel.launch(workers.parallel_suite, 2, job, device="cpu",
                          timeout=LAUNCH_TIMEOUT)
    return tmp, job, evaluate_argv, out


def test_losses_global_counts_match_jax(suite):
    """Each rank's loss and metric shares on its slice, summed over the two
    ranks, are the JAX package's values on the whole batch (its pjit
    step's): the NaN and valid counts differ between the shards, so a mean
    of the ranks' own means would not be."""
    _, job, _, out = suite
    for name, (loss_name, preds, gt, valid, kw) in job["losses"].items():
        j_fn = (jtraining.sequence_loss if loss_name == "sequence"
                else jtraining.multiscale_epe)
        j_loss, j_met = j_fn([jnp.asarray(p) for p in preds],
                             jnp.asarray(gt), jnp.asarray(valid), **kw)
        t_loss, t_met = out["losses"][name]
        assert np.isfinite(t_loss), name
        np.testing.assert_allclose(t_loss, float(j_loss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=name)
        assert t_met.keys() == j_met.keys(), name
        for k in j_met:
            np.testing.assert_allclose(t_met[k], float(j_met[k]),
                                       rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=f"{name} {k}")


def _floats(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]


def test_validate_kitti_sharded(suite, capsys):
    """``cli.evaluate --n_devices 2`` (each rank one sample a step, the
    ragged tail repeated, one common padded geometry) against the JAX
    CLI's ``--n_devices 2`` (``_validate_kitti_sharded`` on its mesh): EPE
    within EPE_REL, F1 within one outlier pixel per frame; and against the
    port's own sharded path at world 1 to 1e-6."""
    tmp, _, argv, out = suite
    capsys.readouterr()
    jcli.main(argv + ["--n_devices", "2"])
    text = capsys.readouterr().out
    assert "Validation KITTI (2-device mesh)" in text
    jepe, jf1 = _floats(text.split("mesh)")[1])
    tepe, tf1 = out["validate"]["kitti-epe"], out["validate"]["kitti-f1"]
    assert abs(tepe - jepe) <= EPE_REL * jepe
    from understanding_flow_robustness_tpu_torch.data import KITTI

    ds = KITTI(root=os.path.join(str(tmp), "kitti"))
    assert len(ds) == 3 and len({ds[i][0].shape for i in range(3)}) == 2
    n_valid = sum(int((ds[i][3] >= 0.5).sum()) for i in range(len(ds)))
    assert abs(tf1 - jf1) / 100 * n_valid <= len(ds)
    assert 0 < tf1 < 100
    one = tcli.main(argv + ["--n_devices", "1", "--device", "cpu"])
    assert "Validation KITTI (1-device mesh)" in capsys.readouterr().out
    np.testing.assert_allclose(tepe, one["kitti-epe"], rtol=WORLD_REL)
    np.testing.assert_allclose(tf1, one["kitti-f1"], rtol=WORLD_REL)


def test_sharded_attack(suite):
    """``make_sharded_attack`` at world 2, gathered: the gaussian and
    uniform noises (drawn for the global batch, then sliced) equal the
    unsharded attack's from the same generator seed; I-FGSM's equal it to
    1e-6 and the JAX package's sharded attack on its 2-device mesh to its
    own bar."""
    _, job, _, out = suite
    single = workers.attacks(None, job["images"], ATTACK_CFGS, 0)
    for name in ATTACK_CFGS:
        for got, want in zip(out["attacks"][name], single[name]):
            if name == "ifgsm":
                np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
            else:
                assert np.array_equal(got, want), name
    n0, n1, adv0, adv1 = out["attacks"]["gaussian"]
    assert 0 < np.abs(n0).max() and np.array_equal(
        adv0, np.clip(job["images"][0] + n0, 0, 1))
    variables = {"w": jnp.asarray(workers.TOY_W)}

    def toy(vs, a, b):
        return jnp.einsum("bhwc,cd->bhwd", jnp.concatenate([a, b], -1),
                          vs["w"])

    mesh = jparallel.make_mesh(2)
    cfg = JPerturbConfig(perturb_method="ifgsm", n_step=3, output_norm=0.02)
    with mesh:
        ref = j_make_sharded_attack(toy, cfg, mesh)(
            variables, *(jnp.asarray(x) for x in job["images"]),
            jax.random.PRNGKey(0))
    for got, want in zip(out["attacks"]["ifgsm"], ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATTACK_ATOL)
    assert np.abs(out["attacks"]["ifgsm"][0]).max() <= 0.02 + 1e-6


def test_runner_mesh_mode(suite, tmp_path):
    """The runner's mesh mode (the JAX package's test_perturb_runner_mesh_
    mode): 2 batches of 8 at world 2, every entry logged individually by
    rank 0 (16 lines), and the metrics of the unsharded run."""
    _, job, _, out = suite
    logf = os.path.join(job["runner_path"], "log0.txt")
    assert sum(1 for line in open(logf) if "epe" in line) == 16
    single = workers.run_runner(None, str(tmp_path / "single"))
    assert out["runner"].keys() == single.keys()
    for k, want in single.items():
        if k == "time_per_frame":
            continue
        np.testing.assert_allclose(out["runner"][k][0], want[0], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert np.isfinite(out["runner"]["flow_epe"][0])


def test_runner_mesh_refuses_show_evolve(tmp_path):
    """No sharded trajectory: show_evolve_path with a mesh raises before
    anything is written (the JAX package's refusal)."""
    cfg = perturb_runner.RunConfig(
        perturb=PerturbConfig(perturb_method="ifgsm", n_step=2),
        output_path=str(tmp_path / "evo_run"),
        show_evolve_path=str(tmp_path / "evo_gifs"), device="cpu")
    with pytest.raises(ValueError, match="show_evolve_path"):
        perturb_runner.run(workers.toy_predict, iter(()), cfg,
                           mesh=parallel.make_mesh(1, device="cpu"))
    assert not os.path.exists(tmp_path / "evo_run")


def test_adversarial_trainer_world2(suite, tmp_path):
    """The adversarial trainer at world 2: the clean and attacked halves
    are concatenated before sharding, so rank 0 trains on the clean pair
    (bit for bit the batch) and rank 1 on the attacked one (the one-device
    run's, within the eps-ball of the clean one); the metrics of each of
    the 3 updates (f32: 2.1e-7 apart measured) and the weights after them
    those of the one-device run on the doubled batch, the weights within
    2 lr a step (AdamW's first steps move a weight by ~lr whatever its
    gradient: see test_torch_grad_transport)."""
    _, _, _, out = suite
    got = out["adversarial"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = workers.adversarial_train(None, str(tmp_path / "adv1"))
    finally:
        torch.set_num_threads(n)
    assert got["steps"] == want["steps"] == 1
    (rank0, rank1), (whole,) = got["seen"], want["seen"]
    assert len(rank0) == len(rank1) == len(whole) == 3
    clean = next(workers.adversarial_batches())["image1"]
    for r0, r1, w in zip(rank0, rank1, whole):
        assert np.array_equal(r0, clean) and np.array_equal(w[:1], clean)
        np.testing.assert_allclose(r1, w[1:], atol=1e-6)
        assert 0 < np.abs(r1 - clean).max() <= 0.02 + 1e-6
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k, x in w.items():
            np.testing.assert_allclose(g[k], x, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{i} {k}")
    for k, x in want["state"].items():
        if x.dtype.kind == "f":
            assert np.abs(got["state"][k] - x).max() <= 2 * 3 * 1e-4, k


def test_time_limit_world2(suite):
    """Rank 0's clock decides for every rank: with rank 0 past its time
    limit and rank 1 not, both stop after the first batch (a rank that
    went on would wait in the next step's collectives)."""
    assert suite[3]["clock"] == [1, 1]


def test_launch_surfaces_a_rank_failure():
    """A rank that raises makes launch raise with that rank's traceback,
    the other rank stopped though it waits in a collective."""
    with pytest.raises(parallel.RankFailed) as e:
        parallel.launch(workers.fail_on_rank1, 2, device="cpu",
                        timeout=LAUNCH_TIMEOUT)
    msg = str(e.value)
    assert "rank 1 of 2" in msg and "Traceback" in msg
    assert "rank 1 fails on purpose" in msg


def test_refusals(tmp_path, monkeypatch):
    """More CUDA ranks than cards raise, naming both counts, in launch and
    in the three CLIs (here there is no card; nothing falls back to the
    CPU); NCCL refuses two ranks on one card unless gloo is asked for;
    CPU ranks take gloo only; a batch that does not divide raises; more
    than one device needs launch."""
    with pytest.raises(ValueError, match="2 CUDA ranks .* 0 CUDA device"):
        parallel.launch(workers.fail_on_rank1, 2)
    for argv in (["--n_devices", "2", "--synthetic", "1",
                  "--checkpoint_dir", str(tmp_path)],):
        with pytest.raises(ValueError, match="2 CUDA ranks"):
            cli_train.main(argv)
    with pytest.raises(ValueError, match="2 CUDA ranks"):
        tcli.main(["--model", "x.pth", "--dataset", "kitti",
                   "--n_devices", "2"])
    (tmp_path / "a_10.png").write_bytes(b"")
    (tmp_path / "a_11.png").write_bytes(b"")
    with pytest.raises(ValueError, match="2 CUDA ranks"):
        tinfer.main(["--dir", str(tmp_path), "--devices", "2",
                     "--batch_size", "2", "--output_dir",
                     str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="divide"):
        tinfer.main(["--dir", str(tmp_path), "--devices", "2",
                     "--batch_size", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="gloo"):
        parallel.launch(workers.fail_on_rank1, 2, device="cpu",
                        backend="nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        parallel.launch(workers.fail_on_rank1, 2, devices=[0, 0])
    mesh = parallel.Mesh(rank=1, world=2)
    assert torch.equal(parallel.shard_batch(mesh, torch.arange(6)),
                       torch.arange(3, 6))
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_batch(mesh, {"x": torch.arange(5)})
    with pytest.raises(ValueError, match="launch"):
        parallel.make_mesh(2)


def test_global_batch_norm_keeps_names_and_tensors():
    """global_batch_norm turns every BatchNorm2d into a GlobalBatchNorm2d
    in place: the same objects, parameters and buffers (an optimizer built
    before keeps them) and state-dict keys, so a checkpoint of a rank loads
    into a one-device model; on a one-device mesh nothing changes."""
    model = RAFT(iters=2)
    params = list(model.parameters())
    keys = list(model.state_dict())
    assert global_batch_norm(model, parallel.make_mesh(1, "cpu")) is model
    assert not any(isinstance(m, GlobalBatchNorm2d) for m in model.modules())
    global_batch_norm(model, parallel.Mesh(world=2))
    n_bn = sum(isinstance(m, GlobalBatchNorm2d) for m in model.modules())
    assert n_bn > 0 and not any(
        type(m) is torch.nn.BatchNorm2d for m in model.modules())
    assert list(model.parameters()) == params
    assert list(model.state_dict()) == keys
    RAFT(iters=2).load_state_dict(model.state_dict())
