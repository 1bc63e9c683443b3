"""The dataset branches of the train, patch-training and universal CLIs
against the JAX CLIs', on the CPU.

* ``cli.train``: the batches each stage feeds the trainer -- ``--stage
  kitti2015`` (KITTI pairs, unaugmented) the JAX CLI's own, ``chairs`` and
  ``kitti`` (augmented, through ``--data_roots``, ``--trans_rot`` and
  ``--online_subset``) the JAX package's samples drawn from the seeds the
  port's loader gives them -- bit for bit; then two RAFT steps from files
  on KITTI pairs with the same weights in both CLIs, whose losses must
  agree at ``tests/test_torch_training.py``'s bound.
* ``cli.patch_attack`` and ``cli.universal_perturbation``: SequenceFolder
  training on the committed JPEG fixtures and the KITTI valset, on the toy
  flow net of ``tests/test_torch_patch_attack.py``: the batches bit for
  bit, the patch / perturbations and the metrics at that file's bounds.
"""

import json
import os
import random
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_data import _same, write_layouts
from test_torch_patch_attack import ATOL, LOSS_RTOL, TOYS
from test_torch_raft import _perturb
from test_torch_training import LOSS_TOL

import understanding_flow_robustness_tpu.models as jmodels
import understanding_flow_robustness_tpu.utils as jutils
import understanding_flow_robustness_tpu_torch.models as tmodels
from understanding_flow_robustness_tpu import data as jdata
from understanding_flow_robustness_tpu.cli import patch_attack as jcli_patch
from understanding_flow_robustness_tpu.cli import train as jcli_train
from understanding_flow_robustness_tpu.cli import (
    universal_perturbation as jcli_universal,
)
from understanding_flow_robustness_tpu.data import datasets as jds
from understanding_flow_robustness_tpu.data import loader as jloader
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu.models.registry import (
    FlowModel as JFlowModel,
)
from understanding_flow_robustness_tpu_torch import data as tdata
from understanding_flow_robustness_tpu_torch.cli import patch_attack as tcli_patch
from understanding_flow_robustness_tpu_torch.cli import train as tcli_train
from understanding_flow_robustness_tpu_torch.cli import (
    universal_perturbation as tcli_universal,
)
from understanding_flow_robustness_tpu_torch.data import fixtures_dir
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    FlowModel,
    raft_state_dict_from_jax,
)

torch.set_num_threads(2)
FIXTURE = fixtures_dir("kitti_raw_jpeg")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return write_layouts(str(tmp_path_factory.mktemp("layouts")))


def _recording(train_fn, store, n=None):
    """A stand-in for a CLI's ``train`` that records the first n batches
    its ``batches()`` yields, over as many epochs as that takes, and
    trains on nothing."""
    def fake(cfg, model, batches, *a, **k):
        while len(store) < n:
            for b in batches():
                store.append(b)
                if len(store) == n:
                    break
        return (None, None, 0) if train_fn == "jax" else 0
    return fake


def _train_argv(roots, stage, tmp_path):
    argv = ["--stage", stage, "--batch_size", "2", "--num_steps", "3",
            "--seed", "11", "--checkpoint_dir", str(tmp_path)]
    if stage == "kitti2015":
        return argv + ["--image_size", "40", "56", "--data_list_dir",
                       roots["lists"]]
    data_roots = {"chairs": os.path.join(roots["chairs"], "data"),
                  "kitti": roots["kitti"]}
    return argv + ["--image_size", "24", "32", "--data_roots",
                   json.dumps(data_roots), "--trans_rot",
                   "--online_subset", "1", "0", "1"]


@pytest.mark.parametrize("stage", ["kitti2015", "chairs", "kitti"])
def test_train_cli_feeds_the_jax_batches(roots, tmp_path, monkeypatch, stage):
    os.makedirs(tmp_path / "datasets")
    shutil.copy(os.path.join(roots["chairs"], "chairs_split.txt"),
                tmp_path / "datasets" / "chairs_split.txt")
    monkeypatch.chdir(tmp_path)  # chairs' split file is read from here
    argv = _train_argv(roots, stage, tmp_path)
    if stage == "kitti":
        argv.remove("--trans_rot")  # sparse: no trans_rot
    monkeypatch.setattr(tcli_train, "fetch_model", lambda *a, **k:
                        types.SimpleNamespace(module=torch.nn.Linear(1, 1),
                                              is_raft=True))
    got = []
    monkeypatch.setattr(tcli_train, "train", _recording("torch", got, 3))
    tcli_train.main(argv + ["--device", "cpu"])
    assert len(got) == 3 and got[0]["image1"].shape[0] == 2

    if stage == "kitti2015":
        monkeypatch.setattr(jmodels, "fetch_model", lambda *a, **k:
                            types.SimpleNamespace(variables={"params": {}},
                                                  is_raft=True))
        monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
        want = []
        monkeypatch.setattr(jcli_train, "train", _recording("jax", want, 3))
        jcli_train.main(argv + ["--DEBUG"])
    else:
        # the JAX CLI's loader draws from shared global generators on four
        # threads; its samples are drawn here from the port loader's seeds
        args = tcli_train.build_parser().parse_args(argv)
        ds = jds.fetch_dataset(stage, tuple(args.image_size),
                               trans_rot=args.trans_rot,
                               roots=json.loads(args.data_roots))
        ds = jds.Subset(ds, args.online_subset)
        order = np.random.RandomState(args.seed)
        seeds = np.random.RandomState([args.seed, 1])
        collate = jloader.DataLoader(ds, batch_size=2)._collate
        want = []
        while len(want) < 3:
            idx = np.arange(len(ds))
            order.shuffle(idx)
            s = seeds.randint(0, 2 ** 32, size=len(idx), dtype=np.uint64)
            for k in range(len(idx) // 2):
                samples = []
                for i, x in zip(idx[2 * k: 2 * k + 2], s[2 * k: 2 * k + 2]):
                    random.seed(int(x))
                    np.random.seed(int(x))
                    samples.append(ds[int(i)])
                want.append(collate(samples))
        want = want[:3]
    for g, w in zip(got, want, strict=True):
        # the JAX batch's "pad" is (0, 0, 0, 0) without padding, read by
        # neither trainer; the port's loader does not carry it
        assert w.pop("pad") == (0, 0, 0, 0)
        _same(g, w)


def test_train_cli_kitti_pairs_losses_match_jax(roots, tmp_path, monkeypatch):
    """Two RAFT batches from KITTI path lists (batch 1, 64x64, 2
    iterations) with one set of weights in both CLIs."""
    rng = np.random.RandomState(0)
    jm = JRAFT(iters=2, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    v = {"params": _perturb(v["params"], rng),
         "batch_stats": _perturb(v["batch_stats"], rng)}
    module = RAFT(iters=2, mixed_precision=False)
    module.load_state_dict(raft_state_dict_from_jax(v), strict=True)
    argv = ["--stage", "kitti2015", "--data_list_dir", roots["lists"],
            "--batch_size", "1", "--num_steps", "1", "--image_size", "64",
            "64", "--iters", "2", "--lr", "1e-4", "--seed", "4"]

    jlosses = []
    monkeypatch.setattr(jmodels, "fetch_model", lambda *a, **k:
                        JFlowModel("RAFT", jm, v, True, 8))
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    real = jcli_train.train

    def jtrain(*a, **k):
        k["logger"] = lambda step, m: jlosses.append(float(m["loss"]))
        return real(*a, **k)
    monkeypatch.setattr(jcli_train, "train", jtrain)
    jcli_train.main(argv + ["--checkpoint_dir", str(tmp_path / "j"),
                            "--DEBUG"])

    monkeypatch.setattr(tcli_train, "fetch_model", lambda *a, **k:
                        FlowModel("RAFT", module.eval(), torch.device("cpu")))
    out = tcli_train.main(argv + ["--checkpoint_dir", str(tmp_path / "t"),
                                  "--device", "cpu", "--name", "files"])
    tlosses = [m["loss"] for m in out["history"]]
    assert out["total_steps"] == 2 and len(tlosses) == len(jlosses) == 2
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL)
    assert os.path.exists(tmp_path / "t" / "files" / "files.pth")


def _record_calls(monkeypatch, module, name, store, materialize, real):
    """Wraps ``module.name`` (``real``) to record its batch argument's
    items and its result."""

    def wrapped(*a, **k):
        a = list(a)
        a[materialize] = items = list(a[materialize])
        store.setdefault(name, []).extend(items)
        out = real(*a, **k)
        store.setdefault(name + "_out", []).append(out)
        return out
    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture
def toy(monkeypatch):
    """The halved toy net in both packages' CLIs, and their evaluation
    sets cut to the layout's 3 of KITTI's 200 scenes."""
    for pkg in (jdata, tdata):
        def three_scenes(valset, args, fn=pkg.get_evaluation_set):
            ds = fn(valset, args)
            ds.N = 3
            return ds
        monkeypatch.setattr(pkg, "get_evaluation_set", three_scenes)
    jpred, tpred = TOYS["halved"]
    monkeypatch.setattr(jmodels, "fetch_model", lambda *a, **k:
                        types.SimpleNamespace(
                            predict=jax.jit(jpred), variables={},
                            predict_fn=lambda var, a, b: jpred(a, b)))
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(tmodels, "fetch_model", lambda *a, **k: None)
    monkeypatch.setattr(tmodels, "predict_flow", lambda m, a, b: tpred(a, b))
    monkeypatch.setattr(tmodels, "predict_flow_differentiable",
                        lambda m, a, b: tpred(a, b))


def test_patch_cli_dataset_branch_matches_jax(roots, tmp_path, monkeypatch,
                                              toy):
    png = str(tmp_path / "p.png")
    from PIL import Image
    Image.fromarray((np.random.RandomState(3).rand(50, 50, 3) * 255)
                    .astype(np.uint8)).save(png)
    real = {cli: (cli.train_patch_epoch, cli.validate_patch)
            for cli in (jcli_patch, tcli_patch)}
    # a patch of 0.3 of the frame, and one from image files whose side,
    # 384 sqrt(0.05), fits twice into the 256 px train crop
    for extra in (["--patch-size", "0.3"],
                  ["--patch-size", "0.05", "--patch-path", png,
                   "--mask-path", png]):
        argv = ["--data", FIXTURE, "--kitti-data", roots["kitti"],
                "--flownet", "FlowNetC", "--epochs", "1", "--max-count",
                "2", "--seed", "7", "--l2"] + extra
        runs = {}
        for pkg, cli in (("jax", jcli_patch), ("torch", tcli_patch)):
            rec = {}
            _record_calls(monkeypatch, cli, "train_patch_epoch", rec, 6,
                          real[cli][0])
            _record_calls(monkeypatch, cli, "validate_patch", rec, 4,
                          real[cli][1])
            out = cli.main(argv + ["--output", str(tmp_path / pkg)]
                           + (["--device", "cpu", "--log-output"]
                              if pkg == "torch" else []))
            runs[pkg] = (out, rec)
        (jout, jrec), (tout, trec) = runs["jax"], runs["torch"]
        # two 3-frame samples of the fixture scene, 256x256 crops, then
        # the three KITTI scenes at 384x1280
        tb, vb = trec["train_patch_epoch"], trec["validate_patch"]
        assert len(tb) == 2 and tb[0][0].shape == (1, 256, 256, 3)
        assert len(vb) == 3 and vb[0][1].shape == (1, 384, 1280, 3)
        _same(tb, jrec["train_patch_epoch"])
        _same(vb, jrec["validate_patch"])
        for g, r in zip(tout, jout):
            np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)
        (tm,), (jm,) = trec["validate_patch_out"], jrec["validate_patch_out"]
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL,
                                       atol=ATOL, err_msg=k)
        assert (tmp_path / "torch" / "patch_run" / "patches"
                / "epoch_0.png").exists()


def _avg_line(out):
    line = [ln for ln in out.splitlines() if "* Avg" in ln][-1]
    return [float(x) for x in re.findall(r": (-?[0-9.]+)", line)]


def test_universal_cli_dataset_branch_matches_jax(roots, tmp_path,
                                                  monkeypatch, toy, capsys):
    argv = ["--data", FIXTURE, "--kitti_dir", roots["kitti"], "--flownet",
            "FlowNetC", "--n_height", "64", "--n_width", "128", "--epochs",
            "2", "--n_step", "2", "--seed", "5", "--flow_loss", "l2",
            "--learning_rate", "0.01"]
    runs = {}
    for pkg, cli in (("jax", jcli_universal), ("torch", tcli_universal)):
        rec = {}
        real = cli.train_universal_perturbation

        def wrapped(predict, step, batches, *a, _real=real, _rec=rec, **k):
            def recorded():
                for b in batches():
                    _rec.setdefault("batches", []).append(b)
                    yield b
            return _real(predict, step, recorded, *a, **k)
        monkeypatch.setattr(cli, "train_universal_perturbation", wrapped)
        capsys.readouterr()
        out = cli.main(argv + ["--output_path", str(tmp_path / pkg)]
                       + (["--device", "cpu"] if pkg == "torch" else []))
        runs[pkg] = (out, rec, _avg_line(capsys.readouterr().out))
    (jn, jrec, jm), (tn, trec, tm) = runs["jax"], runs["torch"]
    # two epochs of the fixture's two samples, 64x128 crops
    assert len(trec["batches"]) == 4
    assert trec["batches"][0][0].shape == (1, 64, 128, 3)
    _same(trec["batches"], jrec["batches"])
    for g, r in zip(tn, jn):
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)
    assert np.abs(tn[0]).max() > 0
    # the valset sweep's averages, as printed (3 decimals)
    assert len(tm) == len(jm) == 4
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1.5e-3)


class _Built(Exception):
    """Raised by a recording fetch_model once it has the CLI's kwargs."""


def _fetch_kwargs(cli, monkeypatch, argv):
    """(model ID, module kwargs) that ``cli.main(argv)`` builds its model
    with (the JAX CLI's ``fetch_model`` kwargs, the port's without its
    ``device`` and ``seed``)."""
    got = {}

    def fake(name, *a, **k):
        for key in ("pretrained_path", "device", "seed"):
            k.pop(key, None)
        got.update(name=name, kwargs=k)
        raise _Built

    if cli is jcli_train:
        monkeypatch.setattr(jmodels, "fetch_model", fake)
        monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    else:
        monkeypatch.setattr(tcli_train, "fetch_model", fake)
        argv = argv + ["--device", "cpu"]
    with pytest.raises(_Built):
        cli.main(argv + ["--synthetic", "1"])
    return got["name"], got["kwargs"]


@pytest.mark.parametrize("argv", [
    ["--small"], ["--fnorm", "group", "--cnorm", "none"],
    ["--fnorm", "batch", "--cnorm", "instance"],
    ["--corr_levels", "3", "--corr_radius", "5"],
    ["--no_separate_context", "--flowNetCEnc"], ["--compute_spatial"],
    ["--alternate_corr"], ["--model_kwargs", '{"iters": 5, "small": true}'],
    ["--DEBUG"], ["--model", "RAFT_FlowNetCEncoder_WoContext"],
    ["--mixed_precision", "--small"], ["--pwc", "--pwc_correlations", "1",
                                       "0"]],
    ids=lambda a: " ".join(a))
def test_train_cli_raft_flags_build_the_jax_model(monkeypatch, argv):
    """RAFT's architecture flags (JAX cli/train.py:254-290) give the model
    ID and module kwargs the JAX CLI gives; ``--alternate_corr`` forces the
    alt lookup, which the JAX CLI keeps to the TPU (its "auto" is the
    volume path elsewhere)."""
    jname, jkw = _fetch_kwargs(jcli_train, monkeypatch, list(argv))
    tname, tkw = _fetch_kwargs(tcli_train, monkeypatch, list(argv))
    assert tname == jname
    if "--alternate_corr" in argv:
        assert tkw.pop("corr_impl") == "alt" and "corr_impl" not in jkw
    assert tkw == jkw


DEAD = ["--flowNetCFlexible", "--larger_field2", "--relu_wo_out",
        "--net_relu", "--no_residuals", "--no_sep_gru", "--iterative",
        "--single", "--pinard", "--predict_bias", "--raft_leaky_relu",
        "--raft_no_out_conv", "--corr_conv", "--first_conv_5", "--relu",
        "--update_no_motion_downsampling", "--flowNetC_separateContext",
        "--flowNetC_raftEncoder"]


@pytest.mark.parametrize("argv", [[f] for f in DEAD] + [
    ["--raft_kernel_size", "5"], ["--flowNetC_corrDepth", "2"],
    ["--dropout", "0.5"], ["--pwcflex", "--pwc_correlations", "1"]],
    ids=lambda a: " ".join(a))
def test_train_cli_dead_flags_raise_as_in_jax(monkeypatch, tmp_path, argv):
    """The flags the reference parses but never builds (JAX
    cli/train.py:161-192, 205-230), a non-zero dropout and PWCNetFlex
    raise NotImplementedError in both CLIs before a model is built."""
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    base = ["--synthetic", "1", "--checkpoint_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError):
        jcli_train.main(argv + base)
    with pytest.raises(NotImplementedError):
        tcli_train.main(argv + base + ["--device", "cpu"])


def test_train_cli_small_debug_losses_match_jax(tmp_path, monkeypatch):
    """``--small --DEBUG --synthetic 2``: small RAFT at the DEBUG's 3
    iterations with one set of weights in both CLIs, 2 synthetic batches;
    the losses agree at tests/test_torch_training.py's bound and --DEBUG
    writes no checkpoint, as in JAX."""
    rng = np.random.RandomState(7)
    jm = JRAFT(iters=3, small=True, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    v = {"params": _perturb(v["params"], rng)}
    module = RAFT(iters=3, small=True, mixed_precision=False)
    module.load_state_dict(raft_state_dict_from_jax(v), strict=True)
    argv = ["--small", "--DEBUG", "--synthetic", "2", "--batch_size", "1",
            "--num_steps", "1", "--image_size", "64", "64", "--lr", "1e-4",
            "--seed", "4"]

    jlosses, jkw = [], {}

    def jfetch(name, **k):
        jkw.update(k)
        return JFlowModel("RAFT", jm, v, True, 8)
    monkeypatch.setattr(jmodels, "fetch_model", jfetch)
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    real = jcli_train.train

    def jtrain(*a, **k):
        k["logger"] = lambda step, m: jlosses.append(float(m["loss"]))
        return real(*a, **k)
    monkeypatch.setattr(jcli_train, "train", jtrain)
    jcli_train.main(argv + ["--checkpoint_dir", str(tmp_path / "j")])

    tkw = {}

    def tfetch(name, **k):
        tkw.update(k)
        return FlowModel("RAFT", module.eval(), torch.device("cpu"))
    monkeypatch.setattr(tcli_train, "fetch_model", tfetch)
    out = tcli_train.main(argv + ["--checkpoint_dir", str(tmp_path / "t"),
                                  "--device", "cpu"])
    assert jkw["iters"] == tkw["iters"] == 3 and tkw["small"] is True
    tlosses = [m["loss"] for m in out["history"]]
    assert out["total_steps"] == 2 and len(tlosses) == len(jlosses) == 2
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL)
    # --DEBUG: args.json only, no checkpoint or weights, as in JAX
    assert sorted(os.listdir(tmp_path / "t" / "flow")) == sorted(
        os.listdir(tmp_path / "j" / "flow")) == ["args.json"]
