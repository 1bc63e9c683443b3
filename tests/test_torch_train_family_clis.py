"""The train CLI of the PyTorch port on the families other than RAFT, on
the CPU: ``--synthetic`` batches through FlowNetS, the FlowNetC family,
PWC-Net, SPyNet and FlowNet2, the reference's architecture flags as the
JAX CLI maps them (cli/train.py:231-252), ``--adversarial`` on each family
the paper trained adversarially and the refusals the JAX CLI shares.  The
train step itself is held against the JAX package's in
tests/test_torch_train_families.py.
"""

import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu_torch.cli import train as cli_train
from understanding_flow_robustness_tpu_torch.models.registry import _SPECS


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cli(tmp_path, argv, size=(64, 128), batch=2):
    return cli_train.main(argv + [
        "--synthetic", "2", "--num_steps", "1", "--batch_size", str(batch),
        "--image_size", str(size[0]), str(size[1]), "--name", "fam",
        "--checkpoint_dir", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("argv,model,cls", [
    (["--model", "FlowNetS"], "FlowNetS", "FlowNetS2"),
    (["--flowNetC"], "FlowNetC", "FlowNetC"),
    (["--model", "FlowNetC_larger_field"], "FlowNetC_larger_field",
     "FlowNetCFlex"),
    (["--flowNetC", "--flexible_larger_field", "--kernel_size", "3",
      "--numReps", "3"], "FlowNetCFlexLarger_k3_reps3", "FlowNetCFlex"),
    (["--pwc"], "PWCNet", "PWCNet"),
    (["--model", "PWCNet_adv_ifgsm_l2_002", "--multiscaleEPE"],
     "PWCNet_adv_ifgsm_l2_002", "PWCNet"),
    (["--model", "SpyNet"], "SpyNet", "SpyNet"),
    (["--model", "FlowNet2"], "FlowNet2", "FlowNet2"),
], ids=lambda x: "_".join(x) if isinstance(x, list) else None)
def test_train_cli_trains_each_family(tmp_path, monkeypatch, argv, model,
                                      cls):
    """``--synthetic`` batches through the CLI: the model its flags pick,
    the loss's branches (flownetc for every non-RAFT model, pwc for
    PWC-Net), frozen batch norm for RAFT only, finite losses, the
    checkpoint; num_steps 1 takes 2 batches."""
    seen = {}
    real = cli_train.train

    def spy(cfg, m, *a, **k):
        seen["cfg"], seen["model"] = cfg, m
        return real(cfg, m, *a, **k)

    monkeypatch.setattr(cli_train, "train", spy)
    out = _cli(tmp_path, argv + ["--stage", "kitti"])
    cfg, m = seen["cfg"], seen["model"]
    assert m.name == model and type(m.module).__name__ == cls
    assert cfg.flownetc and cfg.pwc == ("PWC" in model)
    assert not cfg.freeze_bn  # RAFT-only, whatever the stage
    assert cfg.loss_type == ("multiscale" if "--multiscaleEPE" in argv
                             else "sequence")
    assert out["total_steps"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert (tmp_path / "fam" / "fam.pth").exists()


@pytest.mark.parametrize("argv,want", [
    (["--flowNetC", "--flexible_larger_field", "--kernel_size", "5",
      "--numReps", "1", "--dilation", "2", "--div_flow", "20"],
     {"model": "FlowNetCFlexLarger_k3_reps3", "div_flow": 20.0,
      "conv": ("convs2.0.0", 5, 2), "reps": 1}),
    (["--flowNetC", "--larger_field", "--div_flow", "20"],
     {"model": "FlowNetC_larger_field", "div_flow": 20.0}),
    (["--flowNetC", "--div_flow", "5"],
     {"model": "FlowNetC", "div_flow": 5.0}),
    (["--flowNetC"], {"model": "FlowNetC", "div_flow": 20.0}),
    (["--model", "FlowNetC", "--flownetc_weighing", "--finetune"],
     {"model": "FlowNetC", "weighing": True, "val_freq": 100}),
    (["--model", "SpyNet", "--adversarial"],
     {"model": "SpyNet", "val_freq": 1000}),
    (["--model", "RAFT", "--stage", "kitti"],
     {"model": "RAFT", "freeze_bn": True, "val_freq": 5000}),
], ids=["flex", "larger_field", "div_flow", "default_div", "weighing",
        "adv_val_freq", "raft_freeze_bn"])
def test_train_cli_architecture_flags(monkeypatch, argv, want):
    """The reference's get_model() flags (train.py:55-92) as the JAX CLI
    maps them (cli/train.py:231-252): the ID, the module's kwargs, the
    loss weighing, the val_freq default and RAFT-only frozen batch norm."""
    args = cli_train.build_parser().parse_args(argv)
    kwargs = cli_train._model_kwargs(args)
    assert args.model == want["model"]
    module = _SPECS[args.model].build(**kwargs)
    if "div_flow" in want:
        assert module.div_flow == want["div_flow"]
    if "conv" in want:
        path, k, dil = want["conv"]
        conv = module.get_submodule(path)
        assert conv.kernel_size == (k, k) and conv.dilation == (dil, dil)
        assert len(module.convs2) == 1 + want["reps"]
    seen = {}
    monkeypatch.setattr(cli_train, "train",
                        lambda cfg, *a, **k: seen.setdefault("cfg", cfg) and 0)
    cli_train.main(argv + ["--synthetic", "1", "--device", "cpu",
                           "--iters", "1"])
    cfg = seen["cfg"]
    assert cfg.flownetc_weighing == want.get("weighing", False)
    assert cfg.freeze_bn == want.get("freeze_bn", False)
    assert cfg.val_freq == want.get("val_freq", 5000)


@pytest.mark.parametrize("model", ["FlowNetCFlexLarger_k3_reps3", "PWCNet",
                                   "SpyNet"])
def test_train_cli_adversarial_on_each_family(tmp_path, model):
    """``--adversarial`` on a family other than RAFT: each batch attacked
    in eval mode (the module's [0, 1] images, no x255), then 3 updates on
    the doubled batch."""
    out = _cli(tmp_path, ["--model", model, "--adversarial",
                          "--perturb_n_step", "2"], batch=1)
    assert out["total_steps"] == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])


@pytest.mark.parametrize("argv,exc,match", [
    (["--pwcflex"], NotImplementedError, "PWCNetFlex"),
    (["--flowNetC", "--mixed_precision"], TypeError, "mixed_precision"),
])
def test_train_cli_refuses_what_jax_refuses(tmp_path, argv, exc, match):
    """--pwcflex raises as in the JAX CLI; --mixed_precision on a family
    without it fails building the module, as the JAX module's does."""
    with pytest.raises(exc, match=match):
        cli_train.main(argv + ["--synthetic", "1", "--checkpoint_dir",
                               str(tmp_path), "--device", "cpu"])


def test_train_cli_validates_a_family_through_evaluate(tmp_path, monkeypatch,
                                                       capsys):
    """``--validation kitti`` on FlowNetS: at every val_freq the trainer
    hands the module to ``training/evaluate.py::validate_kitti`` on the
    default root (datasets/KITTI/2015 under the working directory), in eval
    mode, and training goes on in train mode, as the JAX CLI runs it."""
    from test_torch_data import write_layouts

    roots = write_layouts(str(tmp_path / "layouts"), n_kitti=2)
    (tmp_path / "run" / "datasets" / "KITTI").mkdir(parents=True)
    (tmp_path / "run" / "datasets" / "KITTI" / "2015").symlink_to(
        roots["kitti"])
    monkeypatch.chdir(tmp_path / "run")
    modes = []
    from understanding_flow_robustness_tpu_torch.training import evaluate

    validate = evaluate.validate_kitti

    def spy(model, ds):
        modes.append(model.module.training)
        return validate(model, ds)

    monkeypatch.setattr(evaluate, "validate_kitti", spy)
    out = _cli(tmp_path / "ckpt", ["--model", "FlowNetS", "--validation",
                                   "kitti", "--val_freq", "1"])
    assert out["total_steps"] == 2 and modes == [False, False]
    lines = [x for x in capsys.readouterr().out.splitlines()
             if "[kitti]" in x]
    assert len(lines) == 2 and "kitti-epe" in lines[0]
    assert all(np.isfinite(float(v.split("=")[1]))
               for x in lines for v in x.split(": ")[1].split())
