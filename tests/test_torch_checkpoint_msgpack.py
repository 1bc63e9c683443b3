"""The JAX package's ``.msgpack`` checkpoints in the PyTorch port, on the
CPU: the port's ``cli.convert``, ``training.checkpoint.load_variables`` /
``save_weights_msgpack`` and ``fetch_model(pretrained_path=x.msgpack)``
against the JAX package's ``ufr-convert``, ``load_variables`` and
``save_weights``.

For one model of each family (RAFT, small RAFT, WoContext, PWC-Net,
SpyNet; the FlowNet family and FlowNet2 in
``test_torch_checkpoint_msgpack_flownet.py``) a seeded port model, its
weights and batch-norm statistics moved off their init, is saved as a
reference ``.pth`` (SpyNet: its per-level files).  Then:

(a) the port's ``cli.convert`` of it writes the bytes ``ufr-convert``
    writes (JAX cli/convert.py:46-50 on one shared JAX init), and both
    decode to equal trees;
(b) the JAX package restores the port's file (``load_variables``, what
    its ``fetch_model`` does for a ``.msgpack``; ``fetch_model`` itself on
    SpyNet);
(c) the port's ``fetch_model`` of the JAX file gives the JAX model's flow
    within the family's parity tolerance;
(d) the port's flow from the ``.msgpack`` equals its flow from the
    ``.pth``, bit for bit.

Also: params-only exports (JAX ``save_weights``) restore with init
batch-norm statistics, ``save_weights_msgpack`` writes JAX
``save_weights``'s bytes, a wrong file is refused, and ``cli.evaluate
--model``, ``cli.infer --pretrained`` and ``cli.train --restore_ckpt``
take a ``.msgpack``.
"""

import contextlib
import os
import re
import shutil

import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_data import write_layouts
from test_torch_msgpack import _equal
from test_torch_spynet import _write_level_files

from understanding_flow_robustness_tpu.cli import convert as jconvert_cli
from understanding_flow_robustness_tpu.models import registry as jregistry
from understanding_flow_robustness_tpu.training import checkpoint as jckpt
from understanding_flow_robustness_tpu_torch.cli import convert as tconvert
from understanding_flow_robustness_tpu_torch.cli import evaluate as tevaluate
from understanding_flow_robustness_tpu_torch.cli import infer as tinfer
from understanding_flow_robustness_tpu_torch.cli import train as ttrain
from understanding_flow_robustness_tpu_torch.flowviz import io as fio
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    flax_variables,
    predict_flow,
    scale_flow_head,
)
from understanding_flow_robustness_tpu_torch.models import (
    registry as tregistry,
)
from understanding_flow_robustness_tpu_torch.training import checkpoint
from understanding_flow_robustness_tpu_torch.utils import msgpack

# name -> (registry ID, model kwargs of both packages, H = W, the flow
# tolerance of the family's parity test: ("abs", px) or ("rel_l2", x),
# FlowHead scale for RAFT's calibrated operating point)
FAMILIES = {
    # tests/test_torch_zoo_parity.py / test_torch_raft_variants.py: f32
    "RAFT": ("RAFT", {"iters": 2, "mixed_precision": False}, 64,
             ("abs", 1e-3), 0.05),
    "RAFT_small": ("RAFT", {"iters": 2, "mixed_precision": False,
                            "small": True}, 64, ("abs", 1e-3), 0.3),
    "WoContext": ("RAFT_FlowNetCEncoder_WoContext",
                  {"iters": 2, "mixed_precision": False}, 64,
                  ("abs", 1e-3), 0.05),
    # tests/test_torch_pwcnet.py, test_torch_spynet.py FLOW_ATOL_PX (f32)
    "PWCNet": ("PWCNet", {"mixed_precision": False}, 64, ("abs", 1e-4),
               None),
    "SpyNet": ("SpyNet", {}, 64, ("abs", 2e-4), None),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each
    (see tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(hw, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, hw, hw, 3).astype(np.float32) for _ in range(2)]


def _perturb(module, seed):
    """Every weight and bias moved off flax's init (zero biases would let
    a wrong bias mapping pass), batch-norm statistics off 0 / 1."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            noise = torch.from_numpy(rng.randn(*t.shape).astype(np.float32))
            if name.endswith("running_var"):
                t.copy_(1 + 0.5 * noise.abs())
            else:
                t.add_(0.01 * noise)


def _mismatch(check, *args):
    """None when ``check(*args)`` passes, else its message (the fixture
    checks what needs the big files, then deletes them)."""
    try:
        check(*args)
    except AssertionError as e:
        return str(e) or "mismatch"
    return None


def _same_leaves(got, want):
    got, want = jregistry._flatten(got), jregistry._flatten(want)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), v), k


@contextlib.contextmanager
def _loads_without_seeded_init(skip: bool):
    """With ``skip``, ``fetch_model`` leaves out the seeded init it draws
    before loading a file (15 s for FlowNet2 on two threads).  Only for
    models whose every parameter and buffer the strict load overwrites
    (no batch norm, no dead layer): (d) compares every tensor of two such
    loads, which torch's own random init would set apart."""
    with pytest.MonkeyPatch.context() as mp:
        if skip:
            mp.setattr(tregistry, "init_like_flax", lambda module, gen: None)
        yield


def build_case(key, name, kwargs, hw, scale, tmp, keep_files=False,
               load_init=True):
    """A seeded port model's reference checkpoint, the port's and the JAX
    package's ``.msgpack`` of it, the JAX model holding the port's file,
    and the port's models from the JAX file and from the ``.pth``: the
    comparisons that need the files (a, b) and the flows (c, d).  The
    files are deleted at the end unless ``keep_files`` (FlowNet2's are
    650 MB each); ``load_init=False``: see _loads_without_seeded_init."""
    src = fetch_model(name, device="cpu", seed=3, **kwargs)
    _perturb(src.module, seed=len(key))
    if scale is not None:
        scale_flow_head(src.module, scale)
    if name == "SpyNet":
        pth = tmp / "spynet_models"
        pth.mkdir()
        _write_level_files(src.module.state_dict(), pth)
    else:
        pth = tmp / "src.pth"
        checkpoint.save_weights(str(pth), src.module)
    port_file, jax_file = tmp / "port.msgpack", tmp / "jax.msgpack"
    if "small" in kwargs:
        # no registry ID builds small RAFT, so neither CLI converts it: the
        # port CLI's two steps (cli/convert.py), on the small model
        model = fetch_model(name, pretrained_path=str(pth), device="cpu",
                            **kwargs)
        port_file.write_bytes(msgpack.packb(flax_variables(model.module)))
    else:
        with _loads_without_seeded_init(not load_init):
            tconvert.main(["--flownet", name, "--src", str(pth),
                           "--dst", str(port_file)])
    port_bytes = port_file.read_bytes()

    jm = jregistry.fetch_model(name, pretrained_path=None, **kwargs)
    init = jm.variables
    # ufr-convert's body (JAX cli/convert.py:46-50) on this init
    variables = jregistry._merge_strict(
        init, jregistry.load_checkpoint_variables(name, str(pth)), name)
    jax_bytes = serialization.to_bytes(dict(variables))
    out = {"bytes_equal": port_bytes == jax_bytes,
           "trees": _mismatch(_equal, msgpack.unpackb(port_bytes),
                              serialization.msgpack_restore(jax_bytes))}
    # the JAX package restores the port's file (registry.py:218-225)
    jm.variables = jckpt.load_variables(str(port_file), init)
    out["jax_restores"] = _mismatch(_same_leaves, jm.variables, variables)
    del port_bytes, variables
    jax_file.write_bytes(jax_bytes)
    del jax_bytes
    if not keep_files:
        port_file.unlink()
    a, b = _images(hw)
    # the port loads ufr-convert's file, and the .pth it came from
    with _loads_without_seeded_init(not load_init):
        models = {k: fetch_model(name, pretrained_path=str(path),
                                 device="cpu", seed=11, **kwargs)
                  for k, path in (("jax", jax_file), ("pth", pth))}
    out.update({
        "name": name, "kwargs": kwargs, "src": src, "pth": str(pth),
        "port": str(port_file), "jax": str(jax_file), "jm": jm,
        "init": init, "images": (a, b), "ref": np.asarray(jm.predict(a, b)),
        "models": {k: m.module for k, m in models.items()},
        "flows": {k: _flow(m, (a, b)) for k, m in models.items()}})
    if not keep_files:
        shutil.rmtree(tmp)
    return out


_BUILT: dict = {}


@pytest.fixture(scope="module", params=list(FAMILIES))
def case(request, tmp_path_factory):
    key = request.param
    name, kwargs, hw, tol, scale = FAMILIES[key]
    out = build_case(key, name, kwargs, hw, scale,
                     tmp_path_factory.mktemp(key), keep_files=key == "RAFT")
    out["tol"] = tol
    if key == "RAFT":
        _BUILT[key] = out
    return out


def _flow(model, images):
    return predict_flow(model, *(torch.from_numpy(x) for x in images)).numpy()


def assert_close(got, ref, tol):
    kind, bound = tol
    assert got.shape == ref.shape and np.isfinite(got).all()
    if kind == "abs":
        assert np.abs(got - ref).max() < bound
    else:
        assert np.linalg.norm(got - ref) <= bound * np.linalg.norm(ref)


def test_convert_writes_ufr_converts_bytes(case):
    """(a) Byte for byte ufr-convert's file; both decode (the port's codec,
    flax's) to equal trees."""
    assert case["bytes_equal"]
    assert case["trees"] is None, case["trees"]


def test_jax_restores_the_ports_file(case):
    """(b) The JAX package's load_variables of the port's file gives the
    variables ufr-convert builds, leaf for leaf."""
    assert case["jax_restores"] is None, case["jax_restores"]


def test_port_loads_the_jax_file(case):
    """(c) The port's fetch_model of ufr-convert's file: the JAX model's
    flow within the family's tolerance."""
    assert_close(case["flows"]["jax"], case["ref"], case["tol"])


def test_msgpack_flow_is_the_pth_flow(case):
    """(d) The .msgpack (ufr-convert's, byte for byte the port's: (a)) and
    the .pth it came from load the same weights: the same flow, bit for
    bit, and the same state dict but for PWC-Net's dead ``deconv2``,
    which a .msgpack does not hold and the seeded init fills."""
    np.testing.assert_array_equal(case["flows"]["jax"], case["flows"]["pth"])
    sb = case["models"]["pth"].state_dict()
    for k, t in case["models"]["jax"].state_dict().items():
        if case["name"].startswith("PWCNet") and k.startswith("deconv2."):
            continue
        assert torch.equal(t, sb[k]), k


def test_jax_fetch_model_reads_the_ports_file(tmp_path):
    """The JAX package's own fetch_model and ufr-convert CLI, on SpyNet:
    fetch_model(pretrained_path=<the port's .msgpack>) holds its weights,
    and the CLI's file is the port CLI's, byte for byte."""
    src = fetch_model("SpyNet", device="cpu", seed=5)
    _perturb(src.module, seed=5)
    (tmp_path / "levels").mkdir()
    _write_level_files(src.module.state_dict(), tmp_path / "levels")
    argv = ["--flownet", "SpyNet", "--src", str(tmp_path / "levels")]
    tconvert.main(argv + ["--dst", str(tmp_path / "t.msgpack")])
    jconvert_cli.main(argv + ["--dst", str(tmp_path / "j.msgpack")])
    data = (tmp_path / "t.msgpack").read_bytes()
    assert data == (tmp_path / "j.msgpack").read_bytes()
    jm = jregistry.fetch_model("SpyNet",
                               pretrained_path=str(tmp_path / "t.msgpack"))
    want = jregistry._flatten(serialization.msgpack_restore(data))
    got = jregistry._flatten(jm.variables)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), v), k


@pytest.fixture(scope="module")
def raft_case(tmp_path_factory):
    """RAFT's case, built once for this file's other tests."""
    if "RAFT" not in _BUILT:
        name, kwargs, hw, tol, scale = FAMILIES["RAFT"]
        _BUILT["RAFT"] = dict(build_case("RAFT", name, kwargs, hw, scale,
                                         tmp_path_factory.mktemp("RAFT"),
                                         keep_files=True), tol=tol)
    return _BUILT["RAFT"]


def test_params_only_export_restores_init_batch_stats(raft_case, tmp_path):
    """(e) A params-only export (JAX save_weights, the trainer's final
    weights): both packages keep their init batch-norm statistics (mean
    0, var 1) under the file's params; the flows agree within RAFT's
    tolerance.  The port's save_weights_msgpack writes the same bytes."""
    c = raft_case
    params = serialization.msgpack_restore(open(c["jax"], "rb").read())[
        "params"]
    path = tmp_path / "params.msgpack"
    jckpt.save_weights(str(path), params)
    jvars = jckpt.load_variables(str(path), c["init"])
    stats = jregistry._flatten(jvars["batch_stats"])
    assert stats and all(
        np.all(np.asarray(v) == (1.0 if k[-1] == "var" else 0.0))
        for k, v in stats.items())
    model = fetch_model("RAFT", pretrained_path=str(path), device="cpu",
                        seed=4, **c["kwargs"])
    bn = {k: t for k, t in model.module.state_dict().items()
          if k.endswith(("running_mean", "running_var"))}
    assert bn and all(torch.all(t == (1.0 if k.endswith("var") else 0.0))
                      for k, t in bn.items())
    for k, t in model.module.named_parameters():
        assert torch.equal(t, c["src"].module.state_dict()[k]), k
    ref = np.asarray(c["jm"]._predict_jit(jvars, *c["images"]))
    assert_close(_flow(model, c["images"]), ref, c["tol"])
    mine = tmp_path / "mine.msgpack"
    checkpoint.save_weights_msgpack(str(mine), c["src"].module)
    assert mine.read_bytes() == path.read_bytes()


def test_wrong_files_are_refused(raft_case, tmp_path):
    """Another model's file, a missing leaf and a wrong shape raise."""
    c = raft_case
    with pytest.raises(ValueError, match="neither"):
        fetch_model("SpyNet", pretrained_path=c["port"], device="cpu")
    tree = msgpack.unpackb(open(c["port"], "rb").read())
    del tree["params"]["update_block"]["flow_head"]["conv1"]["bias"]
    bad = tmp_path / "missing.msgpack"
    bad.write_bytes(msgpack.packb(tree))
    with pytest.raises(ValueError, match="missing"):
        fetch_model("RAFT", pretrained_path=str(bad), device="cpu", iters=2)
    tree = msgpack.unpackb(open(c["port"], "rb").read())
    tree["params"]["update_block"]["flow_head"]["conv1"]["bias"] = \
        np.zeros(3, np.float32)
    bad.write_bytes(msgpack.packb(tree))
    with pytest.raises(ValueError, match="shape"):
        fetch_model("RAFT", pretrained_path=str(bad), device="cpu", iters=2)


def _printed_numbers(capsys):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?",
                                         capsys.readouterr().out)]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """The small written dataset layouts (tests/test_torch_data.py)."""
    return write_layouts(str(tmp_path_factory.mktemp("layouts")))


def test_evaluate_and_infer_take_a_msgpack(raft_case, layouts, tmp_path,
                                           capsys):
    """``cli.evaluate --model x.msgpack`` prints the EPE and F1 of the
    ``.pth`` run; ``cli.infer --pretrained x.msgpack`` writes its flows."""
    c = raft_case
    data = '{"kitti": "%s"}' % layouts["kitti"]
    runs = []
    for model in (c["pth"], c["port"]):
        capsys.readouterr()
        tevaluate.main(["--model", model, "--dataset", "kitti", "--iters",
                        "2", "--data_roots", data, "--device", "cpu"])
        runs.append(_printed_numbers(capsys))
    assert len(runs[0]) == 2 and runs[0] == runs[1]

    rng = np.random.RandomState(2)
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    for k in ("10", "11"):
        fio.write_image(str(pairs / f"000000_{k}.png"),
                        rng.randint(0, 256, (61, 83, 3)).astype(np.uint8))
    flows = []
    for model in (c["pth"], c["port"]):
        out = tmp_path / f"out_{os.path.basename(model)}"
        tinfer.main(["--dir", str(pairs), "--pretrained", model,
                     "--device", "cpu", "--output_dir", str(out)])
        flows.append(fio.read_flo(str(out / "000000.flo")))
    np.testing.assert_array_equal(flows[0], flows[1])


@pytest.mark.parametrize("flavour", ["full", "params"])
def test_train_restores_a_msgpack(raft_case, layouts, tmp_path, flavour):
    """``cli.train --restore_ckpt x.msgpack --stage kitti`` on the written
    KITTI layout: the full variables train as the ``.pth`` they came from
    (the same losses and final weights, bit for bit); params only as a
    ``.pth`` of those params with init batch-norm statistics."""
    c = raft_case
    if flavour == "full":
        ckpt, pth = c["port"], c["pth"]
    else:
        ckpt = str(tmp_path / "params.msgpack")
        checkpoint.save_weights_msgpack(ckpt, c["src"].module)
        fresh = fetch_model("RAFT", device="cpu", iters=2)
        fresh.module.load_state_dict(
            {k: t for k, t in c["src"].module.state_dict().items()
             if not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))}, strict=False)
        pth = str(tmp_path / "params.pth")
        checkpoint.save_weights(pth, fresh.module)
    results = []
    for i, restore in enumerate((pth, ckpt)):
        out = tmp_path / f"run{i}"
        res = ttrain.main([
            "--model", "RAFT", "--restore_ckpt", restore, "--device", "cpu",
            "--stage", "kitti", "--data_roots",
            '{"kitti": "%s"}' % layouts["kitti"], "--num_steps", "1",
            "--batch_size", "2", "--image_size", "48", "64", "--iters",
            "2", "--seed", "3", "--checkpoint_dir", str(out),
            "--name", "r"])
        sd = torch.load(out / "r" / "r.pth", weights_only=True)
        results.append((res["history"], sd))
    assert results[0][0] == results[1][0] and results[0][0]
    for k, t in results[0][1].items():
        assert torch.equal(t, results[1][1][k]), k
