"""The PyTorch port's registry, checkpoint loading, initialisation and import
hygiene, on the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    get_feature_map_keys,
    load_reference_state_dict,
    predict_flow,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(b=1, h=64, w=96, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32))
                 for _ in range(2))


def test_fetch_model_ids_and_precision():
    assert fetch_model("RAFT", iters=1, device="cpu").module.mixed_precision
    assert not fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", iters=1,
                           device="cpu").module.mixed_precision
    # every ID of the JAX registry builds; an unknown one names the ported
    with pytest.raises(KeyError, match="unknown model 'FlowNet3'.*FlowNet2"):
        fetch_model("FlowNet3", device="cpu")


@pytest.mark.parametrize("name,cls", [
    ("FlowNetC", "FlowNetC"), ("FlowNetS", "FlowNetS2"),
    ("FlowNetCFlexLarger_k5_reps0", "FlowNetCFlex")])
def test_flownet_ids_are_built(name, cls):
    """The FlowNet family is ported (ROADMAP A7): f32, inputs in multiples
    of 64, the reference's parameter names (strict loading); the flat
    names of FlowNetC_predict_bias for k5_reps0."""
    model = fetch_model(name, device="cpu")
    assert type(model.module).__name__ == cls and not model.is_raft
    assert model.size_multiple == 64
    sd = model.module.state_dict()
    assert "conv1.0.weight" in sd and "predict_flow2.weight" in sd
    assert not any(k.startswith("convs1") for k in sd)
    a, b = _images(1, h=64, w=64)
    flow = predict_flow(model, a, b)
    assert tuple(flow.shape) == (1, 64, 64, 2) and bool(torch.isfinite(flow).all())


def test_fetch_model_builds_wocontext():
    """``RAFT_FlowNetCEncoder_WoContext`` (registry.py:111-118): mixed
    precision, a FlowNetCEncoder fnet, no cnet but ``conv_redir``; it
    serves on the CPU when asked, and takes the RAFT options."""
    model = fetch_model("RAFT_FlowNetCEncoder_WoContext", iters=2, device="cpu")
    m = model.module
    assert m.mixed_precision and model.is_raft and model.size_multiple == 8
    assert not hasattr(m, "cnet") and m.conv_redir.kernel_size == (1, 1)
    assert "fnet.conv3.0.weight" in m.state_dict()
    a, b = _images(1)
    flow = predict_flow(model, a, b)
    assert tuple(flow.shape) == (1, 64, 96, 2) and bool(torch.isfinite(flow).all())
    vol = fetch_model("RAFT_FlowNetCEncoder_WoContext", iters=1, device="cpu",
                      corr_impl="volume", return_features=True)
    assert vol.module.corr_impl == "volume" and vol.module.return_features
    with pytest.raises(ValueError, match="corr_impl"):
        fetch_model("RAFT", device="cpu", corr_impl="sparse")


def test_feature_map_keys_of_the_other_families():
    """WoContext has RAFT's taps; SpyNet, FlowNetS and FlowNet2 expose
    none, as in the JAX package; an unknown ID raises.  PWC-Net's taps:
    tests/test_torch_pwc_taps.py."""
    assert get_feature_map_keys("RAFT_FlowNetCEncoder_WoContext") == \
        get_feature_map_keys("RAFT")
    for name in ("SpyNet", "FlowNetS", "FlowNet2"):
        assert get_feature_map_keys(name) == []
    with pytest.raises(KeyError):
        get_feature_map_keys("RAFT_small")


@pytest.mark.parametrize("name", ["FlowNetC", "FlowNetCFlexLarger_k3_reps3"])
def test_feature_map_keys_of_flownetc_family_match_jax(name):
    """The FlowNetC family's taps, as the JAX registry lists them
    (registry.py:329-331), are the keys its return_features dict holds."""
    from understanding_flow_robustness_tpu.models.registry import (
        get_feature_map_keys as jax_keys,
    )

    keys = get_feature_map_keys(name)
    assert keys == jax_keys(name) and len(keys) == 9
    model = fetch_model(name, device="cpu", return_features=True)
    a, b = _images(1, h=64, w=64)
    with torch.no_grad():
        _, feats = model.module(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))
    assert set(feats) == set(keys)


def test_fetch_model_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU:
    without CUDA, ``fetch_model`` with no device fails instead of falling
    back, and so does the train CLI."""
    import inspect

    from understanding_flow_robustness_tpu_torch.cli import train as cli_train

    assert inspect.signature(fetch_model).parameters["device"].default == "cuda"
    assert cli_train.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fetch_model("SpyNet")


def test_fetch_model_is_seeded():
    a = fetch_model("RAFT", seed=3, iters=1, device="cpu").module.state_dict()
    b = fetch_model("RAFT", seed=3, iters=1, device="cpu").module.state_dict()
    c = fetch_model("RAFT", seed=4, iters=1, device="cpu").module.state_dict()
    k = "update_block.gru.convz1.weight"
    torch.testing.assert_close(a[k], b[k])
    assert not torch.equal(a[k], c[k])


def test_init_scale_matches_jax():
    """Random-init operating points (wild ~100 px iterates, calibrated
    scale_flow_head) rest on the JAX package's init distribution: per conv,
    the kernels' standard deviation agrees within 10% (the JAX kernels are
    HWIO, the port's OIHW)."""
    v = jax.jit(JRAFT().init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                              jnp.zeros((1, 64, 64, 3)))["params"]
    sd = fetch_model("RAFT", seed=0, device="cpu").module.state_dict()
    pairs = {
        "fnet.conv1.weight": v["fnet"]["conv1"]["kernel"],
        "cnet.layer2.0.conv2.weight": v["cnet"]["layer2_0"]["conv2"]["kernel"],
        "update_block.encoder.convc1.weight": v["update_block"]["encoder"]["convc1"]["kernel"],
        "update_block.gru.convq2.weight": v["update_block"]["gru"]["convq2"]["kernel"],
        "update_block.mask.2.weight": v["update_block"]["mask_2"]["kernel"],
    }
    for k, jw in pairs.items():
        ratio = float(sd[k].std()) / float(np.std(np.asarray(jw)))
        assert 0.9 < ratio < 1.1, (k, ratio)
        assert float(sd[k].abs().max()) <= 2.0 * float(np.std(np.asarray(jw))) / 0.87962566103423978 * 1.01


@pytest.mark.parametrize("name", ["RAFT", "RAFT_adv_kitti2012_ifgsm_l2_002"])
def test_predict_flow_shapes(name):
    model = fetch_model(name, iters=2, device="cpu")
    a, b = _images(2)
    flow = predict_flow(model, a, b)
    assert tuple(flow.shape) == (2, 64, 96, 2) and flow.dtype == torch.float32
    assert bool(torch.isfinite(flow).all())
    torch.testing.assert_close(model.predict(a, b), flow)


@pytest.mark.parametrize("wrapper", ["state_dict", "model", None])
def test_pth_roundtrip_reference_layout(tmp_path, wrapper):
    """A synthesized reference checkpoint (DataParallel ``module.`` prefix,
    ``num_batches_tracked`` entries, an optional wrapper dict) loads
    strictly and reproduces the source model's flow."""
    src = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", seed=5, iters=2,
                      device="cpu")
    sd = {f"module.{k}": v.clone() for k, v in src.module.state_dict().items()}
    assert any(k.endswith("num_batches_tracked") for k in sd)
    path = tmp_path / "raft-things.pth"
    torch.save({wrapper: sd, "epoch": 7} if wrapper else sd, path)

    loaded = load_reference_state_dict(str(path))
    assert not any(k.startswith("module.") or k.endswith("num_batches_tracked")
                   for k in loaded)
    dst = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", pretrained_path=str(path),
                      seed=6, iters=2, device="cpu")
    a, b = _images()
    torch.testing.assert_close(predict_flow(dst, a, b), predict_flow(src, a, b),
                               rtol=0, atol=0)


def test_pth_unmapped_key_is_refused(tmp_path):
    sd = fetch_model("RAFT", iters=1, device="cpu").module.state_dict()
    sd["update_block.extra.weight"] = torch.zeros(1)
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        fetch_model("RAFT", pretrained_path=str(path), iters=1, device="cpu")


def test_port_imports_no_jax():
    """Every port module imports without JAX: the machine with the card has
    none.  A fresh interpreter imports them all and finds no ``jax`` (nor
    the JAX package) in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import understanding_flow_robustness_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 8, names\n"
        "for k in ('attacks.global_attacks', 'attacks.perturb_runner',\n"
        "          'attacks.log_utils', 'flowviz.flowlib',\n"
        "          'cli.run_perturb_model', 'attacks.patch',\n"
        "          'attacks.patch3d', 'attacks.patch_attack',\n"
        "          'attacks.universal', 'utils.meters', 'cli.patch_attack',\n"
        "          'cli.test_patch', 'cli.universal_perturbation',\n"
        "          'models.flownet2', 'attacks.corruptions',\n"
        "          'flowviz.io', 'flowviz.png', 'flowviz.flow_viz', 'native',\n"
        "          'data.datasets', 'data.validation', 'data.transforms',\n"
        "          'training.evaluate', 'cli.evaluate', 'cli.infer',\n"
        "          'data.augmentor', 'data.loader', 'data.sequence_folders',\n"
        "          'utils.embedding', 'cli.test_moving_patch',\n"
        "          'cli.test_replace_features', 'cli.test_patch_embeddings',\n"
        "          'utils.msgpack', 'utils.profiling', 'utils.viz',\n"
        "          'training.checkpoint', 'cli.convert',\n"
        "          'cli.prepare_train_data', 'parallel', 'parallel.mesh'):\n"
        "    assert p.__name__ + '.' + k in names, k\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'msgpack', 'orbax', 'cv2', 'PIL')\n"
        "       or m.startswith('understanding_flow_robustness_tpu.')\n"
        "       or m == 'understanding_flow_robustness_tpu']\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_imports_no_cv2_or_pil():
    """No module of the port imports cv2 or PIL, at the top or inside a
    function: the machine with the card has neither; nor JAX, flax,
    msgpack or orbax (the port reads flax's .msgpack files with its own
    codec).  Scans the syntax tree of every source file; relative imports
    name the port's own modules."""
    import ast

    root = os.path.join(REPO, "understanding_flow_robustness_tpu_torch")
    found, files = [], 0
    for dirpath, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            files += 1
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    mods = [node.module]
                elif isinstance(node, ast.Call) and getattr(
                        node.func, "attr", getattr(node.func, "id", "")) in (
                        "import_module", "__import__") and node.args and \
                        isinstance(node.args[0], ast.Constant):
                    mods = [str(node.args[0].value)]
                found += [(os.path.relpath(path, REPO), node.lineno, m)
                          for m in mods if m.split(".")[0] in (
                              "cv2", "PIL", "jax", "flax", "msgpack",
                              "orbax")]
    assert files >= 60
    assert not found, found


@pytest.mark.parametrize("first", [1, 101, 201, 301])
def test_correlated_circle_patch_matches_jax(first):
    """create_correlated_patch("circle", n) against the JAX package's (its
    cv2.circle rings), n = first .. first + 99: every size the CLIs'
    --patch_size can give up to 400, 100 (test_patch's default) and 153
    included."""
    from understanding_flow_robustness_tpu.attacks import patch as jpatch
    from understanding_flow_robustness_tpu_torch.attacks import patch as tpatch

    for n in range(first, first + 100):
        got = tpatch.create_correlated_patch("circle", n)
        want = jpatch.create_correlated_patch("circle", n)
        assert got.dtype == want.dtype and got.shape == want.shape == (
            1, n, n, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"n = {n}")
