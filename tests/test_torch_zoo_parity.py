"""The zoo directory and the parity harness of the PyTorch port against
the JAX package's, on the CPU.

A temporary zoo holds, under the JAX registry's file names
(registry.py:55-125), the port's state dicts of seeded weights (and
SpyNet's per-level files under ``spynet_models/``): the port's and the JAX
package's ``fetch_model`` must load the same weights from it, and both
packages' ``cli.parity --synthetic`` over it must write the same table
within the RAFT tolerances.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_spynet import _write_level_files
from understanding_flow_robustness_tpu.cli import parity as jparity
from understanding_flow_robustness_tpu.models import registry as jregistry
from understanding_flow_robustness_tpu_torch.cli import parity as tparity
from understanding_flow_robustness_tpu_torch.models import (
    checkpoint_arg,
    fetch_model,
    predict_flow,
    registry as tregistry,
    scale_flow_head,
)

FLOW_ATOL_PX = 1e-3   # f32 vs f32 (tests/test_model_parity.py:194)
# the parity table's EPEs, port vs JAX on the same f32 weights: their
# flows differ by the summation order (~1e-5 px on the clean flow); the
# I-FGSM steps are signs of image gradients, which can flip where a
# gradient is ~0, so the adversarial EPE gets the harness's own adv_tol
EPE_REL = 1e-4
ADV_REL = 0.05
RAFT_ID = "RAFT_adv_kitti2012_ifgsm_l2_002"   # the f32 RAFT ID
ITERS = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once on a few cores; two torch
    threads each keep them from waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A zoo with RAFT_ID's and SpyNet's files: seeded port weights (RAFT's
    FlowHead scaled to the calibrated operating point)."""
    root = tmp_path_factory.mktemp("zoo")
    raft = fetch_model(RAFT_ID, device="cpu", seed=3, iters=ITERS)
    module = scale_flow_head(raft.module, 0.05)
    torch.save(module.state_dict(),
               root / tregistry._SPECS[RAFT_ID].checkpoint)
    spynet = fetch_model("SpyNet", device="cpu", seed=4)
    (root / "spynet_models").mkdir()
    _write_level_files(spynet.module.state_dict(), root / "spynet_models")
    return root


def _images(seed, h, w):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, h, w, 3).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("name,hw", [(RAFT_ID, (64, 64)),
                                     ("SpyNet", (64, 64))])
def test_zoo_directory_loads_the_jax_weights(zoo, name, hw):
    """Both packages' ``fetch_model`` resolve the zoo directory to the
    model's file and load the same weights: the flows agree in f32."""
    kw = {"iters": ITERS} if name == RAFT_ID else {}
    assert checkpoint_arg(str(zoo), name) == str(
        zoo / tregistry._SPECS[name].checkpoint)
    a, b = _images(5, *hw)
    got = predict_flow(fetch_model(name, pretrained_path=str(zoo),
                                   device="cpu", seed=9, **kw),
                       torch.from_numpy(a), torch.from_numpy(b)).numpy()
    jm = jregistry.fetch_model(name, pretrained_path=str(zoo),
                               mixed_precision=False, **kw) \
        if name == RAFT_ID else jregistry.fetch_model(name, str(zoo))
    ref = np.asarray(jm.predict(a, b))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < FLOW_ATOL_PX


def test_zoo_without_the_file_means_seeded_weights(zoo, capsys):
    """A zoo that lacks the model's file leaves the seeded weights, with a
    warning (the JAX registry's fallback); a checkpoint file itself still
    loads, and SpyNet's own per-level directory too."""
    seeded = fetch_model("RAFT", device="cpu", seed=2, iters=1)
    got = fetch_model("RAFT", pretrained_path=str(zoo), device="cpu",
                      seed=2, iters=1)
    assert "raft-things.pth" in capsys.readouterr().err
    for k, t in seeded.module.state_dict().items():
        assert torch.equal(got.module.state_dict()[k], t), k
    assert checkpoint_arg(str(zoo), "RAFT") is None
    path = str(zoo / tregistry._SPECS[RAFT_ID].checkpoint)
    assert checkpoint_arg(path, "RAFT") == path
    spy = str(zoo / "spynet_models")
    assert checkpoint_arg(spy, "SpyNet") == spy
    assert checkpoint_arg(str(zoo / "none"), "RAFT") is None


def test_parity_cli_matches_jax_over_the_zoo(zoo, tmp_path, monkeypatch):
    """``cli.parity --synthetic 2`` on RAFT_ID (its iterations cut to 2 in
    both registries) over the zoo: the port's table equals the JAX CLI's,
    clean EPE within EPE_REL and the I-FGSM EPE within ADV_REL; the
    markdown names the model; ``--expected`` at the JAX numbers passes."""
    for reg in (jregistry, tregistry):
        spec = reg._SPECS[RAFT_ID]
        build = spec.build
        monkeypatch.setitem(reg._SPECS, RAFT_ID, type(spec)(**{
            **spec.__dict__,
            "build": lambda build=build, **kw: build(**{"iters": ITERS,
                                                        **kw})}))
    argv = ["--models", RAFT_ID, "--valsets", "kitti2015", "--synthetic", "2",
            "--img_height", "64", "--img_width", "64", "--attack_steps", "2",
            "--zoo", str(zoo)]
    assert jparity.main(argv + ["--out", str(tmp_path / "j")]) == 0
    ref = json.load(open(tmp_path / "j" / "parity.json"))["table"]
    expected = tmp_path / "expected.json"
    expected.write_text(json.dumps(ref))
    assert tparity.main(argv + ["--out", str(tmp_path / "t"), "--device",
                                "cpu", "--expected", str(expected)]) == 0
    got = json.load(open(tmp_path / "t" / "parity.json"))["table"]
    row, want = got[RAFT_ID]["kitti2015"], ref[RAFT_ID]["kitti2015"]
    assert row.keys() == want.keys()
    assert abs(row["epe"] - want["epe"]) <= EPE_REL * want["epe"]
    assert abs(row["ifgsm_epe"] - want["ifgsm_epe"]) <= \
        ADV_REL * want["ifgsm_epe"]
    assert row["ifgsm_epe"] > row["epe"]
    md = open(tmp_path / "t" / "parity_table.md").read()
    assert RAFT_ID in md and "ifgsm_epe" in md and "✗" not in md
    assert os.path.isfile(tmp_path / "t" / RAFT_ID / "kitti2015" /
                          "results0.txt")
