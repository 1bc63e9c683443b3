"""``parallel.spatial_predict`` on the five model families the JAX
package's tests/test_spatial_shard.py holds, on the CPU: gloo ranks of
``parallel.launch`` laid out as 1 x 2 and 2 x 2 ``data x spatial`` meshes,
each rank on its (batch slice, row block) of JAX's inputs (B = 2,
256x128).  Each gathered flow is held against the port's one-device
``predict_flow`` and against the JAX package's ``model.predict`` on the
same seeded weights (``models.flax_variables``) at JAX's own bars; one case
runs JAX's ``spatial_predict`` itself on its 2 x 4 mesh of conftest's
eight CPU devices.

RAFT runs twice: at its registry configuration (bf16 mixed precision)
against the port, and in f32 (``mixed_precision=False``) against the port
and the JAX package, where bf16's rounding in two packages' other places
would hide the sharding's own error.  The spatial-correlation RAFT
(``compute_spatial=True``, f32) runs against both too: its lookup's
C-order reshape mixes the whole map's rows, which each rank rebuilds for
its own from the gathered correlation.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_spatial_workers as workers
from test_torch_raft_variants import FLOW_ATOL_PX

from understanding_flow_robustness_tpu.models.registry import (
    fetch_model as jfetch_model,
)
from understanding_flow_robustness_tpu.parallel import (
    image_sharding,
    make_2d_mesh as jmake_2d_mesh,
    spatial_predict as jspatial_predict,
)
from understanding_flow_robustness_tpu_torch import parallel
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    flax_variables,
    predict_flow,
)

# {case: (registry name, fetch_model kwargs)}; RAFT at JAX's test's
# iterations
CASES = {"FlowNetS": ("FlowNetS", {}), "FlowNetC": ("FlowNetC", {}),
         "SpyNet": ("SpyNet", {}), "PWCNet": ("PWCNet", {}),
         "RAFT": ("RAFT", {"iters": 3}),
         "RAFT_f32": ("RAFT", {"iters": 3, "mixed_precision": False}),
         "RAFT_spatial": ("RAFT", {"iters": 3, "mixed_precision": False,
                                  "compute_spatial": True})}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
# JAX's bars, tests/test_spatial_shard.py: max |d| in px, or max |d| /
# max |ref|.  They hold the port's sharded flow against the JAX package
# and, for the bf16 models, against the port's one-device flow: the
# sharded convolutions round at other places, and random-init PWC-Net and
# RAFT amplify that through leaky-relu gate flips and the iterations
# (measured 0.77 % and 1.4 %, 2 x 2 mesh).  Against the JAX package
# (2 x 2 mesh) measured: FlowNetS 1.5e-5 px, FlowNetC 1.1e-5, SpyNet
# 1.2e-4, PWC-Net 1.0 % (two bf16 policies), RAFT in f32 1.6e-6.  The
# spatial-correlation RAFT at tests/test_torch_raft_spatial.py's f32 bar,
# 1e-3 px
JAX_BARS = {"FlowNetS": (1e-4, None), "FlowNetC": (1e-4, None),
            "SpyNet": (1e-3, None), "PWCNet": (None, 0.02),
            "RAFT": (None, 0.03), "RAFT_f32": (None, 0.03),
            "RAFT_spatial": (FLOW_ATOL_PX, None)}
# f32 models, sharded vs one device: max |d| / max |ref| (measured
# 8.7e-7 .. 3.4e-6: sums in other orders)
F32_REL = 1e-5
SELF_BARS = {k: (None, F32_REL) for k in CASES}
SELF_BARS.update(PWCNet=JAX_BARS["PWCNet"], RAFT=JAX_BARS["RAFT"])
JAX_CASES = ("FlowNetS", "FlowNetC", "SpyNet", "PWCNet", "RAFT_f32",
             "RAFT_spatial")
LAUNCH_TIMEOUT = 600  # s: a hung rank fails the test instead of the run


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(2, 256, 128, 3).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The seeded port models, their one-device flows and every mesh's
    gathered sharded flows."""
    tmp = tmp_path_factory.mktemp("spatial_models")
    a, b = _images()
    models, flows, files = {}, {}, {}
    for key, (name, kw) in CASES.items():
        models[key] = fetch_model(name, device="cpu", seed=0, **kw)
        files[key] = str(tmp / f"{key}.pt")
        torch.save(models[key].module.state_dict(), files[key])
        flows[key] = predict_flow(models[key], torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    job = {"images": [a, b],
           "models": {k: (CASES[k][0], CASES[k][1], files[k])
                      for k in CASES}}
    sharded = {m: parallel.launch(workers.suite, nd * ns, (nd, ns), job,
                                  device="cpu",
                                  timeout=LAUNCH_TIMEOUT)["flows"]
               for m, (nd, ns) in MESHES.items()}
    return models, flows, sharded


def _check(got, ref, bars):
    atol, rel = bars
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    if rel is not None:
        assert err / (np.abs(ref).max() + 1e-9) < rel, err
    else:
        assert err < atol, err


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_spatial_predict_matches_one_device(run, case, mesh):
    """Each rank's block of the flow, gathered, is the one-device flow."""
    _, flows, sharded = run
    _check(sharded[mesh][case], flows[case], SELF_BARS[case])
    assert np.abs(flows[case]).mean() > 0.1  # not a trivially zero flow


def _jax_model(port_model, name, kw):
    """The JAX package's model on the port model's weights."""
    jm = jfetch_model(name, pretrained_path=None, **kw)
    return dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        np.asarray, flax_variables(port_model.module)))


@pytest.fixture(scope="module")
def jax_flows(run):
    models = run[0]
    a, b = _images()
    return {k: np.asarray(_jax_model(models[k], *CASES[k]).predict(a, b))
            for k in JAX_CASES}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", JAX_CASES)
def test_spatial_predict_matches_jax(run, jax_flows, case, mesh):
    """The port's sharded flow against the JAX package's one-device
    ``model.predict`` on the same weights, at JAX's bars."""
    _check(run[2][mesh][case], jax_flows[case], JAX_BARS[case])


def test_jax_spatial_predict_matches_port(run):
    """JAX's own ``spatial_predict`` on its 2 x 4 mesh (conftest's eight
    CPU devices) against the port's sharded FlowNetS on both meshes: the
    same function, partitioned by XLA and by the port's halo layers."""
    models = run[0]
    jm = _jax_model(models["FlowNetS"], *CASES["FlowNetS"])
    a, b = _images()
    mesh = jmake_2d_mesh(2, 4)
    fn = jspatial_predict(jm.predict_fn, mesh)
    with mesh:
        out = fn(jm.variables, a, b)
        assert out.sharding.is_equivalent_to(image_sharding(mesh), out.ndim)
        out = np.asarray(out)
    for m in MESHES:
        _check(run[2][m]["FlowNetS"], out, JAX_BARS["FlowNetS"])
