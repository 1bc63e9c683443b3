"""``attacks.make_spatial_attack`` on a 2 x 2 ``data x spatial`` mesh of
gloo CPU ranks, at the JAX package's tests/test_spatial_shard.py::
test_spatial_attack_ifgm (FlowNetS, I-FGM, l2 loss, eps 0.02, 2 steps,
B = 2 at 256x128): the eps-ball and [0, 1] invariants exact, and the
adversarial images within 1e-4 mean of the JAX package's one-device
``perturb`` on the same weights and of the port's own.  I-FGM steps by
the raw gradient, so the loss's sums and counts must be the mesh's.  The
port's momentum attack with the diverse input (per-sample L1 norms over
the whole image; the transform on the gathered images), its gaussian
noise (drawn for the global batch and image, sliced) and one I-FGSM step
on the spatial-correlation RAFT in f32 (its gradient through the
gathered correlation's rows) are held against the port's one-device
attack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_spatial_workers as workers

from understanding_flow_robustness_tpu.attacks import (
    PerturbConfig as JPerturbConfig,
)
from understanding_flow_robustness_tpu.attacks import perturb as jperturb
from understanding_flow_robustness_tpu.models.registry import (
    fetch_model as jfetch_model,
)
from understanding_flow_robustness_tpu_torch import parallel
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    flax_variables,
)

EPS = 0.02
ATTACKS = {
    "ifgm": {"perturb_method": "ifgm", "flow_loss": "l2",
             "output_norm": EPS, "n_step": 2},
    "mifgsm_diverse": {"perturb_method": "mifgsm", "flow_loss": "cossim",
                       "output_norm": EPS, "n_step": 2,
                       "probability_diverse_input": 1.0},
    "gaussian": {"perturb_method": "gaussian", "output_norm": EPS},
    "ifgsm_raft_spatial": {"perturb_method": "ifgsm", "flow_loss": "l2",
                           "output_norm": EPS, "n_step": 1},
}
# the model each attack runs on: JAX's test's FlowNetS, and RAFT's
# spatial-correlation mode at tests/test_torch_spatial_models.py's
# configuration
MODELS = {k: ("FlowNetS", {}) for k in ATTACKS}
MODELS["ifgsm_raft_spatial"] = ("RAFT", {"iters": 3,
                                         "mixed_precision": False,
                                         "compute_spatial": True})
# JAX's bar: mean |adv - ref| (the sharded convolutions sum in other
# orders; a sign step can flip where a gradient is ~0)
ADV_MEAN = 1e-4
# I-FGM's two raw-gradient steps move these images by 1.6e-6 on average
# (1.0e-5 at most), far below ADV_MEAN: its noise itself is held, max |d|
# within two f32 ulps of 1.0 (the noise is adv - image, rounded where the
# images lie; measured 1.2e-7), which a gradient scaled by a shard's own
# valid count (x 4 here) fails by ~3e-5
IFGM_NOISE_ATOL = 2 * 2.0 ** -23
SEED = 0
LAUNCH_TIMEOUT = 600  # s


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs():
    """JAX's test's inputs: two frames and the ground truth with a valid
    channel."""
    rng = np.random.RandomState(1)
    img0 = rng.rand(2, 256, 128, 3).astype(np.float32)
    img1 = rng.rand(2, 256, 128, 3).astype(np.float32)
    gt = np.concatenate([rng.randn(2, 256, 128, 2),
                         np.ones((2, 256, 128, 1))], axis=-1)
    return [img0, img1, gt.astype(np.float32)]


@pytest.fixture(scope="module")
def run():
    """{attack: (sharded, one-device)} results (noise0, noise1, adv0,
    adv1) of the port."""
    job = {k: {"model": MODELS[k][0], "kw": MODELS[k][1], "seed": SEED,
               "cfg": cfg, "inputs": _inputs()} for k, cfg in ATTACKS.items()}
    sharded = parallel.launch(workers.suite, 4, (2, 2), {"attacks": job},
                              device="cpu", timeout=LAUNCH_TIMEOUT)
    return {k: (sharded["attacks"][k], workers.spatial_attack(None, None, a))
            for k, a in job.items()}


@pytest.mark.parametrize("name", list(ATTACKS))
def test_spatial_attack_invariants(run, name):
    """The adversarial images in [0, 1], the gradient attacks' noise in
    the eps-ball (gaussian noise has no bound), and the images moved."""
    n0, n1, adv0, adv1 = run[name][0]
    for adv, noise in ((adv0, n0), (adv1, n1)):
        assert adv.min() >= 0.0 and adv.max() <= 1.0
        if name != "gaussian":
            assert np.abs(noise).max() <= EPS + 1e-6
        assert np.abs(noise).max() > 0.0


@pytest.mark.parametrize("name", list(ATTACKS))
def test_spatial_attack_matches_one_device(run, name):
    sharded, ref = run[name]
    if name == "gaussian":  # the same draws, sliced: exact
        for a, b in zip(sharded, ref):
            np.testing.assert_array_equal(a, b)
        return
    for i in (2, 3):
        assert np.abs(sharded[i] - ref[i]).mean() < ADV_MEAN
    if name == "ifgm":
        for i in (0, 1):
            assert np.abs(sharded[i] - ref[i]).max() <= IFGM_NOISE_ATOL


def test_spatial_attack_matches_jax(run):
    """JAX's test_spatial_attack_ifgm's bars against the JAX package's
    one-device ``perturb`` on the port model's weights."""
    port = fetch_model("FlowNetS", device="cpu", seed=SEED)
    jm = jfetch_model("FlowNetS", pretrained_path=None)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        np.asarray, flax_variables(port.module)))
    img0, img1, gt = (jnp.asarray(x) for x in _inputs())
    ref = jperturb(
        lambda a, b: jm.predict_fn(jm.variables, a, b), img0, img1, gt,
        JPerturbConfig(**ATTACKS["ifgm"]), jax.random.PRNGKey(0))
    got = run["ifgm"][0]
    for i in (2, 3):
        assert np.abs(got[i] - np.asarray(ref[i])).mean() < ADV_MEAN
    for i in (0, 1):
        assert np.abs(got[i] - np.asarray(ref[i])).max() <= IFGM_NOISE_ATOL
