"""``parallel.spatial_predict`` on the registry IDs that
tests/test_torch_spatial_models.py does not hold (the FlowNetC variants,
FlowNet2, the adversarially trained PWC-Net and RAFT, RAFT with the
FlowNetC encoder) at their registry configurations, on 1 x 2 and 2 x 2
``data x spatial`` meshes of gloo CPU ranks, against the port's one-device
``predict_flow``; and RAFT's other configurations (small RAFT, the volume
path, radius 3, five levels, group and batch norms) on the 1 x 2 mesh.
Inputs: B = 2, 256x128, seeded weights.
"""

import numpy as np
import pytest
import torch
import torch_spatial_workers as workers
from test_torch_spatial_models import CASES as FAMILY_CASES
from test_torch_spatial_models import F32_REL, JAX_BARS, _check, _images

from understanding_flow_robustness_tpu_torch import parallel
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    predict_flow,
    registry,
)

IDS = ("FlowNetCFlexLarger_k3_reps3",
       "FlowNetCFlexLarger_k3_reps3_adv_ifgsm_l2_002",
       "FlowNetCFlexLarger_k5_reps0", "FlowNetC_larger_field", "FlowNet2",
       "PWCNet_adv_ifgsm_l2_002", "RAFT_FlowNetCEncoder_WoContext",
       "RAFT_adv_kitti2012_ifgsm_l2_002")
# RAFT IDs at the iterations of JAX's spatial test
CASES = {k: (k, {"iters": 3} if k.startswith("RAFT") else {}) for k in IDS}
# RAFT's configurations beyond the registry's, in f32 (run exactly on a
# spatial mesh; compute_spatial: tests/test_torch_spatial_models.py)
CONFIGS = {f"RAFT/{k}": ("RAFT", {"iters": 3, "mixed_precision": False,
                                  **kw})
           for k, kw in (("small", {"small": True}),
                         ("volume", {"corr_impl": "volume"}),
                         ("radius3", {"corr_radius": 3}),
                         ("levels5", {"corr_levels": 5}),
                         ("group_norms", {"fnorm": "group",
                                          "cnorm": "group"}),
                         ("batch_fnet", {"fnorm": "batch",
                                         "cnorm": "none"}))}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
# sharded vs one device: max |d| / max |ref|.  f32 models at
# test_torch_spatial_models.F32_REL; bf16 PWC-Net and RAFT at JAX's bars;
# FlowNet2's four chained border warps amplify the convolutions' other
# summation orders (measured 4.7e-5 on the 2 x 2 mesh).  RAFT with an
# eval-mode batch-norm fnet at its initial statistics normalises nothing:
# its features grow layer by layer and the lookup's taps with them, so
# f32 itself is far from exact there (the one-device f32 flow is 2.4e-3
# of max |flow| from the f64 one; the sharded one measured 3.1e-3 from it)
BARS = {k: (None, F32_REL) for k in (*IDS, *CONFIGS)}
BARS.update({"FlowNet2": (None, 2e-4), "RAFT/batch_fnet": (None, 1e-2),
             "PWCNet_adv_ifgsm_l2_002": JAX_BARS["PWCNet"],
             "RAFT_FlowNetCEncoder_WoContext": JAX_BARS["RAFT"]})
LAUNCH_TIMEOUT = 600  # s


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The one-device flows and every mesh's gathered sharded flows (the
    RAFT configurations on 1 x 2 only)."""
    tmp = tmp_path_factory.mktemp("spatial_zoo")
    a, b = _images()
    flows, jobs = {}, {m: {} for m in MESHES}
    for key, (name, kw) in {**CASES, **CONFIGS}.items():
        model = fetch_model(name, device="cpu", seed=0, **kw)
        path = str(tmp / f"{key.replace('/', '_')}.pt")
        torch.save(model.module.state_dict(), path)
        flows[key] = predict_flow(model, torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
        del model
        for m in MESHES:
            if m == "1x2" or key in CASES:
                jobs[m][key] = (name, kw, path)
    sharded = {m: parallel.launch(workers.suite, nd * ns, (nd, ns),
                                  {"images": [a, b], "models": jobs[m]},
                                  device="cpu",
                                  timeout=LAUNCH_TIMEOUT)["flows"]
               for m, (nd, ns) in MESHES.items()}
    return flows, sharded


def test_every_registry_id_is_held():
    """This file and test_torch_spatial_models.py together hold every
    registry ID."""
    held = set(IDS) | {name for name, _ in FAMILY_CASES.values()}
    assert held == set(registry._SPECS)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", IDS)
def test_registry_id_matches_one_device(run, case, mesh):
    flows, sharded = run
    _check(sharded[mesh][case], flows[case], BARS[case])
    assert np.abs(flows[case]).mean() > 1e-3  # not a trivially zero flow


@pytest.mark.parametrize("case", list(CONFIGS))
def test_raft_configuration_matches_one_device(run, case):
    flows, sharded = run
    _check(sharded["1x2"][case], flows[case], BARS[case])
