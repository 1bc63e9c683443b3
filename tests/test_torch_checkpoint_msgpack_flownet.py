"""The JAX package's ``.msgpack`` checkpoints in the PyTorch port for the
FlowNet family and FlowNet2, on the CPU: the checks (a)-(d) of
``test_torch_checkpoint_msgpack.py`` (the port's ``cli.convert`` writes
``ufr-convert``'s bytes, the JAX package restores the port's file, the
port's flow from the JAX file within the family's parity tolerance and
bit for bit its flow from the ``.pth``) on FlowNetS, FlowNetC, Robust
FlowNetC and FlowNet2 (162M parameters, a ~650 MB file), in a file of
their own so that Tier-1's workers run them beside the others."""

import pytest
from test_torch_checkpoint_msgpack import (  # noqa: F401
    _two_threads,
    build_case,
    test_convert_writes_ufr_converts_bytes,
    test_jax_restores_the_ports_file,
    test_msgpack_flow_is_the_pth_flow,
    test_port_loads_the_jax_file,
)

# name -> as test_torch_checkpoint_msgpack.FAMILIES
FAMILIES = {
    # tests/test_torch_flownet.py MODEL_REL_L2
    "FlowNetS": ("FlowNetS", {}, 64, ("rel_l2", 1e-5), None),
    "FlowNetC": ("FlowNetC", {}, 64, ("rel_l2", 1e-5), None),
    "FlowNetCFlex": ("FlowNetCFlexLarger_k3_reps3", {}, 64,
                     ("rel_l2", 1e-5), None),
    # tests/test_torch_flownet2.py STAGE_REL_L2["fused"]
    "FlowNet2": ("FlowNet2", {}, 64, ("rel_l2", 1e-4), None),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def case(request, tmp_path_factory):
    key = request.param
    name, kwargs, hw, tol, scale = FAMILIES[key]
    # no batch norm, no dead layer: the loads skip the seeded init
    out = build_case(key, name, kwargs, hw, scale,
                     tmp_path_factory.mktemp(key), load_init=False)
    out["tol"] = tol
    yield out
    out.clear()  # the weights' copies go before the next family's
