"""The port's CUDA kernel on the card: ``csrc/alt_corr_fwd.cu`` against its
plain PyTorch version, its wrapper's checks and launch count, and RAFT
driving it.

Every test here needs a CUDA device and skips without one.  This file
imports only torch and the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from understanding_flow_robustness_tpu_torch import ops
from understanding_flow_robustness_tpu_torch.models import RAFT

pytestmark = pytest.mark.gpu

F32_TOL = 1e-4       # abs (tests/test_ops_correlation.py:327)
BF16_REL_TOL = 1e-5  # x max|corr|: same bf16 inputs on both sides, f32 sums


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(b, h, w, c, dtype, spread, seed=0):
    g = torch.Generator().manual_seed(seed)
    fm1 = torch.randn((b, h, w, c), generator=g)
    fm2 = torch.randn((b, h, w, c), generator=g)
    coords = ops.coords_grid(h, w)[None] + spread * torch.randn((b, h, w, 2), generator=g)
    coords[0, 0, :4] = torch.tensor([[-50.0, -50.0], [500.0, 500.0],
                                     [-3.5, -3.5], [w - 0.25, h - 0.25]])
    f1, levels = ops.prepare_alt_corr(fm1.cuda(), fm2.cuda(), 4, dtype)
    return f1, levels, coords.reshape(b, h * w, 2).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,spread", [
    ((2, 13, 21, 64), 3.0),     # ragged: pooled levels drop rows/columns
    ((1, 24, 40, 256), 40.0),   # RAFT width, wild centres
    ((1, 16, 16, 96), 2.0),     # lanes with and without a chunk of the row
])
def test_kernel_matches_plain(cuda, dtype, shape, spread):
    f1, levels, coords = _case(*shape, dtype, spread)
    got = ops.alt_corr_lookup(f1, levels, coords, 4)
    ref = ops.alt_corr_lookup_reference(f1, levels, coords, 4)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_REL_TOL * ref.abs().max().item()
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= tol


def test_wrapper_counts_launches_and_rejects_bad_input(cuda):
    f1, levels, coords = _case(1, 8, 8, 32, torch.float32, 1.0)
    before = ops.LAUNCH_COUNTS["alt_corr_fwd"]
    ops.alt_corr_lookup(f1, levels, coords, 4)
    assert ops.LAUNCH_COUNTS["alt_corr_fwd"] == before + 1
    with pytest.raises(ValueError):
        ops.alt_corr_lookup(f1, levels, coords, 3)  # only RAFT's radius 4 is built
    with pytest.raises(ValueError):
        ops.alt_corr_lookup(f1[:, :, :30], levels, coords, 4)  # non-contiguous
    with pytest.raises(ValueError):
        ops.alt_corr_lookup(f1, levels, coords.double(), 4)
    with pytest.raises(ValueError):
        ops.alt_corr_lookup(f1, [lv.bfloat16() for lv in levels], coords, 4)
    with pytest.raises(NotImplementedError):
        ops.alt_corr_lookup(f1.clone().requires_grad_(), levels, coords, 4)
    assert ops.LAUNCH_COUNTS["alt_corr_fwd"] == before + 1


@pytest.mark.parametrize("mixed", [False, True])
def test_raft_launches_kernel_per_iteration_and_matches_plain(cuda, mixed):
    torch.manual_seed(0)
    model = RAFT(iters=3, mixed_precision=mixed).eval().to(cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = 255 * torch.rand((2, 3, 64, 96), generator=g, device="cuda")
    b = 255 * torch.rand((2, 3, 64, 96), generator=g, device="cuda")
    before = ops.LAUNCH_COUNTS["alt_corr_fwd"]
    with torch.inference_mode():
        low, up = model(a, b)
        model.plain_lookup = True
        low_p, up_p = model(a, b)
    assert ops.LAUNCH_COUNTS["alt_corr_fwd"] == before + 3
    assert up.shape == (2, 2, 64, 96) and bool(torch.isfinite(up).all())
    # f32: the lookups differ by f32 summation order only; bf16: the 1% bar
    epe = torch.linalg.vector_norm(up - up_p, dim=1).mean()
    rel = (epe / torch.linalg.vector_norm(up_p, dim=1).mean()).item()
    assert rel < (1e-2 if mixed else 1e-4)
