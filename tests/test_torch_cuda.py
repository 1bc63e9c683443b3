"""The port's CUDA kernels on the card: ``csrc/alt_corr_fwd.cu``,
``csrc/alt_corr_bwd.cu`` and ``csrc/warp_fwd.cu`` against their plain
PyTorch versions, their wrappers' checks and launch counts, RAFT driving the
lookup kernels in inference and a short train step, SpyNet and PWC-Net
driving the warp kernel.

Every test here needs a CUDA device and skips without one.  This file
imports only torch and the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import re

import pytest
import torch

from understanding_flow_robustness_tpu_torch import ops
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    fetch_model,
    predict_flow,
)
from understanding_flow_robustness_tpu_torch.ops import correlation
from understanding_flow_robustness_tpu_torch.training import (
    fetch_optimizer,
    make_train_step,
)

pytestmark = pytest.mark.gpu

F32_TOL = 1e-4       # abs (tests/test_ops_correlation.py:327)
BF16_REL_TOL = 1e-5  # x max|corr|: same bf16 inputs on both sides, f32 sums
# x max|grad|: both sides sum the same products in f32; the kernel's df2
# atomics land in an order that changes from run to run
BWD_REL_TOL = 1e-5
# the biases of the encoders' convolutions that feed a norm
NORMED_BIAS = re.compile(r"net\.(conv1|layer\d\.\d\.(conv\d|downsample\.0))"
                         r"\.bias$")


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
    with pytest.raises(NotImplementedError, match="B3"):
        ops.alt_corr_lookup(f1, levels, coords.clone().requires_grad_(), 4)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,spread", [
    ((2, 13, 21, 64), 3.0),     # ragged: pooled levels drop rows/columns
    ((1, 24, 40, 256), 40.0),   # RAFT width, wild centres
    ((1, 16, 16, 96), 2.0),     # lanes with and without a chunk of the row
])
def test_backward_kernel_matches_plain(cuda, dtype, shape, spread):
    f1, levels, coords = _case(*shape, dtype, spread)
    g = torch.randn((shape[0], shape[1] * shape[2], 324), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    df1, dlv = correlation._alt_corr_bwd_cuda(f1, levels, coords, g, 4)
    rf1, rlv = ops.alt_corr_lookup_backward_reference(f1, levels, coords, g)
    torch.cuda.synchronize()
    for got, ref in zip((df1, *dlv), (rf1, *rlv)):
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert (got - ref).abs().max().item() <= (
            BWD_REL_TOL * ref.abs().max().item())


def test_backward_wrapper_counts_launches_and_rejects_bad_input(cuda):
    f1, levels, coords = _case(1, 8, 8, 32, torch.float32, 1.0)
    g = torch.ones((1, 64, 324), device="cuda")
    fm1 = torch.randn((1, 8, 8, 32), device="cuda", requires_grad=True)
    fm2 = torch.randn((1, 8, 8, 32), device="cuda", requires_grad=True)
    before = dict(ops.LAUNCH_COUNTS)
    ops.alt_corr_features(fm1, fm2, ops.coords_grid(8, 8, device="cuda")[None]
                          ).sum().backward()
    assert ops.LAUNCH_COUNTS["alt_corr_bwd"] == before.get("alt_corr_bwd", 0) + 1
    assert fm1.grad.dtype == fm2.grad.dtype == torch.float32
    with pytest.raises(ValueError):
        correlation._alt_corr_bwd_cuda(f1, levels, coords, g.double(), 4)
    with pytest.raises(ValueError):
        correlation._alt_corr_bwd_cuda(f1, levels, coords, g[:, :32], 4)
    with pytest.raises(ValueError):
        correlation._alt_corr_bwd_cuda(f1, levels, coords, g, 3)
    assert ops.LAUNCH_COUNTS["alt_corr_bwd"] == before.get("alt_corr_bwd", 0) + 1


@pytest.mark.parametrize("mixed", [False, True])
def test_train_step_launches_kernels_and_matches_plain(cuda, mixed):
    """One train step launches each kernel once per iteration; the
    parameter gradients with the kernels match those with the plain lookup
    (chip_smoke.py's bounds, with their reasons: both paths read the same
    values and keep the lookup's gradient f32, but sum in other orders, so
    their forward trajectories part a little, most in bf16).  The biases of
    the convolutions that feed a norm are left out: the norm removes a
    bias, so their gradient is zero and what they get is rounding noise."""
    torch.manual_seed(0)
    model = RAFT(iters=3, mixed_precision=mixed).to(cuda)
    plain = RAFT(iters=3, mixed_precision=mixed, plain_lookup=True).to(cuda)
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image1": torch.rand((2, 64, 96, 3), generator=g, device="cuda"),
             "image2": torch.rand((2, 64, 96, 3), generator=g, device="cuda"),
             "flow": torch.randn((2, 64, 96, 2), generator=g, device="cuda"),
             "valid": torch.ones((2, 64, 96), device="cuda")}
    grads = []
    for m in (model, plain):
        opt, sched = fetch_optimizer(m.parameters(), num_steps=10)
        step = make_train_step(m, opt, sched, is_raft=True)
        before = dict(ops.LAUNCH_COUNTS)
        assert torch.isfinite(torch.tensor(step(batch)["loss"]))
        n = {k: ops.LAUNCH_COUNTS[k] - before.get(k, 0)
             for k in ("alt_corr_fwd", "alt_corr_bwd")}
        assert n == ({"alt_corr_fwd": 3, "alt_corr_bwd": 3} if m is model
                     else {"alt_corr_fwd": 0, "alt_corr_bwd": 0})
        # the step leaves the gradients it applied in .grad
        grads.append({k: p.grad for k, p in m.named_parameters()
                      if not NORMED_BIAS.search(k)})
    bound = 0.15 if mixed else 2e-3
    for k, q in grads[1].items():
        rel = ((grads[0][k] - q).norm() / q.norm()).item()
        assert rel <= bound, (k, rel)


WARP_F32_REL_TOL = 1e-5  # x max|img|: the same coordinates, f32 weights


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each f32 value (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _warp_case(b, c, h, w, dtype, kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((b, c, h, w), generator=g)
    flow = torch.randn((b, 2, h, w), generator=g)
    if kind == "wild":
        flow = flow * 150.0
    elif kind == "far":
        far = torch.rand((b, 2, h, w), generator=g) < 0.3
        flow = torch.where(far, torch.sign(flow) * 1e30, flow * 3.0)
    return img.to(dtype).cuda(), flow.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros_mask", "spynet"])
@pytest.mark.parametrize("shape,kind", [
    ((2, 5, 13, 21), "far"),       # ragged, +-1e30 flows
    ((1, 32, 96, 320), "wild"),    # PWC level 2, one pair
    ((2, 3, 48, 160), "smooth"),   # SPyNet, a coarse level
])
def test_warp_kernel_matches_plain(cuda, dtype, mode, shape, kind):
    img, flow = _warp_case(*shape, dtype, kind)
    got = ops.warp_backward(img, flow, mode)
    ref = ops.warp_backward_reference(img.float(), flow, mode)
    torch.cuda.synchronize()
    assert got.shape == img.shape and got.dtype == dtype
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() <= WARP_F32_REL_TOL * img.abs().max().item()
    else:  # the f32 sample rounded once, within one bf16 ulp
        assert bool((err <= bf16_ulp(ref)).all())


def test_warp_wrapper_counts_launches_and_rejects_bad_input(cuda):
    img, flow = _warp_case(1, 4, 8, 8, torch.float32, "smooth")
    before = ops.LAUNCH_COUNTS["warp_fwd"]
    ops.warp_backward(img, flow, "border")
    assert ops.LAUNCH_COUNTS["warp_fwd"] == before + 1
    with pytest.raises(TypeError):
        ops.warp_backward(img.double(), flow, "border")
    with pytest.raises(ValueError):
        ops.warp_backward(img, flow[:, :, :4], "border")
    with pytest.raises(ValueError):
        ops.warp_backward(img, flow.cpu(), "border")
    with pytest.raises(ValueError):
        ops.warp_backward(img, flow, "reflect")
    assert ops.LAUNCH_COUNTS["warp_fwd"] == before + 1
    # with autograd the forward still launches the kernel
    img.requires_grad_()
    ops.warp_backward(img, flow, "zeros_mask").sum().backward()
    assert ops.LAUNCH_COUNTS["warp_fwd"] == before + 2
    assert img.grad is not None and bool(torch.isfinite(img.grad).all())


@pytest.mark.parametrize("name,warps,kw", [
    ("SpyNet", 6, {}),
    ("PWCNet", 4, {"mixed_precision": False}),
    ("PWCNet", 4, {}),
])
def test_models_launch_warp_per_level_and_match_plain(cuda, name, warps, kw):
    """One forward warps once per level through the kernel; the flow
    matches the model's with the plain warp (f32: summation order only;
    PWC-Net mixed: the 1 % bar)."""
    model = fetch_model(name, device="cuda", seed=0, **kw)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((2, 128, 256, 3), generator=g, device="cuda")
    b = torch.rand((2, 128, 256, 3), generator=g, device="cuda")
    before = ops.LAUNCH_COUNTS["warp_fwd"]
    flow = predict_flow(model, a, b)
    assert ops.LAUNCH_COUNTS["warp_fwd"] == before + warps
    model.module.plain_warp = True
    plain = predict_flow(model, a, b)
    assert ops.LAUNCH_COUNTS["warp_fwd"] == before + warps
    assert flow.shape == (2, 128, 256, 2) and bool(torch.isfinite(flow).all())
    if getattr(model.module, "mixed_precision", False):
        epe = torch.linalg.vector_norm(flow - plain, dim=-1).mean()
        assert (epe / torch.linalg.vector_norm(plain, dim=-1).mean()) < 1e-2
    else:
        assert (flow - plain).abs().max().item() <= 1e-3
