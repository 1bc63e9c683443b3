"""The port's CUDA kernels on the card: ``csrc/alt_corr_fwd.cu``,
``csrc/alt_corr_bwd.cu``, ``csrc/alt_corr_dcoords.cu``, ``csrc/warp_fwd.cu``,
``csrc/corr_lookup_fwd.cu``, ``csrc/spatial_corr_fwd.cu`` and
``csrc/spatial_corr_bwd.cu`` against their plain PyTorch versions, their
wrappers' checks and launch counts, RAFT driving the lookup kernels in
inference (both paths, with and without the feature taps), a short train
step and a short attack, SpyNet and PWC-Net driving the warp kernel, the
FlowNetC family and PWC-Net driving the correlation kernel, and one inner
patch-attack iteration on FlowNetC through both correlation kernels.

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
    assert ops.LAUNCH_COUNTS["alt_corr_fwd"] == before + 1
    # coords that require grad: the forward kernel, then only B3 backward
    n = dict(ops.LAUNCH_COUNTS)
    cg = coords.clone().requires_grad_()
    ops.alt_corr_lookup(f1, levels, cg, 4).sum().backward()
    assert {k: ops.LAUNCH_COUNTS[k] - n.get(k, 0) for k in (
        "alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords")} == {
        "alt_corr_fwd": 1, "alt_corr_bwd": 0, "alt_corr_dcoords": 1}
    assert cg.grad.shape == coords.shape and cg.grad.dtype == torch.float32


def _lookup_coords(b, h, w, kind, seed=0):
    """(b, h, w, 2) centres: the query grid plus a smooth field (amplitude
    3), per-query noise of 2 px ("calibrated") or 150 px ("wild"), or 2 px
    noise with out-of-level and +-1e30 centres in the first row ("edge")."""
    g = torch.Generator().manual_seed(seed)
    grid = ops.coords_grid(h, w)[None]
    if kind == "smooth":
        return _smooth_coords(b, h, w, 3.0, seed)
    coords = grid + {"calibrated": 2.0, "wild": 150.0, "edge": 2.0}[kind] * (
        torch.randn((b, h, w, 2), generator=g))
    if kind == "edge":
        coords[0, 0, :7] = torch.tensor(
            [[-50.0, -50.0], [500.0, 500.0], [-3.5, -3.5], [w - 0.25, h - 0.25],
             [1e30, 3.0], [3.0, -1e30], [-1e30, 1e30]])
    return coords


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["smooth", "calibrated", "wild", "edge"])
@pytest.mark.parametrize("shape", [
    (8, 48, 160, 256),  # RAFT serving: batch 8 at 384x1280
    (1, 48, 160, 256),  # RAFT's patch attack: batch 1 at 384x1280
    (2, 13, 21, 64),    # ragged tiles and pooled levels
    (2, 24, 40, 64),
    (2, 24, 40, 128),
    (1, 24, 40, 256),
])
def test_lookup_kernels_match_plain(cuda, dtype, kind, shape):
    """B1 on both of its paths within the bars of chip_smoke.py (f32: 1e-4;
    bf16: 1e-5 x max|corr|, the same bf16 inputs summed in f32 in another
    order), with its path counter; B5 on the volume pyramid of the same
    features, bit-equal to its plain version (the same products and sums,
    rounded one by one)."""
    b, h, w, c = shape
    g = torch.Generator().manual_seed(1)
    fm1 = torch.randn((b, h, w, c), generator=g).cuda()
    fm2 = torch.randn((b, h, w, c), generator=g).cuda()
    coords = _lookup_coords(b, h, w, kind).cuda()
    cflat = coords.reshape(b, h * w, 2).contiguous()
    f1, levels = ops.prepare_alt_corr(fm1, fm2, 4, dtype)
    counts = torch.zeros(8, dtype=torch.int32, device="cuda")
    got = correlation._alt_corr_lookup_cuda(f1, levels, cflat, 4, counts)
    ref = ops.alt_corr_lookup_reference(f1, levels, cflat, 4)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_REL_TOL * ref.abs().max().item()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= tol
    tiles = b * -(-h // 8) * -(-w // 8)
    assert ((counts[:4] + counts[4:]) <= tiles).all()
    if dtype == torch.float32:  # f32 stays on the per-query path
        assert counts[:4].sum().item() == 0
    elif kind in ("smooth", "calibrated"):  # every box fits
        assert counts[4:].sum().item() == 0
    if kind == "edge":  # windows wholly outside every level
        first = got.reshape(b, h, w, -1)[0, 0]
        assert first[[0, 1, 4, 5, 6]].abs().max().item() == 0
    del got, ref, f1, levels
    pyr = ops.volume_pyramid(fm1, fm2, 4, None if dtype == torch.float32 else dtype)
    got = ops.corr_lookup(pyr, coords.contiguous())
    ref = ops.corr_lookup_reference(pyr, coords)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert (got - ref).abs().max().item() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_kernel_mixed_tile(cuda, dtype):
    """One wild query in a smooth tile makes that tile's level-0 box larger
    than the tile path takes (64 x 32 points), so in one launch that
    (tile, level) alone runs the per-query path in bf16; far (+-1e30) and
    out-of-level queries in another tile have no window inside and leave
    it on the tile path.  f32 runs every (tile, level) per query."""
    b, h, w = 1, 32, 64
    coords = _smooth_coords(b, h, w, 0.5)
    coords[0, 2, 2] = torch.tensor([60.0, 30.0])      # tile (0, 0): wild
    coords[0, 1, 9:13] = torch.tensor([[1e30, 3.0], [3.0, -1e30],
                                       [-50.0, -50.0], [500.0, 500.0]])
    g = torch.Generator().manual_seed(2)
    fm1 = torch.randn((b, h, w, 96), generator=g).cuda()
    fm2 = torch.randn((b, h, w, 96), generator=g).cuda()
    f1, levels = ops.prepare_alt_corr(fm1, fm2, 4, dtype)
    cflat = coords.reshape(b, h * w, 2).contiguous().cuda()
    counts = torch.zeros(8, dtype=torch.int32, device="cuda")
    got = correlation._alt_corr_lookup_cuda(f1, levels, cflat, 4, counts)
    ref = ops.alt_corr_lookup_reference(f1, levels, cflat, 4)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_REL_TOL * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    assert got[0, 64 + 9:64 + 11].abs().max().item() == 0  # +-1e30 windows
    tiles = 4 * 8
    if dtype == torch.bfloat16:
        assert counts.tolist() == [tiles - 1, tiles, tiles, tiles, 1, 0, 0, 0]
    else:
        assert counts.tolist() == [0] * 4 + [tiles] * 4


def test_lookup_wrapper_rejects_bad_path_counts(cuda):
    f1, levels, coords = _case(1, 8, 8, 32, torch.bfloat16, 1.0)
    before = ops.LAUNCH_COUNTS["alt_corr_fwd"]
    for bad in (torch.zeros(8, dtype=torch.int64, device="cuda"),
                torch.zeros(6, dtype=torch.int32, device="cuda"),
                torch.zeros(8, dtype=torch.int32),
                torch.zeros(16, dtype=torch.int32, device="cuda")[::2]):
        with pytest.raises(ValueError):
            correlation._alt_corr_lookup_cuda(f1, levels, coords, 4, bad)
    assert ops.LAUNCH_COUNTS["alt_corr_fwd"] == before
    counts = torch.zeros(8, dtype=torch.int32, device="cuda")
    correlation._alt_corr_lookup_cuda(f1, levels, coords, 4, counts)
    assert ops.LAUNCH_COUNTS["alt_corr_fwd"] == before + 1
    assert counts[:4].tolist() == [1] * 4 and counts[4:].tolist() == [0] * 4


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


def _smooth_coords(b, h, w, amp, seed=3):
    """The query grid plus a smooth field: x4 bilinear upsample of noise."""
    g = torch.Generator().manual_seed(seed)
    coarse = amp * torch.randn((b, 2, h // 4 + 1, w // 4 + 1), generator=g)
    flow = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                           align_corners=False)
    return ops.coords_grid(h, w)[None] + flow.permute(0, 2, 3, 1)


def _backward_vs_plain(fm_shape, dtype, coords, seed=0):
    """B2 with its path counter against the plain backward on seeded
    features and cotangent; returns the counter ([l] tile path, [4 + l]
    per-query path, per (8x8 tile, level))."""
    b, h, w, c = fm_shape
    g = torch.Generator().manual_seed(seed)
    fm1 = torch.randn((b, h, w, c), generator=g)
    fm2 = torch.randn((b, h, w, c), generator=g)
    cot = torch.randn((b, h * w, 324), generator=g).cuda()
    f1, levels = ops.prepare_alt_corr(fm1.cuda(), fm2.cuda(), 4, dtype)
    cflat = coords.reshape(b, h * w, 2).contiguous().cuda()
    counts = torch.zeros(8, dtype=torch.int32, device="cuda")
    df1, dlv = correlation._alt_corr_bwd_cuda(f1, levels, cflat, cot, 4, counts)
    rf1, rlv = ops.alt_corr_lookup_backward_reference(f1, levels, cflat, cot)
    torch.cuda.synchronize()
    for got, ref in zip((df1, *dlv), (rf1, *rlv)):
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert (got - ref).abs().max().item() <= (
            BWD_REL_TOL * ref.abs().max().item())
    tiles = b * -(-h // 8) * -(-w // 8)
    assert ((counts[:4] + counts[4:]) <= tiles).all()
    return counts.cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 13, 21, 64),    # ragged tiles and pooled levels, batch 2
    (2, 20, 28, 96),    # three channel chunks
    (1, 36, 60, 256),   # RAFT's width, the train rows
])
def test_backward_kernel_tile_path_on_smooth_coords(cuda, dtype, shape):
    """A smooth field keeps every tile's windows within one box, so every
    (tile, level) takes the tile path; the gradients match the plain
    backward."""
    b, h, w, _ = shape
    counts = _backward_vs_plain(shape, dtype, _smooth_coords(b, h, w, 0.5))
    tiles = b * -(-h // 8) * -(-w // 8)
    assert counts[:4].tolist() == [tiles] * 4
    assert counts[4:].tolist() == [0] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kind", [
    ((2, 13, 21, 64), "calibrated"),
    ((2, 20, 28, 96), "smooth"),
    ((2, 20, 28, 96), "calibrated"),
    ((1, 36, 60, 256), "smooth"),
    ((1, 36, 60, 256), "wild"),
    ((1, 48, 160, 256), "calibrated"),  # RAFT's patch attack at 384x1280
    ((1, 48, 160, 256), "wild"),
])
def test_backward_kernel_both_paths_match_plain(cuda, dtype, shape, kind):
    """Per-query jittered (calibrated, wild) and smooth (amplitude 3)
    centres: whichever path each (tile, level) takes, the gradients match
    the plain backward."""
    b, h, w, _ = shape
    g = torch.Generator().manual_seed(4)
    grid = ops.coords_grid(h, w)[None]
    coords = {"smooth": lambda: _smooth_coords(b, h, w, 3.0),
              "calibrated": lambda: grid + 2.0 * torch.randn((b, h, w, 2), generator=g),
              "wild": lambda: grid + 40.0 * torch.randn((b, h, w, 2), generator=g),
              }[kind]()
    counts = _backward_vs_plain(shape, dtype, coords)
    assert counts.sum().item() > 0
    if kind == "wild":  # windows of a tile spread over the level
        assert counts[4].item() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_mixed_tile(cuda, dtype):
    """One wild query in a smooth tile sends that (tile, level 0) alone to
    the per-query path; far (+-1e30) and out-of-level queries in another
    tile have no window inside and leave it on the tile path."""
    b, h, w = 1, 32, 64
    coords = _smooth_coords(b, h, w, 0.5)
    coords[0, 2, 2] = torch.tensor([60.0, 30.0])      # tile (0, 0): wild
    coords[0, 1, 9:13] = torch.tensor([[1e30, 3.0], [3.0, -1e30],
                                       [-50.0, -50.0], [500.0, 500.0]])
    counts = _backward_vs_plain((b, h, w, 96), dtype, coords)
    tiles = 4 * 8
    assert counts[4].item() == 1 and counts[:4].tolist() == [tiles - 1] + [tiles] * 3
    assert counts[5:].tolist() == [0] * 3


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,spread", [
    ((2, 13, 21, 64), 3.0),     # ragged: pooled levels drop rows/columns
    ((1, 24, 40, 256), 40.0),   # RAFT width, wild centres
    ((1, 16, 16, 96), 2.0),     # lanes with and without a chunk of the row
    ((1, 16, 16, 32), 0.0),     # exactly integer centres: sign(0) = 0
])
def test_dcoords_kernel_matches_plain(cuda, dtype, shape, spread):
    """B3 against ``alt_corr_coords_grad_reference``: both sum the same
    products of the same values in f32, in other orders."""
    f1, levels, coords = _case(*shape, dtype, spread)
    g = torch.randn((shape[0], shape[1] * shape[2], 324), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    before = ops.LAUNCH_COUNTS["alt_corr_dcoords"]
    got = correlation._alt_corr_dcoords_cuda(f1, levels, coords, g, 4)
    ref = ops.alt_corr_coords_grad_reference(f1, levels, coords, g)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["alt_corr_dcoords"] == before + 1
    assert got.shape == ref.shape == coords.shape and got.dtype == torch.float32
    assert ref.abs().max().item() > 0
    assert (got - ref).abs().max().item() <= BWD_REL_TOL * ref.abs().max().item()
    assert got[0, :2].abs().max().item() == 0  # windows wholly outside


def test_dcoords_wrapper_rejects_bad_input(cuda):
    f1, levels, coords = _case(1, 8, 8, 32, torch.float32, 1.0)
    g = torch.ones((1, 64, 324), device="cuda")
    before = ops.LAUNCH_COUNTS["alt_corr_dcoords"]
    for args in ((f1, levels, coords, g.double(), 4),
                 (f1, levels, coords, g[:, :32], 4),
                 (f1, levels, coords, g, 3),
                 (f1, levels, coords.double(), g, 4)):
        with pytest.raises(ValueError):
            correlation._alt_corr_dcoords_cuda(*args)
    assert ops.LAUNCH_COUNTS["alt_corr_dcoords"] == before


def test_attack_step_launches_kernels_and_matches_plain(cuda):
    """Two I-FGSM steps on RAFT (f32, 3 iterations): each step is one
    forward and one backward through B1 and B2 and never B3; the image
    gradient with the kernels matches the plain lookup's (the f32 bound of
    chip_smoke.py's gradient phase)."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PerturbConfig,
        flow_attack_loss,
        perturb,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        predict_flow_differentiable,
    )

    model = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", device="cuda",
                        seed=0, iters=3)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((1, 64, 96, 3), generator=g, device="cuda")
    b = torch.rand((1, 64, 96, 3), generator=g, device="cuda")
    flow = predict_flow(model, a, b)
    gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2", n_step=2)
    before = dict(ops.LAUNCH_COUNTS)
    n0, n1, adv0, adv1 = perturb(predict, a, b, gt, cfg)
    torch.cuda.synchronize()
    n = {k: ops.LAUNCH_COUNTS[k] - before.get(k, 0)
         for k in ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords")}
    assert n == {"alt_corr_fwd": 6, "alt_corr_bwd": 6, "alt_corr_dcoords": 0}
    assert n0.abs().max().item() <= 0.02 + 1e-6
    assert 0 <= adv0.min().item() and adv1.max().item() <= 1
    grads = []
    for plain in (False, True):
        model.module.plain_lookup = plain
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        loss = flow_attack_loss(predict(x, y), gt, "l2")
        grads.append(torch.autograd.grad(loss, (x, y)))
    for k, p in zip(*grads):
        assert ((k - p).norm() / p.norm()).item() <= 2e-3


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros_mask", "spynet"])
@pytest.mark.parametrize("c", [1, 3, 32])
@pytest.mark.parametrize("w", [13, 21])
def test_warp_kernel_ragged_widths(cuda, dtype, mode, c, w):
    """W not a multiple of the kernel's 4 pixels per thread (every row goes
    scalar), C = 3's unrolled instantiation beside the generic loop: the
    output is the plain version's, for flows with +-1e30 entries."""
    img, flow = _warp_case(2, c, 11, w, dtype, "far", seed=5)
    got = ops.warp_backward(img, flow, mode)
    ref = ops.warp_backward_reference(img.float(), flow, mode)
    torch.cuda.synchronize()
    assert got.shape == img.shape and got.dtype == dtype
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() <= WARP_F32_REL_TOL * img.abs().max().item()
    else:
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


def _volume_case(b, h, w, c, dtype, spread, seed=0):
    """A contiguous (B, N, Hl, Wl) pyramid in ``dtype`` and (B, h, w, 2)
    coords with out-of-volume, +-1e30 and edge centres."""
    g = torch.Generator().manual_seed(seed)
    fm1 = torch.randn((b, h, w, c), generator=g)
    fm2 = torch.randn((b, h, w, c), generator=g)
    coords = ops.coords_grid(h, w)[None] + spread * torch.randn((b, h, w, 2), generator=g)
    coords[0, 0, :7] = torch.tensor([[-50.0, -50.0], [500.0, 500.0], [1e30, 3.0],
                                     [3.0, -1e30], [-1e30, 1e30], [-3.5, -3.5],
                                     [w - 0.25, h - 0.25]])
    pyr = ops.volume_pyramid(fm1.cuda(), fm2.cuda(), 4, dtype)
    return pyr, coords.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,spread", [
    ((2, 13, 21, 64), 3.0),     # ragged: pooled levels drop rows/columns
    ((1, 24, 40, 256), 40.0),   # RAFT width, wild centres
    ((2, 16, 16, 32), 2.0),     # calibrated centres
])
def test_volume_lookup_kernel_matches_plain(cuda, dtype, shape, spread):
    """The kernel blends the plain version's products in its order, one
    rounding each, so the two agree bit for bit; the stated bar is the JAX
    package's 1e-4."""
    pyr, coords = _volume_case(*shape, dtype, spread)
    before = ops.LAUNCH_COUNTS["corr_lookup_fwd"]
    got = ops.corr_lookup(pyr, coords)
    ref = ops.corr_lookup_reference(pyr, coords)
    torch.cuda.synchronize()
    assert ops.LAUNCH_COUNTS["corr_lookup_fwd"] == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= F32_TOL
    assert got[0, 0, :5].abs().max().item() == 0  # windows wholly outside


def test_volume_lookup_wrapper_rejects_bad_input_and_takes_gradients(cuda):
    pyr, coords = _volume_case(1, 8, 8, 32, torch.float32, 1.0)
    levels = [p.reshape(64, *p.shape[2:]) for p in pyr]
    c = coords.reshape(64, 2)
    before = ops.LAUNCH_COUNTS["corr_lookup_fwd"]
    with pytest.raises(ValueError):
        ops.corr_lookup_fwd(levels, c, 3)  # only RAFT's radius 4 is built
    with pytest.raises(ValueError):
        ops.corr_lookup_fwd([lv.transpose(1, 2) for lv in levels], c)
    with pytest.raises(ValueError):
        ops.corr_lookup_fwd(levels, c.double())
    with pytest.raises(ValueError):
        ops.corr_lookup_fwd(levels[:1] + [lv.bfloat16() for lv in levels[1:]], c)
    with pytest.raises(ValueError):
        ops.corr_lookup_fwd(levels, c.cpu())
    assert ops.LAUNCH_COUNTS["corr_lookup_fwd"] == before
    # with autograd: the kernel forward, the plain version's backward
    p = [lv.clone().requires_grad_() for lv in pyr]
    cg = coords.clone().requires_grad_()
    ops.corr_lookup(p, cg).square().sum().backward()
    assert ops.LAUNCH_COUNTS["corr_lookup_fwd"] == before + 1
    q = [lv.clone().requires_grad_() for lv in pyr]
    cq = coords.clone().requires_grad_()
    ops.corr_lookup_reference(q, cq).square().sum().backward()
    for a, b in zip([cg, *p], [cq, *q]):
        torch.testing.assert_close(a.grad, b.grad)


@pytest.mark.parametrize("mixed", [False, True])
def test_raft_volume_path_launches_lookup_per_iteration(cuda, mixed, monkeypatch):
    """``corr_impl="volume"``: one ``corr_lookup_fwd`` launch per iteration
    and none of ``alt_corr_fwd``; the flow matches the alt path's and the
    plain lookup's (f32: summation order only; mixed: the 1 % bar, the
    two paths round to bf16 at other places); with the taps on, every
    ``idx_corr_vol_{i}`` is the kernel's lookup output."""
    from understanding_flow_robustness_tpu_torch.models import raft_model

    torch.manual_seed(0)
    model = RAFT(iters=3, mixed_precision=mixed, corr_impl="volume").eval().to(cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = 255 * torch.rand((2, 3, 64, 96), generator=g, device="cuda")
    b = 255 * torch.rand((2, 3, 64, 96), generator=g, device="cuda")
    before = dict(ops.LAUNCH_COUNTS)
    with torch.inference_mode():
        _, up = model(a, b)
        n = {k: ops.LAUNCH_COUNTS[k] - before.get(k, 0)
             for k in ("corr_lookup_fwd", "alt_corr_fwd")}
        model.plain_lookup = True
        _, up_plain = model(a, b)
        model.plain_lookup = False
        model.corr_impl = "alt"
        _, up_alt = model(a, b)
        model.corr_impl = "volume"
        model.return_features = True
        outs = []
        monkeypatch.setattr(raft_model, "corr_lookup", lambda *args: outs.append(
            ops.corr_lookup(*args)) or outs[-1])
        _, up_taps, feats = model(a, b)
    assert n == {"corr_lookup_fwd": 3, "alt_corr_fwd": 0}
    assert up.shape == (2, 2, 64, 96) and bool(torch.isfinite(up).all())
    torch.testing.assert_close(up_taps, up, rtol=0, atol=0)
    for other in (up_plain, up_alt):
        epe = torch.linalg.vector_norm(up - other, dim=1).mean()
        rel = (epe / torch.linalg.vector_norm(other, dim=1).mean()).item()
        assert rel < (1e-2 if mixed else 1e-4)
    assert len(outs) == 3
    for it, out in enumerate(outs):
        assert feats[f"idx_corr_vol_{it}"].data_ptr() == out.data_ptr()
        torch.testing.assert_close(feats[f"idx_corr_vol_{it}"],
                                   out.permute(0, 3, 1, 2), rtol=0, atol=0)


# --- the spatial correlation: csrc/spatial_corr_fwd.cu, spatial_corr_bwd.cu --

CORR_REL_TOL = 1e-5  # f32 x max|plain|: the same products, other sum orders


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("shape,patch,dil,dtype", [
    ((8, 256, 48, 160), 21, 2, torch.float32),   # FlowNetC serving
    ((1, 256, 32, 80), 21, 2, torch.float32),    # FlowNetC attack
    ((8, 196, 6, 20), 9, 1, torch.bfloat16),     # PWC-Net mixed, levels 6..2
    ((8, 128, 12, 40), 9, 1, torch.bfloat16),
    ((8, 96, 24, 80), 9, 1, torch.bfloat16),
    ((8, 64, 48, 160), 9, 1, torch.bfloat16),
    ((8, 32, 96, 320), 9, 1, torch.bfloat16),
    ((2, 3, 13, 21), 21, 2, torch.float32),      # ragged: H, W off the tile,
    ((2, 33, 37, 45), 9, 1, torch.bfloat16),     # C = 3, 33, 196
    ((1, 196, 7, 9), 21, 2, torch.bfloat16),
    ((2, 33, 37, 45), 7, 3, torch.float32),      # other patches and dilations
    ((2, 20, 11, 40), 5, 2, torch.bfloat16),
    ((1, 16, 20, 70), 23, 1, torch.float32),     # > 128 displacements: 5 passes
    ((2, 40, 13, 37), 1, 1, torch.float32),      # P = 1 (the default) and 3,
    ((2, 40, 13, 37), 1, 1, torch.bfloat16),     # C > 16 (more than one
    ((2, 35, 19, 45), 3, 1, torch.float32),      # staged chunk)
    ((1, 33, 9, 70), 3, 4, torch.bfloat16),
    # the tile kernels' edges: W off the tile and its 4-column loads
    ((2, 256, 48, 157), 21, 2, torch.float32),
    ((1, 64, 9, 17), 21, 2, torch.float32),      # H, W below the reach
    ((1, 200, 12, 40), 21, 2, torch.float32),    # C off the backward's
    ((1, 196, 12, 40), 9, 1, torch.bfloat16),    # channel groups
    ((1, 50, 10, 44), 9, 1, torch.float32),      # the 64-channel group
    ((1, 256, 48, 160), 21, 2, torch.float32),   # FlowNetC patch
])
def test_spatial_corr_kernels_match_plain(cuda, shape, patch, dil, dtype):
    """Forward and backward kernels against the plain version and its
    autograd on the same inputs: f32 within 1e-5 x max|plain|; bf16 within
    one bf16 ulp of the plain value (both round one f32 sum), or the f32
    bar where a sum cancels below it; gradients (f32 sums, written in the
    inputs' dtype) within 1e-5 x max|plain| in f32, one bf16 ulp in bf16."""
    g = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    f2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    cot = torch.randn((shape[0], patch ** 2) + shape[2:], generator=g,
                      device="cuda").to(dtype)
    got = ops.spatial_correlation(f1, f2, patch, dilation_patch=dil)
    ref = ops.spatial_correlation_reference(f1, f2, patch, dil)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    bar = CORR_REL_TOL * ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        assert bool((err <= torch.clamp(_bf16_ulp(ref.float()), min=bar)).all())
    else:
        assert err.max().item() <= bar
    # the backward kernel against the plain version's autograd
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    ops.spatial_correlation(a, b, patch, dilation_patch=dil).backward(cot)
    pa, pb = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    ops.spatial_correlation_reference(pa, pb, patch, dil).backward(cot)
    torch.cuda.synchronize()
    for k, p in ((a.grad, pa.grad), (b.grad, pb.grad)):
        assert k.dtype == dtype and bool(torch.isfinite(k).all())
        e = (k.float() - p.float()).abs()
        tol = CORR_REL_TOL * p.float().abs().max().item()
        if dtype == torch.bfloat16:
            assert bool((e <= torch.clamp(_bf16_ulp(p.float()), min=tol)).all())
        else:
            assert e.max().item() <= tol


@pytest.mark.parametrize("shape,patch,dil,dtype", [
    ((1, 256, 32, 80), 21, 2, torch.float32),    # FlowNetC attack
    ((8, 32, 96, 320), 9, 1, torch.bfloat16),    # PWC-Net level 2
    ((2, 35, 19, 45), 3, 1, torch.float32),      # the generic kernel
])
def test_spatial_corr_bwd_is_deterministic(cuda, shape, patch, dil, dtype):
    """Two backward launches on the same inputs give bit-equal gradients:
    gathers, no atomics, every output element written once."""
    g = torch.Generator(device="cuda").manual_seed(1)
    f1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    f2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    cot = torch.randn((shape[0], patch ** 2) + shape[2:], generator=g,
                      device="cuda").to(dtype)
    first = correlation._spatial_corr_bwd_cuda(f1, f2, cot, patch, dil)
    second = correlation._spatial_corr_bwd_cuda(f1, f2, cot, patch, dil)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_spatial_corr_wrappers_count_launches_and_reject_bad_input(cuda):
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    x = torch.randn((1, 8, 12, 20), device="cuda")
    y = torch.randn((1, 8, 12, 20), device="cuda")
    before = dict(ops.LAUNCH_COUNTS)

    def launched(k):
        return ops.LAUNCH_COUNTS[k] - before.get(k, 0)

    out = ops.spatial_correlation(x, y, 9)
    assert launched("spatial_corr_fwd") == 1 and out.shape == (1, 81, 12, 20)
    # mixed dtypes run in the common one and come back in f1's
    assert ops.spatial_correlation(x.bfloat16(), y, 9).dtype == torch.bfloat16
    # with autograd: one forward and one backward launch; only the wanted
    # gradient is computed
    a = x.clone().requires_grad_()
    ops.spatial_correlation(a, y, 9, dilation_patch=2).sum().backward()
    assert launched("spatial_corr_fwd") == 3 and launched("spatial_corr_bwd") == 1
    df1, df2 = corr._spatial_corr_bwd_cuda(
        x, y, torch.ones((1, 81, 12, 20), device="cuda"), 9, 2,
        want=(True, False))
    assert df2 is None and torch.allclose(df1, a.grad, rtol=0, atol=1e-5)
    for bad in (lambda: corr._spatial_corr_fwd_cuda(x, y, 4, 1),
                lambda: corr._spatial_corr_fwd_cuda(x, y, 9, 0),
                lambda: corr._spatial_corr_fwd_cuda(x.double(), y.double(), 9, 1),
                lambda: corr._spatial_corr_fwd_cuda(x, y.bfloat16(), 9, 1),
                lambda: corr._spatial_corr_fwd_cuda(x, y[:, :4], 9, 1),
                lambda: corr._spatial_corr_fwd_cuda(x, y.cpu(), 9, 1),
                lambda: corr._spatial_corr_fwd_cuda(x, y.transpose(2, 3), 9, 1),
                lambda: corr._spatial_corr_bwd_cuda(
                    x, y, torch.ones((1, 80, 12, 20), device="cuda"), 9, 1),
                lambda: corr._spatial_corr_bwd_cuda(
                    x, y, torch.ones((1, 81, 12, 20), device="cuda",
                                     dtype=torch.bfloat16), 9, 1)):
        with pytest.raises((TypeError, ValueError)):
            bad()
    with pytest.raises(NotImplementedError):
        ops.spatial_correlation(x, y, 9, padding=1)
    assert launched("spatial_corr_fwd") == 3 and launched("spatial_corr_bwd") == 2


@pytest.mark.parametrize("name,launches", [
    ("FlowNetC", 1), ("FlowNetCFlexLarger_k3_reps3", 1),
    ("FlowNetC_larger_field", 1), ("FlowNetS", 0), ("PWCNet", 5)])
def test_models_launch_spatial_corr_and_match_plain(cuda, name, launches):
    """A forward correlates through the kernel (once for the FlowNetC
    family, once per level for PWC-Net, never for FlowNetS); the flow
    matches the model's with the plain correlation (f32 with TF32 off:
    1e-5 relative L2; PWC-Net mixed: the 1 % bar)."""
    model = fetch_model(name, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((2, 128, 256, 3), generator=g, device="cuda")
    b = torch.rand((2, 128, 256, 3), generator=g, device="cuda")
    before = ops.LAUNCH_COUNTS["spatial_corr_fwd"]
    flow = predict_flow(model, a, b)
    assert ops.LAUNCH_COUNTS["spatial_corr_fwd"] == before + launches
    assert flow.shape == (2, 128, 256, 2) and bool(torch.isfinite(flow).all())
    if not launches:
        return
    model.module.plain_corr = True
    plain = predict_flow(model, a, b)
    assert ops.LAUNCH_COUNTS["spatial_corr_fwd"] == before + launches
    if getattr(model.module, "mixed_precision", False):
        epe = torch.linalg.vector_norm(flow - plain, dim=-1).mean()
        assert (epe / torch.linalg.vector_norm(plain, dim=-1).mean()) < 1e-2
    else:
        assert ((flow - plain).norm() / plain.norm()).item() <= 1e-5


def test_flownetc_patch_iteration_launches_kernels_and_matches_plain(cuda):
    """One inner patch-attack iteration on FlowNetC (f32, TF32 off): one
    launch of each correlation kernel, none with the plain correlation; the
    canvas update (0.5 lr (g_tgt + g_ref), clamped) within the image
    gradient's bound against the plain correlation's (chip_smoke.py phase
    15: 2e-3 relative L2), the loss within the flows' 1e-5."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PatchAttackConfig,
        make_patch_attack_step,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        predict_flow_differentiable,
    )

    model = fetch_model("FlowNetC", device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((1, 128, 256, 3), generator=g, device="cuda")
    b = torch.rand((1, 128, 256, 3), generator=g, device="cuda")
    mask = torch.zeros_like(a)
    mask[:, 32:80, 96:144] = 1.0
    patch = torch.rand(a.shape, generator=g, device="cuda") * mask
    target = -1.0 * predict_flow(model, a, b)
    step = make_patch_attack_step(
        lambda x, y: predict_flow_differentiable(model, x, y),
        PatchAttackConfig(max_count=1, loss_threshold=0.0, l2=True))
    outs = []
    for plain in (False, True):
        model.module.plain_corr = plain
        before = [ops.LAUNCH_COUNTS[k] for k in ("spatial_corr_fwd",
                                                 "spatial_corr_bwd")]
        outs.append(step(a, b, patch, mask, patch, target))
        after = [ops.LAUNCH_COUNTS[k] for k in ("spatial_corr_fwd",
                                                "spatial_corr_bwd")]
        assert [y - x for x, y in zip(before, after)] == (
            [0, 0] if plain else [1, 1])
    (adv, _, new, loss, count), (padv, _, pnew, ploss, pcount) = outs
    assert count == pcount == 1
    assert bool(torch.isfinite(new).all()) and bool(torch.isfinite(loss))
    assert torch.equal(adv * (1 - mask), a * (1 - mask))
    assert 0.0 <= adv.min().item() and adv.max().item() <= 1.0
    upd, pupd = new - patch, pnew - patch
    assert pupd.abs().max().item() > 0
    assert ((upd - pupd).norm() / pupd.norm()).item() <= 2e-3
    assert abs(loss.item() - ploss.item()) <= 1e-5 * abs(ploss.item())
