"""The port's shard-aware operations (``parallel/spatial.py`` and the ops
and layers that read its context) against their unsharded selves, forward
and gradient, on four gloo CPU ranks as a 1 x 4 ``data x spatial`` mesh:
every conv geometry the zoo uses, the deconv, instance and group norm,
the bilinear resize in both modes, RAFT's convex-upsample unfold, the
spatial correlation at (21, 2) and (9, 1), the warp in its three modes,
and RAFT's alt, volume and spatial-correlation lookups.  The blocks are
smaller than the reach: 8-row blocks of 32 rows (FlowNetC's correlation
reaches 20 rows) and 2-row blocks of 8 (a 7x7 conv reaches 3), so halos
span several ranks.  The same launch holds the refusals; the rest runs
in this process: JAX's height rule and message, the warp's and the
correlation's row offsets and the lookup kernels' query grid.
"""

import numpy as np
import pytest
import torch
import torch_spatial_workers as workers

from understanding_flow_robustness_tpu.parallel import (
    check_spatial_shapes as jcheck_spatial_shapes,
    make_2d_mesh as jmake_2d_mesh,
)
from understanding_flow_robustness_tpu_torch import ops, parallel
from understanding_flow_robustness_tpu_torch.models import fetch_model
from understanding_flow_robustness_tpu_torch.models.layers import (
    GlobalBatchNorm2d,
)
from understanding_flow_robustness_tpu_torch.ops import correlation
from understanding_flow_robustness_tpu_torch.ops.interp import (
    warp_sample_coords,
)
from understanding_flow_robustness_tpu_torch.parallel import spatial

N_SPATIAL = 4
HEIGHTS = (32, 8)  # 8-row and 2-row blocks
B, W = 2, 12
# max |sharded - unsharded| / max |unsharded|, output and gradients: f32
# sums in other orders (measured <= 6.5e-7); the convs' outputs, the
# correlation, the warp and the lookups' outputs measured bit-equal
OP_REL = 1e-5
LAUNCH_TIMEOUT = 600  # s


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tier-1 runs six test processes at once; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cases(H: int) -> dict:
    """{operation: (inputs [(array, layout, wants a gradient)], output
    cotangent)} at height H."""
    rng = np.random.RandomState(H)

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    def nchw(*shape):
        return (f(*shape), "nchw", True)

    out = {}
    for name, (_, _, s, _) in workers.CONVS.items():
        if (H // N_SPATIAL) % s == 0:
            out[name] = ([nchw(B, 4, H, W)], f(B, 3, H // s, W // s))
    out["deconv"] = ([nchw(B, 4, H, W)], f(B, 3, 2 * H, 2 * W))
    for name in ("instance_norm", "group_norm"):
        out[name] = ([nchw(B, 4, H, W)], f(B, 4, H, W))
    for name, k in (("resize_x2_edges", 2), ("resize_x4_edges", 4),
                    ("resize_x8_corners", 8)):
        out[name] = ([nchw(B, 2, H, W)], f(B, 2, k * H, k * W))
    out["unfold"] = ([nchw(B, 2, H, W), nchw(B, 576, H, W)],
                     f(B, 2, 8 * H, 8 * W))
    for name, planes in (("corr21", 441), ("corr21_plain", 441),
                         ("corr9", 81)):
        out[name] = ([nchw(B, 8, H, W), nchw(B, 8, H, W)], f(B, planes, H, W))
    for mode in workers.WARP_MODES:
        out[f"warp/{mode}"] = ([nchw(B, 3, H, W), (3 * f(B, 2, H, W), "nchw",
                                                  True)], f(B, 3, H, W))
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)[None]
    coords = (grid + 2 * f(B, H, W, 2)).astype(np.float32)
    for name in ("lookup_alt", "lookup_volume"):
        out[name] = ([(f(B, H, W, 16), "nhwc", True),
                      (f(B, H, W, 16), "nhwc", True),
                      (coords, "nhwc", False)], f(B, 3 * 49, H, W))
    # RAFT's spatial-correlation lookup of a (B, 441, H, W) map, 3 levels
    out["spatial_lookup"] = ([nchw(B, 441, H, W)], f(B, 3 * 441, H, W))
    return out


CASES = {f"h{H}/{name}": (name, *case) for H in HEIGHTS
         for name, case in _cases(H).items()}


@pytest.fixture(scope="module")
def sharded():
    return parallel.launch(workers.op_suite, N_SPATIAL, (1, N_SPATIAL),
                           CASES, device="cpu", timeout=LAUNCH_TIMEOUT)


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.mark.parametrize("key", list(CASES))
def test_operation_matches_unsharded(sharded, key):
    """Output and input gradients of the blocks, gathered, against the
    operation on the whole maps."""
    ref_out, ref_grads = workers.op_case(None, *CASES[key])
    out, grads = sharded["ops"][key]
    assert out.shape == ref_out.shape
    assert _rel(out, ref_out) <= OP_REL
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape and _rel(g, r) <= OP_REL


def test_warp_and_correlation_blocks_bit_equal(sharded):
    """The warp's sample coordinates of a block are the whole warp's, bit
    for bit, so are its rows; the halo'd correlation computes each output
    from the same products in the same order; the spatial-correlation
    lookup pools and reshapes the gathered map's values as the unsharded
    one does."""
    for H in HEIGHTS:
        for name in (*(f"warp/{m}" for m in workers.WARP_MODES), "corr21",
                     "corr9", "spatial_lookup"):
            key = f"h{H}/{name}"
            ref_out, _ = workers.op_case(None, *CASES[key])
            np.testing.assert_array_equal(sharded["ops"][key][0], ref_out)


def test_refusals(sharded):
    """On the mesh: a mesh larger than the launch, an unknown windowed
    module in ``spatial_shard`` and a module never made shard-aware run
    under the context all raise a ValueError saying why.  (Every RAFT
    configuration shards: tests/test_torch_spatial_models.py and
    test_torch_spatial_zoo.py.)"""
    got = sharded["refusals"]
    assert got["make_2d_mesh"] == f"need {N_SPATIAL ** 2} devices, have " \
                                  f"{N_SPATIAL}"
    assert "MaxPool2d is not known to be shard-aware" in got["spatial_shard"]
    assert "Conv2d is not known to be shard-aware" in \
        got["unsharded_module"]


def test_check_spatial_shapes_as_jax():
    """192 rows over 4 row blocks: JAX's rule, JAX's message."""
    img = np.zeros((2, 192, 128, 3), np.float32)
    with pytest.raises(ValueError, match="spatial axis") as port:
        spatial.check_spatial_shapes(parallel.Mesh(n_spatial=4), img)
    with pytest.raises(ValueError) as jax_err:
        jcheck_spatial_shapes(jmake_2d_mesh(2, 4), img)
    assert str(port.value) == str(jax_err.value)
    spatial.check_spatial_shapes(parallel.Mesh(n_spatial=4),
                                 np.zeros((2, 256, 128, 3)))
    run = parallel.spatial_predict(fetch_model("FlowNetS", device="cpu"),
                                   parallel.Mesh(n_spatial=4))
    with pytest.raises(ValueError, match="spatial axis"):
        run(torch.zeros(2, 48, 128, 3), torch.zeros(2, 48, 128, 3))


def test_make_2d_mesh_outside_a_worker():
    """Outside a worker only the 1 x 1 mesh exists, as JAX's raises with
    too few devices."""
    mesh = parallel.make_2d_mesh(1, 1, device="cpu")
    assert (mesh.world, mesh.n_spatial, mesh.grid_group) == (1, 1, None)
    with pytest.raises(ValueError, match="need 16 devices, have 1"):
        parallel.make_2d_mesh(4, 4, device="cpu")


def test_spatial_shard_refuses_and_keeps_state():
    """``spatial_shard`` swaps the classes of the convs and norms in place
    (the same parameters and state dict), leaves eval-mode batch norm,
    refuses a training one and an unknown module, changing nothing."""
    module = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                                 torch.nn.BatchNorm2d(4),
                                 torch.nn.ConvTranspose2d(4, 2, 4, 2, 1),
                                 torch.nn.InstanceNorm2d(2),
                                 torch.nn.GroupNorm(1, 2)).eval()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    params = [id(p) for p in module.parameters()]
    x = torch.randn(1, 3, 8, 8)
    ref = module(x)
    two = parallel.Mesh(n_spatial=2)
    assert parallel.spatial_shard(module, parallel.Mesh()) is module
    assert type(module[0]) is torch.nn.Conv2d  # one row block: unchanged
    parallel.spatial_shard(module, two)
    assert [type(m).__name__ for m in module] == [
        "SpatialConv2d", "BatchNorm2d", "SpatialConvTranspose2d",
        "SpatialInstanceNorm2d", "SpatialGroupNorm"]
    assert [id(p) for p in module.parameters()] == params
    assert module.state_dict().keys() == before.keys()
    torch.testing.assert_close(module(x), ref, rtol=0, atol=0)
    bn = torch.nn.Sequential(GlobalBatchNorm2d(4))
    with pytest.raises(ValueError, match="training GlobalBatchNorm2d"):
        parallel.spatial_shard(bn, two)
    mixed = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 1), torch.nn.Upsample(
        scale_factor=2))
    with pytest.raises(ValueError, match="Upsample is not known"):
        parallel.spatial_shard(mixed, two)
    assert type(mixed[0]) is torch.nn.Conv2d


def test_warp_row_offset_bit_equal():
    """The plain warp of each row block with its row offset against the
    whole source is the block's rows of the whole warp, bit for bit, in
    each mode (csrc/warp_fwd.cu computes the same coordinates:
    tests/test_torch_cuda.py holds it on the card)."""
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.rand(2, 5, 16, 12).astype(np.float32))
    flow = (4 * rng.randn(2, 2, 16, 12)).astype(np.float32)
    for mode in workers.WARP_MODES:
        blocks = [ops.warp_backward_reference(
            img, torch.from_numpy(flow[:, :, r:r + 4]), mode, row0=r)
            for r in range(0, 16, 4)]
        ref = ops.warp_backward_reference(img, torch.from_numpy(flow), mode)
        assert torch.equal(torch.cat(blocks, 2), ref)
    x, y, _ = warp_sample_coords(torch.from_numpy(flow[:, :, 4:8]),
                                 "zeros_mask", 4, 16)
    rx, ry, _ = warp_sample_coords(torch.from_numpy(flow), "zeros_mask")
    assert torch.equal(x, rx[:, 4:8]) and torch.equal(y, ry[:, 4:8])


@pytest.mark.parametrize("patch,dil", [(21, 2), (9, 1)])
def test_correlation_row_offset_matches_unsharded(patch, dil):
    """The plain correlation of each row block of f1 against its f2 with a
    halo of the whole reach at the row offset r*d is the block's rows of
    the unsharded plain correlation; df1 is the block's rows of the
    unsharded df1, and df2 (halo rows included) the unsharded df2 of a
    cotangent that is zero off the block, on the rows inside the image.
    Held at OP_REL: PyTorch's CPU channel sum takes an order that depends
    on the map's size (csrc/spatial_corr_{fwd,bwd}.cu do not, and
    tests/test_torch_cuda.py holds them bit-equal on the card)."""
    rng = np.random.RandomState(3)
    H, h = 48, 12
    f1 = torch.from_numpy(rng.randn(B, 8, H, W).astype(np.float32))
    f2 = torch.from_numpy(rng.randn(B, 8, H, W).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, patch * patch, H, W).astype(
        np.float32))
    reach = (patch - 1) // 2 * dil
    f2p = torch.nn.functional.pad(f2, (0, 0, reach, reach))

    def corr(a, b, row0, cot):
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = ops.spatial_correlation_reference(a, b, patch, dil, row0)
        return (out.detach(), *torch.autograd.grad(out, (a, b), cot))

    whole = corr(f1, f2, 0, g)
    for i in range(H // h):
        rows = slice(i * h, (i + 1) * h)
        out, df1, df2 = corr(f1[:, :, rows], f2p[:, :, i * h:i * h + h
                                                 + 2 * reach], reach,
                             g[:, :, rows])
        assert out.shape == (B, patch * patch, h, W)
        assert _rel(out.numpy(), whole[0][:, :, rows].numpy()) <= OP_REL
        assert _rel(df1.numpy(), whole[1][:, :, rows].numpy()) <= OP_REL
        masked = torch.zeros_like(g)
        masked[:, :, rows] = g[:, :, rows]
        ref = torch.nn.functional.pad(corr(f1, f2, 0, masked)[2],
                                      (0, 0, reach, reach))
        inside = slice(max(reach - i * h, 0), min(h + 2 * reach,
                                                  H + reach - i * h))
        assert df2.shape == (B, 8, h + 2 * reach, W)
        assert _rel(df2[:, :, inside].numpy(),
                    ref[:, :, i * h:i * h + h + 2 * reach][:, :,
                                                          inside].numpy()) \
            <= OP_REL
    # unsharded (row offset 0, f2 of f1's height) it is the plain version
    # it was: f2 given f1's zero rows as a halo changes nothing
    zero_halo = corr(f1, f2p, reach, g)
    for a, b in zip(zero_halo[:2], whole[:2]):
        assert torch.equal(a, b)


def test_lookup_query_grid_of_a_row_block(monkeypatch):
    """A row block's queries against the whole level 0: the lookup kernels
    cut the block's (H1 / n_spatial, W1) grid into tiles, not one row of
    its queries (the grid changes no value: any grid gives the same
    result); queries that are not whole rows stay one row."""
    levels = [torch.zeros((2, 48, 160, 8)), torch.zeros((2, 24, 80, 8))]
    assert correlation._query_grid(levels, 48 * 160) == (48, 160)
    assert correlation._query_grid(levels, 24 * 160) == (24, 160)
    assert correlation._query_grid(levels, 100) == (1, 100)
    import test_torch_ops

    calls = test_torch_ops._fake_forward_launch(monkeypatch)
    f1 = torch.zeros((2, 12 * 160, 16))
    lv = [torch.zeros((2, 48, 160, 16)), torch.zeros((2, 24, 80, 16))]
    correlation._alt_corr_lookup_cuda(f1, lv, torch.zeros((2, 12 * 160, 2)),
                                      4)
    correlation._alt_corr_bwd_cuda(f1, lv, torch.zeros((2, 12 * 160, 2)),
                                   torch.zeros((2, 12 * 160, 162)), 4)
    assert calls[0][7:9] == (12, 160) and calls[1][9:11] == (12, 160)
