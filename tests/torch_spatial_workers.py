"""Rank functions of the port's spatial-sharding tests
(tests/test_torch_spatial_*.py).

``parallel.launch`` spawns each rank, which imports the function's module
anew: this one imports numpy, torch and the port only, so that a rank does
not import JAX.  A rank lays the launch out as an ``n_data x n_spatial``
mesh (``make_2d_mesh``), runs each case on its block of the global inputs
(``shard_rows``) and gathers the results (``gather_rows``); rank 0 returns
them, and the tests hold them against the same functions run unsharded in
the test process.
"""

import numpy as np
import torch

from understanding_flow_robustness_tpu_torch import ops
from understanding_flow_robustness_tpu_torch.attacks import (
    PerturbConfig,
    make_attack,
    make_spatial_attack,
)
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    predict_flow_differentiable,
)
from understanding_flow_robustness_tpu_torch.models.raft_model import (
    spatial_corr_lookup,
    spatial_corr_lookup_rows,
    upsample_flow_convex,
)
from understanding_flow_robustness_tpu_torch.parallel import (
    gather_rows,
    make_2d_mesh,
    shard_rows,
    spatial_context,
    spatial_predict,
    spatial_shard,
)

# ------------------------------------------------------------- operations

# every (kernel, stride, padding, dilation) of a conv the zoo uses along H:
# the FlowNet encoders' 7/5/3 at stride 2, the 3x3 and 1x1 convs, RAFT's
# strided 1x1 downsample, 7x7 (SPyNet, RAFT's convf1), the separable GRU's
# 1x5 / 5x1, and PWC-Net's dilated context network
CONVS = {f"conv{k}x{kw}_s{s}_d{d}": (k, kw, s, d)
         for k, kw, s, d in ((7, 7, 2, 1), (5, 5, 2, 1), (3, 3, 2, 1),
                             (3, 3, 1, 1), (1, 1, 1, 1), (1, 1, 2, 1),
                             (7, 7, 1, 1), (1, 5, 1, 1), (5, 1, 1, 1),
                             (3, 3, 1, 2), (3, 3, 1, 4), (3, 3, 1, 8),
                             (3, 3, 1, 16))}
WARP_MODES = ("border", "zeros_mask", "spynet")


def _module(name: str) -> torch.nn.Module:
    """The seeded module of an operation case."""
    torch.manual_seed(0)
    if name in CONVS:
        k, kw, s, d = CONVS[name]
        return torch.nn.Conv2d(4, 3, (k, kw), stride=s,
                               padding=(d * (k - 1) // 2, d * (kw - 1) // 2),
                               dilation=d)
    if name == "deconv":
        return torch.nn.ConvTranspose2d(4, 3, 4, stride=2, padding=1)
    if name == "instance_norm":
        return torch.nn.InstanceNorm2d(4, affine=False, eps=1e-5)
    if name == "group_norm":
        return torch.nn.GroupNorm(2, 4, eps=1e-5)
    raise KeyError(name)


def _op(name: str, x: list, mesh=None) -> torch.Tensor:
    """Operation ``name`` on its inputs ``x`` (NCHW row blocks under a
    spatial context, the whole maps outside one)."""
    if name in CONVS or name in ("deconv", "instance_norm", "group_norm"):
        module = _module(name)
        if mesh is not None:
            spatial_shard(module, mesh)
        return module(x[0])
    if name.startswith("resize"):
        _, factor, align = name.split("_")
        h, w = x[0].shape[2:]
        f = int(factor[1:])
        return ops.resize_bilinear(x[0], f * h, f * w, align == "corners")
    if name == "unfold":
        return upsample_flow_convex(x[0], x[1])
    if name.startswith("corr"):
        patch, dil = (21, 2) if name.startswith("corr21") else (9, 1)
        return ops.spatial_correlation(x[0], x[1], patch, dilation_patch=dil,
                                       plain=name.endswith("plain"))
    if name.startswith("warp"):
        return ops.warp_backward(x[0], x[1], name.split("/")[1])
    if name == "spatial_lookup":
        # RAFT's spatial-correlation lookup, 3 levels, NCHW out: on a row
        # block its rows of the whole map's (spatial_corr_lookup_rows)
        sc = x[0]
        if mesh is None:
            out = spatial_corr_lookup(ops.corr_pyramid(sc, 3), *sc.shape[2:])
        else:
            out = spatial_corr_lookup_rows(sc, 3)
        return out.permute(0, 3, 1, 2)
    if name.startswith("lookup"):
        # NHWC fmaps and level-0 coords of the block's queries
        f1, f2, coords = x
        B, h, w, _ = f1.shape
        if name == "lookup_alt":
            a, levels = ops.prepare_alt_corr(f1, f2, 3)
            out = ops.alt_corr_lookup(a, levels, coords.reshape(B, h * w, 2),
                                      3)
            return out.reshape(B, h, w, -1).permute(0, 3, 1, 2)
        pyramid = ops.volume_pyramid(f1, f2, 3)
        return ops.corr_lookup(pyramid, coords, 3).permute(0, 3, 1, 2)
    raise KeyError(name)


def op_case(mesh, name: str, inputs: list, cot: np.ndarray):
    """(output, gradients of sum(output * cot) w.r.t. the inputs that take
    one) of operation ``name`` on ``inputs`` [(array, layout, wants a
    gradient)]: on this rank's blocks under ``mesh`` and gathered, or on
    the whole inputs with ``mesh=None``."""
    xs = []
    for a, layout, grad in inputs:
        t = torch.from_numpy(a)
        if mesh is not None:
            t = shard_rows(mesh, t, layout)
        xs.append(t.clone().requires_grad_(grad))
    c = torch.from_numpy(cot)
    if mesh is not None:
        c = shard_rows(mesh, c, "nchw")
    with spatial_context(mesh):
        out = _op(name, xs, mesh)
        wrt = [t for t in xs if t.requires_grad]
        grads = torch.autograd.grad((out * c).sum(), wrt) if wrt else []
    if mesh is not None:
        out = gather_rows(mesh, out.detach(), "nchw")
        layouts = [lay for (_, lay, grad) in inputs if grad]
        grads = [gather_rows(mesh, g, lay) for g, lay in zip(grads, layouts)]
    return out.detach().numpy(), [g.numpy() for g in grads]


def op_suite(mesh, shape: tuple, cases: dict) -> dict:
    """Every operation case {key: (operation, inputs, cot)} on the
    ``shape`` = (n_data, n_spatial) mesh of this launch, then the
    refusals."""
    grid = make_2d_mesh(*shape, device="cpu")
    return {"ops": {key: op_case(grid, *case) for key, case in cases.items()},
            "refusals": refusals(mesh)}


# ----------------------------------------------------------------- models

def load_model(name: str, kw: dict, path: str):
    """Registry model ``name`` (built with ``kw``) holding the state dict
    saved at ``path``, on the CPU in eval mode: built on the meta device
    and loaded memory-mapped, so that a rank does not repeat the seeded
    initialisation (FlowNet2's 162M parameters take ~17 s of it)."""
    from understanding_flow_robustness_tpu_torch.models import registry

    spec = registry._SPECS[name]
    with torch.device("meta"):
        module = spec.build(**kw)
    module.load_state_dict(torch.load(path, mmap=True, weights_only=True),
                           strict=True, assign=True)
    return registry.FlowModel(name=name, module=module.eval(),
                              device=torch.device("cpu"),
                              is_raft=spec.is_raft,
                              size_multiple=spec.size_multiple)


def model_flows(mesh, shape: tuple, job: dict) -> dict:
    """Each model {key: (registry name, kwargs, state dict file)} through
    ``spatial_predict`` on this rank's blocks of ``job["images"]`` on the
    ``shape`` mesh, the flows gathered."""
    grid = make_2d_mesh(*shape, device="cpu")
    img1, img2 = (torch.from_numpy(x) for x in job["images"])
    out = {}
    for key, (name, kw, path) in job["models"].items():
        run = spatial_predict(load_model(name, kw, path), grid)
        flow = run(shard_rows(grid, img1), shard_rows(grid, img2))
        out[key] = gather_rows(grid, flow).numpy()
    return out


def refusals(mesh) -> dict:
    """The messages of what must raise on a 1 x n mesh: too many ranks
    asked for, an unknown windowed module, a module never made
    shard-aware."""
    n = mesh.world
    grid = make_2d_mesh(1, n, device="cpu")
    out = {}

    def caught(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    out["make_2d_mesh"] = caught(lambda: make_2d_mesh(n, n, device="cpu"))
    pool = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 3, padding=1),
                               torch.nn.MaxPool2d(2))
    out["spatial_shard"] = caught(lambda: spatial_shard(pool, grid))
    # a module that was never made shard-aware, run under the context
    raw = torch.nn.Conv2d(3, 3, 3, padding=1)
    x = shard_rows(grid, torch.zeros((1, 3, 64 * n, 64)), "nchw")

    def unsharded():
        with spatial_context(grid):
            raw(x)
    out["unsharded_module"] = caught(unsharded)
    return out


# ---------------------------------------------------------------- attacks

def spatial_attack(mesh, shape, job: dict) -> list:
    """``make_spatial_attack`` on this rank's blocks of ``job["inputs"]``
    (img0, img1, gt), the results gathered; with ``shape`` None, the
    unsharded ``make_attack`` on the whole inputs."""
    grid = None if shape is None else make_2d_mesh(*shape, device="cpu")
    model = fetch_model(job["model"], device="cpu", seed=job["seed"],
                        **job.get("kw", {}))
    cfg = PerturbConfig(**job["cfg"])
    full = [torch.from_numpy(x) for x in job["inputs"]]
    gen = torch.Generator().manual_seed(0)
    if grid is None:
        res = make_attack(lambda a, b: predict_flow_differentiable(
            model, a, b), cfg)(*full, gen)
        return [x.numpy() for x in res]
    spatial_shard(model.module, grid)
    run = make_spatial_attack(
        lambda a, b: predict_flow_differentiable(model, a, b), cfg, grid)
    res = run(*(shard_rows(grid, x) for x in full), gen)
    return [gather_rows(grid, x).numpy() for x in res]


def suite(mesh, shape, job: dict) -> dict:
    """Everything one launch runs: the models' flows (``job["models"]``),
    the attacks (``job["attacks"]``)."""
    out = {"flows": model_flows(mesh, shape, job) if "models" in job else {}}
    out["attacks"] = {k: spatial_attack(mesh, shape, a)
                      for k, a in job.get("attacks", {}).items()}
    return out

