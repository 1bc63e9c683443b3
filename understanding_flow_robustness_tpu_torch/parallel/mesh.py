"""Data parallelism, one process per device (counterpart of
``understanding_flow_robustness_tpu/parallel/mesh.py``; reference:
training/train.py:117,126-127, ``torch.nn.DataParallel``).

The JAX package shards the batch over a ``Mesh``'s ``data`` axis and lets
XLA insert the collectives.  Here each device is one process (a rank),
started by :func:`launch` with the spawn start method; a rank holds the
whole model and its contiguous slice of the batch (``shard_batch``, as
``P("data")`` lays it out), and the collectives are explicit calls on the
group.  ``Mesh`` is the rank's view: its rank, the world size, its device
and the process group.

Backends, with no fallback from one to the other: NCCL when every rank has
a CUDA device of its own, gloo for CPU ranks, and gloo for CUDA ranks that
share a device only when the caller asks for ``backend="gloo"`` (NCCL
refuses two ranks on one GPU).  Outside a worker, ``make_mesh(1)`` is the
one-device mesh: no group, and every collective is the identity.

``make_2d_mesh(n_data, n_spatial)`` lays the ranks of a launch out as the
JAX package's ``("data", "spatial")`` mesh (parallel/spatial.py:43-54):
the ``Mesh`` it returns keeps ``rank``, ``world`` and ``group`` on the data
axis, so every data-parallel helper here shards over it, and adds the
spatial axis (``spatial_rank``, ``n_spatial``, ``spatial_group``) and the
group of the whole grid (``grid_group``) for ``parallel/spatial.py``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

# gradient buckets of the all-reduce: flat buffers of at most this many
# elements (64 MB of f32)
BUCKET_ELEMENTS = 1 << 24


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel group.  ``group`` is None on
    the one-device mesh, where collectives do nothing.  On a 2-D mesh
    (``make_2d_mesh``) ``rank``, ``world`` and ``group`` are the data
    axis's; ``spatial_rank`` of ``n_spatial`` is the rank's row block,
    ``spatial_group`` the ranks that share its batch slice (None when
    ``n_spatial`` is 1) and ``grid_group`` every rank of the mesh (None on
    one device)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    backend: Optional[str] = None
    spatial_rank: int = 0
    n_spatial: int = 1
    spatial_group: Any = None
    grid_group: Any = None


_CURRENT: Optional[Mesh] = None
# the 2-D meshes this worker has made, by (n_data, n_spatial): their groups
# are made once, by every rank in the same order
_GRIDS: dict = {}


def current_mesh() -> Optional[Mesh]:
    """The mesh of the worker this process runs, None outside one."""
    return _CURRENT


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[str] = None) -> Mesh:
    """Inside a worker of :func:`launch`: its mesh (``n_devices``, when
    given, must be its world size).  Outside one: the one-device mesh on
    ``device`` (the card unless asked for ``cpu``); more devices need
    ``launch``."""
    if _CURRENT is not None:
        if n_devices not in (None, _CURRENT.world):
            raise ValueError(f"make_mesh({n_devices}) inside a worker of a "
                             f"{_CURRENT.world}-rank launch")
        return _CURRENT
    if n_devices not in (None, 1):
        raise ValueError(
            f"make_mesh({n_devices}): a mesh of more than one device is one "
            "process per device; start them with parallel.launch")
    return Mesh(device=torch.device(device or "cuda"))


def make_2d_mesh(n_data: int, n_spatial: int,
                 device: Optional[str] = None) -> Mesh:
    """The ``(data, spatial)`` mesh of a worker of :func:`launch` with
    ``n_data * n_spatial`` ranks (the JAX package's ``make_2d_mesh``,
    parallel/spatial.py:43-54): rank r holds batch slice r // n_spatial
    and row block r % n_spatial.  The data groups (the ranks of one row
    block) and the spatial groups (the ranks of one batch slice) are made
    with ``dist.new_group``, in the same order on every rank, once a
    worker.  Outside a worker: the 1 x 1 mesh on ``device`` (the card
    unless asked for ``cpu``).  Raises when the launch has too few ranks,
    as JAX's raises with too few devices, or more than the mesh holds."""
    n = n_data * n_spatial
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"make_2d_mesh({n_data}, {n_spatial}): each axis "
                         "needs at least one rank")
    have = 1 if _CURRENT is None else _CURRENT.world
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    if have > n:
        raise ValueError(f"make_2d_mesh({n_data}, {n_spatial}) inside a "
                         f"worker of a {have}-rank launch: a mesh takes "
                         "every rank")
    if _CURRENT is None:
        return Mesh(device=torch.device(device or "cuda"))
    key = (n_data, n_spatial)
    if key not in _GRIDS:
        r = _CURRENT.rank
        d, s = divmod(r, n_spatial)
        data_groups = [dist.new_group([i * n_spatial + j
                                       for i in range(n_data)])
                       for j in range(n_spatial)]
        spatial_groups = [dist.new_group([i * n_spatial + j
                                          for j in range(n_spatial)])
                          for i in range(n_data)]
        _GRIDS[key] = Mesh(
            rank=d, world=n_data, device=_CURRENT.device,
            group=data_groups[s] if n_data > 1 else None,
            backend=_CURRENT.backend, spatial_rank=s, n_spatial=n_spatial,
            spatial_group=spatial_groups[d] if n_spatial > 1 else None,
            grid_group=_CURRENT.group)
    return _GRIDS[key]


def _check_devices(n: int, device: str, backend: Optional[str],
                   devices: Optional[Sequence[int]]) -> tuple:
    """(backend, device indices) for ``launch``, or the refusal."""
    if n < 1:
        raise ValueError(f"launch needs at least one rank, got {n}")
    if device == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"CPU ranks take the gloo backend, not {backend!r}")
        return backend, [None] * n
    if device != "cuda":
        raise ValueError(f"launch runs ranks on 'cuda' or 'cpu', not {device!r}")
    have = torch.cuda.device_count()
    if devices is None:
        if n > have:
            raise ValueError(
                f"{n} CUDA ranks asked for, but this machine has {have} "
                f"CUDA device(s): one rank per device (or pass devices= and "
                f"backend='gloo' to share one)")
        devices = list(range(n))
    devices = [int(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"devices={devices} names {len(devices)} devices "
                         f"for {n} ranks")
    if any(not 0 <= d < have for d in devices):
        raise ValueError(f"devices={devices}: this machine has {have} CUDA "
                         "device(s)")
    shared = len(set(devices)) < n
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if shared and backend == "nccl":
        raise ValueError(
            f"devices={devices}: NCCL refuses two ranks on one GPU; pass "
            "backend='gloo' to share a device")
    return backend, devices


def _worker(rank: int, fn: Callable, n: int, device: str,
            devices: list, backend: str, store: str, result: str,
            threads: int, args: tuple) -> None:
    global _CURRENT
    if device == "cuda":
        torch.cuda.set_device(devices[rank])
        dev = torch.device("cuda", devices[rank])
    else:
        torch.set_num_threads(threads)
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n)
    _CURRENT = Mesh(rank, n, dev, dist.group.WORLD, backend)
    try:
        out = fn(_CURRENT, *args)
        if rank == 0:
            torch.save(out, result)
        dist.barrier()
    except BaseException:
        # when and how this rank failed: a rank that waits in a collective
        # fails next, when the first one's connections close
        with open(f"{store}.error{rank}", "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        _CURRENT = None
        _GRIDS.clear()
    dist.destroy_process_group()


def _first_failure(store: str, n: int, exc: Exception) -> str:
    """The message of the rank that failed first (the earliest error file
    a rank wrote), else of the exception ``join`` raised."""
    failures = []
    for rank in range(n):
        path = f"{store}.error{rank}"
        if os.path.exists(path):
            with open(path) as f:
                when, tb = f.read().split("\n", 1)
            failures.append((float(when), rank, tb))
    if not failures:
        return f"rank {exc.error_index} of {n} failed:\n{exc}"
    _, rank, tb = min(failures)
    return f"rank {rank} of {n} raised:\n{tb}"


class RankFailed(RuntimeError):
    """A rank of :func:`launch` raised or died; the message carries its
    traceback."""


def launch(fn: Callable, n_devices: int, *args, device: str = "cuda",
           backend: Optional[str] = None,
           devices: Optional[Sequence[int]] = None,
           timeout: Optional[float] = None) -> Any:
    """Run ``fn(mesh, *args)`` in ``n_devices`` spawned ranks and return
    rank 0's result.

    ``device`` is ``"cuda"`` (rank r on ``devices[r]``, by default on
    device r; more ranks than devices raise) or ``"cpu"``.  Each rank sets
    its CUDA device before any CUDA work and joins the group through a
    ``file://`` store in a fresh temporary directory.  CPU ranks split the
    caller's torch threads between them.  ``fn`` and ``args`` must pickle
    (``fn`` at module level).  If any rank raises, the others are stopped
    and ``RankFailed`` is raised with that rank's traceback; so it is when
    ``timeout`` seconds pass first."""
    backend, devices = _check_devices(n_devices, device, backend, devices)
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="ufr_launch_")
    store, result = os.path.join(tmp, "store"), os.path.join(tmp, "result")
    threads = max(1, torch.get_num_threads() // n_devices)
    ranks = mp.start_processes(
        _worker, nprocs=n_devices, join=False, start_method="spawn",
        args=(fn, n_devices, device, devices, backend, store, result,
              threads, args))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        try:
            while not ranks.join(None if deadline is None else max(
                    deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise RankFailed(f"{n_devices} ranks still running "
                                     f"after {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RankFailed(_first_failure(store, n_devices, e)) from None
        return torch.load(result, weights_only=False)
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ collectives

def _group(mesh: Optional[Mesh]):
    return None if mesh is None else mesh.group


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, in place (no autograd)."""
    if _group(mesh) is not None:
        dist.all_reduce(x, group=mesh.group)
    return x


def all_reduce_mean(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, in place: the sum, then / world."""
    if _group(mesh) is not None:
        dist.all_reduce(x, group=mesh.group)
        x.div_(mesh.world)
    return x


def all_reduce_bf16_mean(mesh: Optional[Mesh],
                         x: torch.Tensor) -> torch.Tensor:
    """JAX's ``pmean(x.astype(bf16)).astype(f32)``: ``x`` cast to bf16,
    summed over the ranks in bf16, divided by the world size in bf16 and
    cast back to ``x``'s dtype (a new tensor).  On one device: ``x``
    rounded to bf16."""
    y = x.to(torch.bfloat16)
    all_reduce_mean(mesh, y)
    return y.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks with its gradient: the cotangent of the sum
    is every rank's, so the backward sums the cotangents over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum_grad(mesh: Optional[Mesh],
                        x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (every rank must run
    the backward, as it ran the forward)."""
    if _group(mesh) is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def reduce_gradients(mesh: Optional[Mesh], params, mode: str) -> int:
    """All-reduce the gradients of ``params`` in flat buckets, in place:
    ``"sum"``, ``"mean"``, or ``"bf16_mean"`` (the bf16 transport: see
    ``all_reduce_bf16_mean``; on one device it rounds them to bf16).
    Returns the bytes each rank sends into the all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if mode not in ("sum", "mean", "bf16_mean"):
        raise ValueError(f"unknown gradient reduction {mode!r}")
    if _group(mesh) is None and mode != "bf16_mean":
        return 0
    sent = 0
    bucket: list = []
    size = 0

    def flush():
        nonlocal sent
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        if mode == "bf16_mean":
            flat = all_reduce_bf16_mean(mesh, flat)
            sent += flat.numel() * 2
        else:
            sent += flat.numel() * flat.element_size()
            if mode == "sum":
                all_reduce_sum(mesh, flat)
            else:
                all_reduce_mean(mesh, flat)
        for g, part in zip(bucket, torch.split(flat, [g.numel()
                                                      for g in bucket])):
            g.copy_(part.view_as(g))
        bucket.clear()

    for g in grads:
        if size + g.numel() > BUCKET_ELEMENTS or (bucket and
                                                  g.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel()
    flush()
    return sent


def all_gather(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along the leading
    axis in rank order: the global batch of per-rank slices."""
    if _group(mesh) is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def gather_objects(mesh: Optional[Mesh], obj: Any) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if _group(mesh) is None:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def broadcast_object(mesh: Optional[Mesh], obj: Any) -> Any:
    """Rank 0's picklable ``obj`` on every rank."""
    if _group(mesh) is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    if _group(mesh) is not None:
        dist.barrier(group=mesh.group)


def is_rank0(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.rank == 0


# --------------------------------------------------------------- sharding

def _slice(mesh: Mesh, x):
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not divide over "
                         f"{mesh.world} devices")
    k = n // mesh.world
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def shard_batch(mesh: Optional[Mesh], batch: Any) -> Any:
    """This rank's contiguous slice of the leading axis of every tensor or
    array in ``batch`` (a dict, list, tuple or one of them), as
    ``P("data")`` shards it; raises when a batch does not divide."""
    if mesh is None or mesh.world == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return _slice(mesh, batch)


def replicate(mesh: Optional[Mesh], module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    if _group(mesh) is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def shard_predict(predict: Callable, mesh: Optional[Mesh]) -> Callable:
    """Data-parallel inference: ``run(img1, img2)`` on the global batch
    predicts this rank's slice with ``predict(a, b)`` and all-gathers the
    flow back into global batch order (the JAX package's ``shard_predict``;
    the reference's ``DataParallel`` evaluation, training/evaluate.py:410).
    """

    def run(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        a, b = shard_batch(mesh, (img1, img2))
        return all_gather(mesh, predict(a, b))

    return run
