"""Where one forward (or one attack step) of a ported model spends device
time.

    python -m understanding_flow_robustness_tpu_torch.cli.profile \\
        --model SpyNet --batch 8 --size 384 1280
    python -m understanding_flow_robustness_tpu_torch.cli.profile \\
        --model RAFT --corr_impl volume
    python -m understanding_flow_robustness_tpu_torch.cli.profile \\
        --model FlowNetC
    python -m understanding_flow_robustness_tpu_torch.cli.profile \\
        --model FlowNet2
    python -m understanding_flow_robustness_tpu_torch.cli.profile \\
        --model RAFT --attack --batch 1 --size 256 640
    python -m understanding_flow_robustness_tpu_torch.cli.profile \\
        --model RAFT --train --batch 4 --size 288 960

Serves random [0, 1] frame pairs through ``predict_flow`` of
``fetch_model(--model, seed=--seed)`` on one CUDA device, traces --reps
forwards after two warm-up forwards with ``torch.profiler``, and prints the
card's name and power limit, the wall time per forward, the device-busy
time and idle share, device time per forward by kernel class (the port's
CUDA kernels, convolutions, norms, reductions, the rest) and the top
kernels.  ``--corr_impl`` picks a RAFT model's lookup path.  ``--attack``
traces one I-FGSM step instead of a forward: a forward and a backward of
the l2 attack loss to the images (``predict_flow_differentiable``) against
a target offset from the clean flow, and the update.  ``--train`` traces
one train step of a RAFT model instead (``make_train_step``: sequence
loss, backward, clip, AdamW/OneCycle) on random frames and a ``randn``
flow with all-valid masks.  ``--patch`` traces inner iterations of the
patch attack instead (``make_patch_attack_step``, 8 iterations a call
pinned by ``loss_threshold=0``, the JAX bench's mask: a 100x100 square at
rows and columns 100:200, target = -clean flow), each a forward and a
backward to both composited images, the canvas update and the host's read
of the loss.  Only device events count: the host-side ops that launched
them carry the same time again.  Besides the idle share it prints the
largest gap between two kernels a unit (for ``--patch``, the bubble that
the loop's loss read leaves) and the host's wait in scalar reads.  TF32
stays off, as in chip_smoke.py.  Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time

import torch

CLASSES = (
    ("spatial_corr_fwd/bwd (correlation kernels)",
     re.compile(r"spatial_corr")),
    ("warp_fwd (B4 kernel)", re.compile(r"warp_fwd")),
    ("alt_corr_dcoords (B3 kernel)", re.compile(r"alt_corr_dcoords")),
    ("alt_corr_fwd/bwd (B1/B2 kernels)", re.compile(r"alt_corr")),
    ("corr_lookup_fwd (B5 kernel)", re.compile(r"corr_lookup")),
    ("convolution", re.compile(
        r"conv|xmma|cudnn|implicit|gemm|sm90|cutlass|winograd|fft", re.I)),
    ("norm", re.compile(r"norm|welford|bn_", re.I)),
    ("reduction (sums)", re.compile(r"reduce", re.I)),
)


PATCH_ITERS = 8  # inner iterations a call (bench.py:210-212)


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="SpyNet",
                   help="ported model ID, e.g. SpyNet, PWCNet, RAFT, FlowNetC, "
                        "FlowNet2")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, nargs=2, default=[384, 1280])
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--corr_impl", choices=("auto", "alt", "volume"),
                   help="a RAFT model's lookup path (default: the model's)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--attack", action="store_true",
                      help="trace one I-FGSM step (forward + backward to "
                           "the images) instead of a forward")
    mode.add_argument("--train", action="store_true",
                      help="trace one RAFT train step instead of a forward")
    mode.add_argument("--patch", action="store_true",
                      help=f"trace inner patch-attack iterations "
                           f"({PATCH_ITERS} a call) instead of a forward")
    return p


def main(argv=None) -> dict:
    """Returns {"wall_ms", "busy_ms", "idle_share", "launches",
    "largest_gap_ms", "host_wait_ms", "classes": {name: ms}} per forward
    (per attack step, train step or patch iteration with ``--attack``,
    ``--train`` or ``--patch``)."""
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..models import fetch_model, predict_flow

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("gpu:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    kw = {} if args.corr_impl is None else {"corr_impl": args.corr_impl}
    model = fetch_model(args.model, device="cuda", seed=args.seed, **kw)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    h, w = args.size
    a = torch.rand((args.batch, h, w, 3), generator=g, device="cuda")
    b = torch.rand((args.batch, h, w, 3), generator=g, device="cuda")
    unit = ("attack step" if args.attack else "train step" if args.train
            else "patch iteration" if args.patch else "forward")
    per_call = PATCH_ITERS if args.patch else 1
    print(f"== {args.model}{'' if not kw else ', corr_impl=' + args.corr_impl}"
          f", batch {args.batch}, {h}x{w}, per {unit} ==")
    if args.attack:
        from ..attacks import PerturbConfig, make_attack
        from ..models import predict_flow_differentiable

        flow = predict_flow(model, a, b)
        gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)
        attack = make_attack(
            lambda x, y: predict_flow_differentiable(model, x, y),
            PerturbConfig(perturb_method="ifgsm", flow_loss="l2", n_step=1))

        def step():
            attack(a, b, gt)
    elif args.train:
        from ..training import fetch_optimizer, make_train_step

        if not args.model.startswith("RAFT"):
            raise SystemExit("--train traces RAFT models only")
        optimizer, scheduler = fetch_optimizer(
            list(model.module.parameters()), lr=1e-4, num_steps=1000)
        train_step = make_train_step(model.module, optimizer, scheduler,
                                     is_raft=True)
        batch = {"image1": a, "image2": b,
                 "flow": torch.randn((args.batch, h, w, 2), generator=g,
                                     device="cuda"),
                 "valid": torch.ones((args.batch, h, w), device="cuda")}

        def step():
            train_step(batch)
    elif args.patch:
        from ..attacks.patch_attack import (
            PatchAttackConfig,
            make_patch_attack_step,
        )
        from ..models import predict_flow_differentiable

        mask = torch.zeros_like(a)
        mask[:, 100:200, 100:200] = 1.0
        patch = torch.rand(a.shape, generator=g, device="cuda") * mask
        target = -1.0 * predict_flow(model, a, b)
        attack = make_patch_attack_step(
            lambda x, y: predict_flow_differentiable(model, x, y),
            PatchAttackConfig(max_count=PATCH_ITERS, loss_threshold=0.0))

        def step():
            attack(a, b, patch, mask, patch, target)
    else:
        def step():
            predict_flow(model, a, b)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / (args.reps * per_call)
    n_units = args.reps * per_call
    # device activity only: kernels and copies, not the host ops that
    # launched them (an autograd Function's node, e.g.
    # _AltCorrLookupBackward, carries its kernel's device time too) nor
    # the profiler's "Command Buffer Full" marker
    def is_device(e):
        return (e.device_type == DeviceType.CUDA
                and not e.key.startswith(("cuda", "aten", "Command Buffer")))

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and is_device(e)]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / n_units
    launches = sum(e.count for e in kernels) // n_units
    idle = max(0.0, 1 - busy_ms / wall_ms)
    print(f"  wall {wall_ms:.2f} ms/{unit} (under the profiler), device "
          f"busy {busy_ms:.2f} ms in {launches} kernels and copies, idle "
          f"share {100 * idle:.1f}%")
    # the idle gaps between consecutive device events of the trace
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if is_device(e))
    gaps, end = [], spans[0][1] if spans else 0.0
    for start, stop in spans[1:]:
        gaps.append(max(0.0, start - end))
        end = max(end, stop)
    gaps.sort(reverse=True)
    host_wait_ms = sum(
        e.cpu_time_total for e in prof.key_averages()
        if e.key == "aten::_local_scalar_dense") / 1e3 / n_units
    largest = sum(gaps[:n_units]) / 1e3 / n_units
    print(f"  largest device gap {largest:.3f} ms/{unit} (mean of the "
          f"{n_units} largest), all gaps {sum(gaps) / 1e3 / n_units:.3f} "
          f"ms/{unit}; host waiting in scalar reads {host_wait_ms:.3f} "
          f"ms/{unit}")
    by_class: dict = {}
    for e in kernels:
        name = next((c for c, rx in CLASSES if rx.search(e.key)),
                    "elementwise/copies/other")
        by_class[name] = (by_class.get(name, 0.0)
                          + _device_us(e) / 1e3 / n_units)
    for name, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {name:50s} {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print(f"  top kernels (ms/{unit}, calls/{unit}):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
        print(f"    {_device_us(e) / 1e3 / n_units:8.3f}  "
              f"{e.count // n_units:5d}  {e.key[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle,
            "launches": launches, "largest_gap_ms": largest,
            "host_wait_ms": host_wait_ms, "classes": by_class}


if __name__ == "__main__":
    main()
