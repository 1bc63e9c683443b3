#!/usr/bin/env python3
"""Where a RAFT-12 forward of the PyTorch port spends device time.

    python3 scripts/torch_raft_profile.py [--batch 8] [--iters 12]

Runs ``predict_flow`` of the port's "RAFT" (seeded random weights, mixed
precision) on one CUDA device at 384x1280, at the calibrated
(``scale_flow_head(0.05)``) and the wild operating point, and traces two
forwards of each with ``torch.profiler``.  Prints, per operating point, the
wall time per forward, the device-busy time and idle share, device time by
kernel class (the correlation lookup kernel, convolutions, norms, the
rest), and the top kernels.  Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = (
    ("alt_corr_fwd (lookup kernel)", re.compile(r"alt_corr_fwd")),
    ("convolution", re.compile(r"conv|xmma|cudnn|implicit|gemm|sm90|cutlass|winograd|fft", re.I)),
    ("norm", re.compile(r"norm|welford|bn_", re.I)),
)


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def profile_point(model, a, b, reps: int = 2) -> None:
    from torch.profiler import ProfilerActivity, profile

    from understanding_flow_robustness_tpu_torch.models import predict_flow

    for _ in range(2):
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            predict_flow(model, a, b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    # device activity only: kernels, not the host ops that launched them
    # nor the profiler's "Command Buffer Full" marker
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and not e.key.startswith(("cuda", "aten", "Command Buffer"))]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / reps
    print(f"  wall {wall_ms:.2f} ms/forward (under the profiler), device busy "
          f"{busy_ms:.2f} ms, idle share {100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%")
    by_class: dict = {}
    for e in kernels:
        name = next((c for c, rx in CLASSES if rx.search(e.key)), "elementwise/other")
        by_class[name] = by_class.get(name, 0.0) + _device_us(e) / 1e3 / reps
    for name, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {name:32s} {ms:8.2f} ms  {100 * ms / busy_ms:5.1f}%")
    print("  top kernels (ms/forward, calls/forward):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
        print(f"    {_device_us(e) / 1e3 / reps:8.3f}  {e.count // reps:5d}  {e.key[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        scale_flow_head,
    )

    print("gpu:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    wild = fetch_model("RAFT", device="cuda", seed=0, iters=args.iters)
    cal = FlowModel("RAFT", scale_flow_head(wild.module, 0.05), wild.device)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((args.batch, 384, 1280, 3), generator=g, device="cuda")
    b = torch.rand((args.batch, 384, 1280, 3), generator=g, device="cuda")
    for name, model in (("calibrated", cal), ("wild", wild)):
        print(f"== {name}: RAFT-{args.iters}, batch {args.batch}, 384x1280, bf16 autocast ==")
        profile_point(model, a, b)


if __name__ == "__main__":
    main()
