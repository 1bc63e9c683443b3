#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA device and prints its name and power limit.
2. Builds the CUDA kernels from ``understanding_flow_robustness_tpu_torch/
   csrc/`` (into ``build/torch_kernels/``, one nvcc per source, all at
   once) and prints the build times and the ptxas reports.
3. Holds the lookup kernel ``alt_corr_fwd`` against its plain PyTorch
   version on the card, at the serving path's shape and at a ragged shape,
   in f32 and bf16, for calibrated, wild and out-of-volume centres; times
   both at the serving shape.
4. Holds the backward kernel ``alt_corr_bwd`` against the plain backward
   the same way, at the train path's shape and the ragged one; times both
   at the train shape.
5. Holds the warp kernel ``warp_fwd`` against its plain version in its
   three modes, f32 and bf16, at SPyNet's and PWC-Net's largest warp
   shapes and a ragged one, for smooth, wild and +-1e30 flows; times it,
   the plain version and ``F.grid_sample`` at the two main shapes.
6. Serving path: RAFT-12 (seeded random weights) serving 3 requests of 8
   frame pairs at 384x1280 through ``predict_flow``, at the calibrated
   (``scale_flow_head(0.05)``) and the wild (raw init) operating point;
   checks shapes, finiteness and that every forward launched the lookup
   kernel 12 times; compares the flow with the plain lookup; times pairs/s.
7. Serving path: SPyNet (f32) and PWC-Net (mixed precision) serving 3
   requests of 8 pairs at 384x1280 each; checks 6 and 4 warp launches per
   request, the flow against the model with the plain warp (and PWC-Net in
   f32 too); times pairs/s.
8. Train path: RAFT-12 in mixed precision taking 2 + 5 AdamW/OneCycle
   steps at batch 4, 288x960 through ``make_train_step``; checks finite
   losses, moved parameters and 12 launches of each kernel per step; times
   frames/s and reads the peak memory.
9. The parameter gradients of one train-mode backward with the kernels
   against those with the plain lookup, in f32 and in bf16.
10. The train CLI with ``--synthetic 3``, then its resume.

Any failed check raises, so the script exits non-zero and prints no result.
The last three lines are the card's name and power limit, a JSON object per
kernel (its launches on the main paths, its error against its plain
version, its time, the plain version's, the least time the card could take
and what bounds it, and the time of a PyTorch call that computes the same
function where there is one) and the result object.  TF32 is off
throughout, so f32 convolutions run in full f32.
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

B, H, W = 8, 384, 1280
REQUESTS = 3
ITERS = 12
RADIUS, LEVELS = 4, 4
TB, TH, TW = 4, 288, 960  # the train step's geometry (bench.py:281-321)
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
KERNELS = ("alt_corr_fwd", "alt_corr_bwd", "warp_fwd")
TRAIN_KERNELS = ("alt_corr_fwd", "alt_corr_bwd")  # RAFT's train step
F32_TOL = 1e-4           # abs, the JAX package's bar (test_ops_correlation.py:327)
BF16_REL_TOL = 1e-5      # x max|corr|: same bf16 inputs, both accumulate in f32
# x max|grad|, f32 and bf16 alike: both sides sum the same products of the
# same inputs in f32, in other orders (the kernel's df2 atomics land in an
# order that changes from run to run)
BWD_REL_TOL = 1e-5
# relative L2 of the parameter gradients, kernels vs plain lookup, one
# train-mode backward: (worst tensor, all parameters together).  Both paths
# read the same values and keep the lookup's gradient f32, but they sum in
# other orders, so their forward trajectories part a little over the 12
# iterations (the serving phase's flows: ~1e-4 px in f32, 0.2 % of the
# flow in bf16, where the autocast convolutions round each difference),
# and the gradients of the early encoder layers grow that most.  Measured
# on an H100: f32 5.3e-4 worst, 4.1e-6 together; bf16 5.0e-2 worst, 3.2e-2
# median, 6.3e-4 together.  A wrong or missing gradient is off by O(1).
# The biases of the encoders' convolutions that feed a norm are left out:
# the norm removes a bias, so their gradient is zero and what they get is
# rounding noise
GRAD_F32_REL_L2 = (2e-3, 5e-5)
GRAD_BF16_REL_L2 = (0.15, 5e-3)
NORMED_BIAS = re.compile(r"net\.(conv1|layer\d\.\d\.(conv\d|downsample\.0))"
                         r"\.bias$")
F32_FLOW_TOL_PX = 1e-2   # max abs flow difference, kernel vs plain lookup, f32
BF16_REL_EPE_TOL = 0.01  # mean EPE / mean |flow|, the 1% bar (BASELINE.md)
CAL_BAND = (5.0, 40.0)   # trained-checkpoint mean |flow| band (bench.py:115)
# sanity bounds of the calibrated magnitude (tests/test_bf16_drift.py:120):
# the random draw decides where in or near CAL_BAND it lands
CAL_SANITY = (1.0, 60.0)
WARP_F32_REL_TOL = 1e-5  # x max|img|: the same coordinates, f32 weights
# the warp shapes of the serving paths (B, C, H, W): SPyNet's finest level
# (f32, mode "spynet") and PWC-Net's level 2 (bf16, mode "zeros_mask")
WARP_MAIN = {"spynet": ((B, 3, H, W), torch.float32),
             "zeros_mask": ((B, 32, H // 4, W // 4), torch.bfloat16)}
FLOW_F32_TOL_PX = 1e-3   # max |dflow|, warp kernel vs plain warp, f32 models
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s of HBM3 and
# FLOP/s by input type (bf16 on the tensor cores, f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes that
    must move (each input read once, each output written once) over the
    HBM rate and the operations over the peak rate of the inputs' type."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lookup_cases(gen, main_shape):
    """(name, b, h, w, c, coords) for the kernel-vs-plain phases: the main
    path's feature shape and a ragged one whose pooled levels drop rows and
    columns, each with calibrated, wild and hand-placed edge centres."""
    from understanding_flow_robustness_tpu_torch.ops import coords_grid

    for shape_name, (b, h, w, c) in (("main", main_shape),
                                     ("ragged", (2, 13, 21, 64))):
        grid = coords_grid(h, w, device="cuda")[None].expand(b, h, w, 2)
        noise = torch.randn((b, h, w, 2), generator=gen, device="cuda")
        edge = grid + noise
        edge[0, 0, :4] = torch.tensor(
            [[-50.0, -50.0], [500.0, 500.0], [-3.5, -3.5],
             [w - 0.25, h - 0.25]], device="cuda")
        edge[0, 1, :3] = torch.tensor(
            [[-1e30, 3.0], [3.0, 1e30], [w - 1.0, h - 1.0]], device="cuda")
        for coords_name, coords in (("calibrated", grid + 2.0 * noise),
                                    ("wild", grid + 150.0 * noise),
                                    ("edge", edge)):
            yield f"{shape_name}/{coords_name}", b, h, w, c, coords


def kernel_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print("== alt_corr_fwd vs plain (TF32 off) ==", flush=True)
    res = {}
    for name, b, h, w, c, coords in lookup_cases(gen, (B, H // 8, W // 8, 256)):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        cflat = coords.reshape(b, h * w, 2).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            got = corr.alt_corr_lookup(f1, levels, cflat, RADIUS)
            ref = corr.alt_corr_lookup_reference(f1, levels, cflat, RADIUS)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_REL_TOL * scale
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            print(f"{tag:32s} max_abs_err={err:.3e} tol={tol:.3e} "
                  f"max|corr|={scale:.3f}", flush=True)
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"{tag}: kernel output malformed")
            check(err <= tol, f"{tag}: kernel disagrees with plain version")
            res[tag] = err
            if name.startswith("main/calibrated") or name == "main/wild":
                k_ms = cuda_ms(lambda: corr.alt_corr_lookup(
                    f1, levels, cflat, RADIUS), reps=20)
                res[f"{tag}/ms"] = k_ms
                if name == "main/calibrated":
                    p_ms = cuda_ms(lambda: corr.alt_corr_lookup_reference(
                        f1, levels, cflat, RADIUS), reps=5, warmup=1)
                    res[f"{tag}/plain_ms"] = p_ms
                    # per query and level: the (2r+2)^2 integer-grid dots
                    # of length C, a multiply-add each
                    flops = 2 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                    res[f"{tag}/bound"] = bound(
                        nbytes(f1, *levels, cflat, got), flops, dtype)
                    print(f"{tag:32s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                          "per lookup (4 levels)", flush=True)
                else:
                    print(f"{tag:32s} kernel {k_ms:.3f} ms per lookup",
                          flush=True)
            del got, ref
    return res


def backward_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print("== alt_corr_bwd vs plain backward (TF32 off) ==", flush=True)
    res = {}
    n2 = (2 * RADIUS + 1) ** 2
    for name, b, h, w, c, coords in lookup_cases(gen, (TB, TH // 8, TW // 8, 256)):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        cflat = coords.reshape(b, h * w, 2).contiguous()
        g = torch.randn((b, h * w, LEVELS * n2), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            got = corr._alt_corr_bwd_cuda(f1, levels, cflat, g, RADIUS)
            ref = corr.alt_corr_lookup_backward_reference(f1, levels, cflat, g,
                                                          RADIUS)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            worst = 0.0
            for part, k, r in [("df1", got[0], ref[0])] + [
                    (f"dlevels[{lvl}]", k, r)
                    for lvl, (k, r) in enumerate(zip(got[1], ref[1]))]:
                check(k.shape == r.shape and k.dtype == torch.float32
                      and bool(torch.isfinite(k).all()),
                      f"{tag} {part}: kernel output malformed")
                err = (k - r).abs().max().item()
                scale = r.abs().max().item()
                tol = BWD_REL_TOL * scale
                print(f"{tag:28s} {part:11s} max_abs_err={err:.3e} "
                      f"tol={tol:.3e} max|grad|={scale:.3f}", flush=True)
                check(err <= tol, f"{tag} {part}: kernel disagrees with the "
                                  "plain backward")
                worst = max(worst, err)
            res[tag] = worst
            if tag == "main/calibrated/bfloat16":
                k_ms = cuda_ms(lambda: corr._alt_corr_bwd_cuda(
                    f1, levels, cflat, g, RADIUS), reps=10)
                p_ms = cuda_ms(lambda: corr.alt_corr_lookup_backward_reference(
                    f1, levels, cflat, g, RADIUS), reps=2, warmup=0)
                res[f"{tag}/ms"], res[f"{tag}/plain_ms"] = k_ms, p_ms
                # per query and level: the (2r+2)^2 grid points' df1 and
                # df2 products of length C, a multiply-add each
                flops = 4 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                res[f"{tag}/bound"] = bound(
                    nbytes(f1, *levels, cflat, g, got[0], *got[1]), flops,
                    dtype)
                print(f"{tag:28s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                      "per backward (4 levels)", flush=True)
            del got, ref
    return res


def flow_stats(a: torch.Tensor, b: torch.Tensor):
    """(max abs difference, mean EPE / mean |b|) of two (..., 2) flows."""
    epe = torch.linalg.vector_norm(a - b, dim=-1).mean()
    mag = torch.linalg.vector_norm(b, dim=-1).mean()
    return (a - b).abs().max().item(), (epe / mag).item()


def model_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== RAFT-12 slice ==", flush=True)
    res = {}
    wild = fetch_model("RAFT", device="cuda", seed=0)
    cal = FlowModel("RAFT", scale_flow_head(wild.module, 0.05), wild.device)
    points = {"calibrated": cal, "wild": wild}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]

    # the main path: count the kernel's launches while serving
    flows = {}
    LAUNCH_COUNTS.clear()
    for point, model in points.items():
        for i, (a, b) in enumerate(requests):
            before = LAUNCH_COUNTS["alt_corr_fwd"]
            flow = predict_flow(model, a, b)
            torch.cuda.synchronize()
            check(tuple(flow.shape) == (B, H, W, 2),
                  f"{point} request {i}: flow shape {tuple(flow.shape)}")
            check(bool(torch.isfinite(flow).all()),
                  f"{point} request {i}: non-finite flow")
            check(LAUNCH_COUNTS["alt_corr_fwd"] - before == ITERS,
                  f"{point} request {i}: kernel launched "
                  f"{LAUNCH_COUNTS['alt_corr_fwd'] - before} times, not {ITERS}")
            flows[point, i] = flow
    res["launches"] = LAUNCH_COUNTS["alt_corr_fwd"]
    print(f"kernel launches while serving {len(points)}x{REQUESTS} requests: "
          f"{res['launches']} ({ITERS} per request)", flush=True)
    for point in points:
        mag = torch.stack([torch.linalg.vector_norm(flows[point, i], dim=-1).mean()
                           for i in range(REQUESTS)]).mean().item()
        res[f"{point}/mean_flow_px"] = mag
        print(f"{point}: mean |flow| = {mag:.3f} px", flush=True)
    cal_px = res["calibrated/mean_flow_px"]
    print(f"calibrated mean |flow| {'inside' if CAL_BAND[0] <= cal_px <= CAL_BAND[1] else 'outside'}"
          f" the {CAL_BAND} px band of trained checkpoints", flush=True)
    check(CAL_SANITY[0] < cal_px < CAL_SANITY[1],
          f"calibrated mean |flow| {cal_px:.3f} px outside {CAL_SANITY}")

    # the kernel against the plain lookup, end to end
    a, b = requests[0]
    for point, model in points.items():
        model.module.plain_lookup = True
        plain = predict_flow(model, a, b)
        model.module.plain_lookup = False
        mx, rel = flow_stats(flows[point, 0], plain)
        res[f"bf16/{point}/max_abs_px"], res[f"bf16/{point}/rel_epe"] = mx, rel
        print(f"bf16 {point}: kernel vs plain lookup max|dflow|={mx:.3e} px, "
              f"rel EPE={100 * rel:.4f}%", flush=True)
    check(res["bf16/calibrated/rel_epe"] <= BF16_REL_EPE_TOL,
          "bf16 calibrated: kernel vs plain lookup beyond the 1% bar")
    m32 = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", device="cuda", seed=0)
    m32 = FlowModel(m32.name, scale_flow_head(m32.module, 0.05), m32.device)
    got = predict_flow(m32, a, b)
    m32.module.plain_lookup = True
    plain = predict_flow(m32, a, b)
    mx, rel = flow_stats(got, plain)
    res["f32/calibrated/max_abs_px"] = mx
    print(f"f32 calibrated (TF32 off): kernel vs plain lookup "
          f"max|dflow|={mx:.3e} px (tol {F32_FLOW_TOL_PX}), "
          f"rel EPE={100 * rel:.6f}%", flush=True)
    check(mx <= F32_FLOW_TOL_PX, "f32: kernel vs plain lookup beyond bound")
    del m32, got, plain

    # steady-state throughput
    for point, model in points.items():
        for a, b in requests[:2]:
            predict_flow(model, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for _ in range(2):
            for a, b in requests:
                predict_flow(model, a, b)
                n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[f"{point}/pairs_per_s"] = B * n / dt
        print(f"{point}: {B * n / dt:.2f} pairs/s ({1e3 * dt / n:.1f} ms per "
              f"request of {B} pairs, {n} requests)", flush=True)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each f32 value (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def warp_flow(gen, b, h, w, kind):
    flow = torch.randn((b, 2, h, w), generator=gen, device="cuda")
    if kind == "smooth":  # a smooth field: x4 bilinear upsample of noise
        coarse = 3.0 * torch.randn((b, 2, h // 4 + 1, w // 4 + 1),
                                   generator=gen, device="cuda")
        return torch.nn.functional.interpolate(
            coarse, size=(h, w), mode="bilinear", align_corners=False)
    if kind == "wild":
        return 150.0 * flow
    far = torch.rand((b, 2, h, w), generator=gen, device="cuda") < 0.3
    return torch.where(far, torch.sign(flow) * 1e30, 3.0 * flow)


def grid_sample_call(img, flow, mode):
    """F.grid_sample on the warp's sample grid, for its time: the mode's
    normalised grid (align_corners=False), built once outside the timing.
    It computes the warp for "border" and "spynet"; for "zeros_mask" it
    leaves out the mask, and a bf16 image needs a bf16 grid, which rounds
    the coordinates."""
    from understanding_flow_robustness_tpu_torch.ops.interp import (
        warp_sample_coords,
    )

    x, y, _ = warp_sample_coords(flow, mode)
    h, w = img.shape[2:]
    grid = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1], dim=-1)
    grid = grid.to(img.dtype)
    pad = "border" if mode == "border" else "zeros"
    return lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode=pad, align_corners=False)


def warp_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch import ops

    print("== warp_fwd vs plain ==", flush=True)
    res = {}
    shapes = {"spynet": WARP_MAIN["spynet"][0],
              "pwc": WARP_MAIN["zeros_mask"][0], "ragged": (2, 5, 13, 21)}
    for shape_name, (b, c, h, w) in shapes.items():
        img32 = torch.rand((b, c, h, w), generator=gen, device="cuda")
        for kind in ("smooth", "wild", "far"):
            flow = warp_flow(gen, b, h, w, kind)
            for mode in ("border", "zeros_mask", "spynet"):
                for dtype in (torch.float32, torch.bfloat16):
                    img = img32.to(dtype)
                    got = ops.warp_backward(img, flow, mode)
                    # bf16: the plain version's f32 sample of the same
                    # bf16 values, before its rounding
                    ref = ops.warp_backward_reference(img.float(), flow, mode)
                    torch.cuda.synchronize()
                    tag = (f"{shape_name}/{kind}/{mode}/"
                           f"{str(dtype).split('.')[-1]}")
                    check(got.shape == img.shape and got.dtype == dtype
                          and not bool(torch.isnan(got).any()),
                          f"{tag}: kernel output malformed")
                    err = (got.float() - ref).abs()
                    if dtype == torch.float32:
                        tol = WARP_F32_REL_TOL * img32.abs().max().item()
                        ok = err.max().item() <= tol
                        bar = f"tol={tol:.1e}"
                    else:
                        ok = bool((err <= bf16_ulp(ref)).all())
                        bar = "tol=1 bf16 ulp"
                    print(f"{tag:38s} max_abs_err={err.max().item():.3e} "
                          f"{bar}", flush=True)
                    check(ok, f"{tag}: kernel disagrees with plain version")
                    res[tag] = err.max().item()
                    if WARP_MAIN.get(mode) == ((b, c, h, w), dtype) \
                            and kind == "smooth":
                        k_ms = cuda_ms(lambda: ops.warp_backward(
                            img, flow, mode), reps=50)
                        p_ms = cuda_ms(lambda: ops.warp_backward_reference(
                            img, flow, mode), reps=10)
                        l_ms = cuda_ms(grid_sample_call(img, flow, mode),
                                       reps=50)
                        res[f"{mode}/main"] = {
                            "tag": tag, "max_abs_err": err.max().item(),
                            "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                            # 4 taps per channel, a multiply-add each
                            **bound(nbytes(img, flow, got),
                                    8 * b * c * h * w, dtype)}
                        print(f"{tag:38s} kernel {k_ms:.4f} ms, plain "
                              f"{p_ms:.4f} ms, grid_sample {l_ms:.4f} ms, "
                              f"bound {res[f'{mode}/main']['bound_ms']:.4f} ms"
                              f" ({res[f'{mode}/main']['bound_by']})",
                              flush=True)
                    del got, ref
            del flow
    return res


def warp_model_phase(gen, name: str, warps: int) -> dict:
    """``name`` serving REQUESTS requests of B pairs at HxW through
    ``predict_flow``, each warp through the kernel; then the same model
    with the plain warp, and pairs/s."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    model = fetch_model(name, device="cuda", seed=0)
    mixed = getattr(model.module, "mixed_precision", False)
    print(f"== {name} serving, batch {B} at {H}x{W}, "
          f"{'bf16 mixed' if mixed else 'f32'} ==", flush=True)
    res = {}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]

    # the main path: count the kernel's launches while serving
    flows = []
    LAUNCH_COUNTS.clear()
    for i, (a, b) in enumerate(requests):
        before = LAUNCH_COUNTS["warp_fwd"]
        flow = predict_flow(model, a, b)
        torch.cuda.synchronize()
        n = LAUNCH_COUNTS["warp_fwd"] - before
        check(tuple(flow.shape) == (B, H, W, 2),
              f"{name} request {i}: flow shape {tuple(flow.shape)}")
        check(bool(torch.isfinite(flow).all()),
              f"{name} request {i}: non-finite flow")
        check(n == warps, f"{name} request {i}: warp_fwd launched {n} times, "
                          f"not {warps}")
        flows.append(flow)
    res["launches"] = LAUNCH_COUNTS["warp_fwd"]
    res["mean_flow_px"] = torch.stack(
        [torch.linalg.vector_norm(f, dim=-1).mean() for f in flows]
    ).mean().item()
    print(f"warp_fwd launches while serving {REQUESTS} requests: "
          f"{res['launches']} ({warps} per request); mean |flow| "
          f"{res['mean_flow_px']:.3f} px", flush=True)

    # the kernel against the plain warp, end to end
    a, b = requests[0]
    points = [(model, flows[0], mixed)]
    if mixed:  # PWC-Net's f32 configuration as well
        m32 = fetch_model(name, device="cuda", seed=0, mixed_precision=False)
        points.append((m32, predict_flow(m32, a, b), False))
    for m, got, bf16 in points:
        m.module.plain_warp = True
        plain = predict_flow(m, a, b)
        m.module.plain_warp = False
        mx, rel = flow_stats(got, plain)
        key = "bf16" if bf16 else "f32"
        res[f"{key}/max_abs_px"], res[f"{key}/rel_epe"] = mx, rel
        bar = (f"rel EPE bound {100 * BF16_REL_EPE_TOL:g}%" if bf16
               else f"max bound {FLOW_F32_TOL_PX} px")
        print(f"{key}: warp kernel vs plain warp max|dflow|={mx:.3e} px, "
              f"rel EPE={100 * rel:.5f}% ({bar})", flush=True)
        check(rel <= BF16_REL_EPE_TOL if bf16 else mx <= FLOW_F32_TOL_PX,
              f"{name} {key}: warp kernel vs plain warp beyond bound")
    del points

    # steady-state throughput
    for a, b in requests[:2]:
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in range(2):
        for a, b in requests:
            predict_flow(model, a, b)
            n += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res["pairs_per_s"] = B * n / dt
    print(f"{name}: {B * n / dt:.2f} pairs/s ({1e3 * dt / n:.1f} ms per "
          f"request of {B} pairs, {n} requests)", flush=True)
    return res


def train_batch(gen, b: int) -> dict:
    return {"image1": torch.rand((b, TH, TW, 3), generator=gen, device="cuda"),
            "image2": torch.rand((b, TH, TW, 3), generator=gen, device="cuda"),
            "flow": torch.randn((b, TH, TW, 2), generator=gen, device="cuda"),
            "valid": torch.ones((b, TH, TW), device="cuda")}


def train_phase(gen) -> dict:
    """The JAX package's bench train step (bench.py:281-321) on the card."""
    from understanding_flow_robustness_tpu_torch.models import fetch_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import (
        fetch_optimizer,
        make_train_step,
    )

    print(f"== RAFT-12 train step, batch {TB} at {TH}x{TW}, bf16 ==",
          flush=True)
    model = fetch_model("RAFT", device="cuda", seed=0)
    params = list(model.module.parameters())
    optimizer, scheduler = fetch_optimizer(params, lr=1e-4, num_steps=1000)
    step = make_train_step(model.module, optimizer, scheduler, is_raft=True)
    batches = [train_batch(gen, TB) for _ in range(2)]
    start = [p.detach().clone() for p in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while training
    LAUNCH_COUNTS.clear()
    losses = []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(LAUNCH_COUNTS)
        losses.append(step(batches[i % 2])["loss"])
        for k in TRAIN_KERNELS:
            n = LAUNCH_COUNTS[k] - before.get(k, 0)
            check(n == ITERS, f"train step {i}: {k} launched {n} times, "
                              f"not {ITERS}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {f"launches/{k}": LAUNCH_COUNTS[k] for k in TRAIN_KERNELS}
    print(f"kernel launches while training {TRAIN_WARMUP + TRAIN_STEPS} "
          f"steps: " + ", ".join(f"{k} {LAUNCH_COUNTS[k]}" for k in TRAIN_KERNELS)
          + f" ({ITERS} each per step)", flush=True)
    print("losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    check(all(torch.isfinite(torch.tensor(losses)).tolist()),
          "non-finite train loss")
    moved = sum(not torch.equal(p, q) for p, q in zip(params, start))
    check(moved == len(params), f"only {moved} of {len(params)} parameter "
                                "tensors moved")
    res["frames_per_s"] = TB * TRAIN_STEPS / dt
    res["ms_per_step"] = 1e3 * dt / TRAIN_STEPS
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train: {res['frames_per_s']:.2f} frames/s, "
          f"{res['ms_per_step']:.1f} ms per step of {TB} frames "
          f"({TRAIN_STEPS} timed steps), peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    return res


def grad_phase(gen) -> dict:
    """One train-mode backward through the kernels against one through the
    plain lookup on a deep copy, same model and batch, calibrated point."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.training import sequence_loss

    print("== parameter gradients, kernels vs plain lookup ==", flush=True)
    res = {}
    batch = train_batch(gen, TB)
    for name, dtype, bound in (
            ("RAFT_adv_kitti2012_ifgsm_l2_002", "f32", GRAD_F32_REL_L2),
            ("RAFT", "bf16", GRAD_BF16_REL_L2)):
        kernel = scale_flow_head(
            fetch_model(name, device="cuda", seed=0).module, 0.05).train()
        plain = copy.deepcopy(kernel)
        plain.plain_lookup = True
        for module in (kernel, plain):
            preds = module(batch["image1"].permute(0, 3, 1, 2) * 255.0,
                           batch["image2"].permute(0, 3, 1, 2) * 255.0,
                           test_mode=False)
            loss, _ = sequence_loss([p.permute(0, 2, 3, 1) for p in preds],
                                    batch["flow"], batch["valid"])
            loss.backward()
        grads = [{n: p.grad for n, p in m.named_parameters()
                  if not NORMED_BIAS.search(n)} for m in (kernel, plain)]
        rels = sorted(((grads[0][n] - q).norm().item() / q.norm().item(), n)
                      for n, q in grads[1].items())
        total = math.sqrt(sum(((grads[0][n] - q) ** 2).sum().item()
                              for n, q in grads[1].items())
                          / sum((q ** 2).sum().item()
                                for q in grads[1].values()))
        res[f"{dtype}/worst_rel_l2"], res[f"{dtype}/total_rel_l2"] = \
            rels[-1][0], total
        print(f"{dtype} ({name}): per-tensor rel L2, worst three "
              + ", ".join(f"{r:.3e} ({n})" for r, n in rels[:-4:-1])
              + f"; median {rels[len(rels) // 2][0]:.3e} (bound "
              f"{bound[0]:g}); all parameters {total:.3e} (bound "
              f"{bound[1]:g}); {len(rels)} tensors", flush=True)
        check(rels[-1][0] <= bound[0] and total <= bound[1],
              f"{dtype}: gradients with the kernels beyond bound of the "
              "plain lookup's")
        del kernel, plain
    return res


def cli_phase() -> dict:
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train

    print("== train CLI ==", flush=True)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--synthetic", "3", "--num_steps", "2", "--batch_size", "2",
            "--image_size", str(TH), str(TW), "--mixed_precision",
            "--name", "smoke", "--checkpoint_dir", str(ckpt)]
    out = cli_train.main(argv)
    check(out["total_steps"] == 3 and len(out["history"]) == 3,
          f"CLI took {out['total_steps']} batches, not 3")
    check(all(torch.isfinite(torch.tensor(m["loss"])).item()
              for m in out["history"]), "CLI: non-finite loss")
    for f in ("checkpoint.pth", "smoke.pth", "args.json"):
        check((ckpt / "smoke" / f).exists(), f"CLI wrote no {f}")
    again = cli_train.main(argv)
    check(again["total_steps"] == 3 and again["history"] == [],
          "CLI resume did not return as fully trained")
    print("CLI: 3 batches, checkpoint and weights written; the rerun resumed "
          "as fully trained without a step", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"final_loss": out["history"][-1]["loss"]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: torch.cuda.is_available() is False")
    from understanding_flow_robustness_tpu_torch.ops import _build

    # f32 comparisons in full f32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_libraries(KERNELS)
    for k in KERNELS:
        _build.load_library(k)
    print(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s, "
          "in parallel (nvcc "
          + ", ".join(f"{k} {_build.BUILD_SECONDS.get(k, 0.0):.2f} s"
                      for k in KERNELS) + ")", flush=True)
    for k in KERNELS:
        print(_build.library_path(k).with_suffix(".log").read_text().strip(),
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"-- phase {fn.__name__}{args[1:]} took "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        return out

    kres = phase(kernel_phase, gen)
    bres = phase(backward_phase, gen)
    wres = phase(warp_phase, gen)
    mres = phase(model_phase, gen)
    sres = phase(warp_model_phase, gen, "SpyNet", 6)
    pres = phase(warp_model_phase, gen, "PWCNet", 4)
    tres = phase(train_phase, gen)
    phase(grad_phase, gen)
    phase(cli_phase)
    print(f"all phases, build included: {time.perf_counter() - t0:.1f} s",
          flush=True)

    print(card)  # name, power limit: nvidia-smi's own line
    fwd = "main/calibrated/bfloat16"
    warp = wres["spynet/main"]
    print(json.dumps({"kernels": [{
        "name": "alt_corr_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:91",
        "launches": mres["launches"] + tres["launches/alt_corr_fwd"],
        "max_abs_err": kres[fwd],
        "ms": kres[f"{fwd}/ms"],
        "plain_ms": kres[f"{fwd}/plain_ms"],
        **kres[f"{fwd}/bound"],
        "library_ms": None,
    }, {
        "name": "alt_corr_bwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_bwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:571",
        "launches": tres["launches/alt_corr_bwd"],
        "max_abs_err": bres[fwd],
        "ms": bres[f"{fwd}/ms"],
        "plain_ms": bres[f"{fwd}/plain_ms"],
        **bres[f"{fwd}/bound"],
        "library_ms": None,
    }, {
        "name": "warp_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/warp_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/warp_tile.py:53",
        "launches": sres["launches"] + pres["launches"],
        "max_abs_err": warp["max_abs_err"],
        "ms": warp["ms"],
        "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"],
        "bound_by": warp["bound_by"],
        "library_ms": warp["library_ms"],
        "grid_sample_ms": warp["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
