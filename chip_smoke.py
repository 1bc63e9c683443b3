#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA device and prints its name and power limit.
2. Builds the CUDA kernels from ``understanding_flow_robustness_tpu_torch/
   csrc/`` (into ``build/torch_kernels/``, one nvcc per source, all at
   once) and prints the build times and the ptxas reports.
3. Holds the lookup kernel ``alt_corr_fwd`` against its plain PyTorch
   version on the card, at the serving path's shape and at a ragged shape,
   in f32 and bf16, for calibrated, wild, out-of-volume and smooth centres;
   prints for each case the share of (8x8 query tile, level) pairs that
   took the kernel's tensor-core tile path and checks that both paths ran;
   times the kernel (calibrated, wild and smooth) and the plain version at
   the serving shape.
4. Holds the backward kernel ``alt_corr_bwd`` against the plain backward
   the same way, at the train path's shape, the attack path's and the
   ragged one, adding a smooth field of centres; prints for each case the
   share of (8x8 query tile, level) pairs that took the kernel's tile path
   and checks that both paths ran; times the kernel (calibrated and
   smooth) at the train and attack shapes with the bound of each, and the
   plain backward at the train shape.
4b. Drives the lookup's coordinate gradient (coords that require grad)
   through ``alt_corr_features`` at the serving shape, which launches the
   coordinate-gradient kernel ``alt_corr_dcoords`` (no model path does);
   holds the kernel against its plain version in f32 and bf16 for
   calibrated, wild, far-out (+-1e30) and exactly integer centres; times
   both.
5. Holds the warp kernel ``warp_fwd`` against its plain version in its
   three modes, f32 and bf16, at SPyNet's and PWC-Net's largest warp
   shapes and a ragged one, for smooth, wild and +-1e30 flows; times it,
   the plain version and ``F.grid_sample`` at the two main shapes and
   prints the kernel's share of its bound.
5b. Holds the volume lookup kernel ``corr_lookup_fwd`` against its plain
   version on RAFT's pyramid (f32 and bf16) at the serving shape and a
   ragged one, for calibrated, wild and hand-placed edge centres; times it,
   the plain version and the reference CorrBlock's four ``F.grid_sample``
   calls at the serving shape.
6. Serving path: RAFT-12 (seeded random weights) serving 3 requests of 8
   frame pairs at 384x1280 through ``predict_flow``, at the calibrated
   (``scale_flow_head(0.05)``) and the wild (raw init) operating point;
   checks shapes, finiteness and that every forward launched the lookup
   kernel 12 times; prints the tile-path share of ``alt_corr_fwd`` for the
   coords of a request's 12 iterations at each point; compares the flow
   with the plain lookup; times pairs/s.
6b. Serving path: RAFT-12 on its volume path (``corr_impl="volume"``),
   the same 3 requests at both operating points; checks 12 launches of
   ``corr_lookup_fwd`` and none of ``alt_corr_fwd`` per request, the flow
   against the alt path on the same weights (also in f32) and against the
   plain lookup; times pairs/s and reads the peak memory.
6c. Feature taps: RAFT-12 with ``return_features=True`` serving one
   request; checks the keys against ``get_feature_map_keys("RAFT")``, every
   shape, finiteness, and that each ``idx_corr_vol_{i}`` is the kernel's
   lookup output; times the request and reads the peak memory.
6d. Serving path: ``RAFT_FlowNetCEncoder_WoContext`` (calibrated) serving 3
   requests; checks 12 ``alt_corr_fwd`` launches per request and the flow
   against the plain lookup; times pairs/s.
7. Serving path: SPyNet (f32) and PWC-Net (mixed precision) serving 3
   requests of 8 pairs at 384x1280 each; checks 6 and 4 warp launches per
   request, the flow against the model with the plain warp (and PWC-Net in
   f32 too); times pairs/s.
8. Train path: RAFT-12 in mixed precision taking 2 + 5 AdamW/OneCycle
   steps at batch 4, 288x960 through ``make_train_step``; checks finite
   losses, moved parameters and 12 launches of each kernel per step; times
   frames/s and reads the peak memory; one more step prints the tile-path
   share of ``alt_corr_bwd`` for the coords of its 12 iterations.
9. The parameter gradients of one train-mode backward with the kernels
   against those with the plain lookup, in f32 and in bf16.
10. Attack path: I-FGSM with the attack CLI's defaults (40 steps, eps
   0.02, l2 loss) on ``fetch_model("RAFT")``, batch 1 at 256x640, against
   a target offset from the clean flow (the warm-up prints the tile-path
   share of ``alt_corr_bwd`` for the attack's coords); checks 12 launches
   of each lookup kernel per step and none of the coordinate-gradient
   kernel, the eps-ball, the image range and that the loss grew; times ms
   per step and reads the peak memory.  Then one image gradient with the
   kernels against one with the plain lookup (f32 and bf16), and one FGSM
   on PWC-Net through the warp kernel.
11. The attack CLI on RAFT with ``--perturb_method ifgsm --synthetic 2
   --n_step 3``.
12. The train CLI with ``--synthetic 3``, then its resume.

The FlowNet slice adds, after the RAFT grad phase (so that the earlier
phases' random inputs stay as they were):
13. The spatial correlation's kernels ``spatial_corr_fwd`` and
   ``spatial_corr_bwd`` against the plain version and its autograd at
   FlowNetC's serving, attack and patch shapes (f32, patch 21, dilation
   2), PWC-Net's five bf16 levels (patch 9), three ragged shapes (C = 3,
   33, 196) and the generic kernel's patches 1 and 3 (C = 40, 35); times
   of kernel, plain version and bound at FlowNetC's serving and patch
   shapes and PWC-Net's level 2 (forward) and at FlowNetC's attack and
   patch shapes and PWC-Net's level 2 (backward).
14. FlowNetC, FlowNetCFlexLarger_k3_reps3 and FlowNetS (f32) serving 3
   requests of 8 pairs at 384x1280 through ``predict_flow``: one
   ``spatial_corr_fwd`` launch per FlowNetC-family request and none for
   FlowNetS, the flow against the model with the plain correlation,
   pairs/s; then one taps request on FlowNetC (keys, shapes, the corr tap
   against the plain correlation).
15. I-FGSM with the attack CLI's defaults on FlowNetC (one launch of each
   correlation kernel per step, the eps-ball, the image range, the loss
   growing, ms per step, peak memory; the image gradient against the
   plain correlation's, with the leaky-ReLU inputs whose sign differs
   between the two forwards and both gradients' distance to an f64 one),
   and the attack CLI with its default ``--flownet``.
The patch slice adds, after the train CLI:
16. The patch attack's inner loop on FlowNetC (f32) at the JAX bench's
   geometry (batch 1 at 384x1280, a 100x100 mask at rows and columns
   100:200, target = -clean flow, 8 iterations pinned by
   ``loss_threshold=0``): one launch of each correlation kernel per
   iteration plus the clean flow's forward, the images bit-equal to the
   clean ones outside the mask and inside [0, 1], the loss falling; ms per
   inner iteration, iterations/s, peak memory; then one iteration's update
   against the plain correlation's, with phase 15's witnesses.
17. The patch CLI on FlowNetC (a 153-pixel circle, 2 epochs of 3
   synthetic 384x1280 batches, 2 inner iterations): launches, the patches'
   shape, the validation metrics; then ``test_patch`` on its patch in the
   default, ``--true_motion`` (``patch3d``) and ``--different_pos`` modes.
18. The patch CLI on RAFT (mixed precision): 12 launches of each lookup
   kernel per inner iteration, none of ``alt_corr_dcoords``.
19. The universal-perturbation CLI on FlowNetC (256x640, 2 batches of 3
   steps): one ``spatial_corr_bwd`` per step, the eps-ball, the snapshot;
   then ``run_perturb_model --universal_evaluation`` on that snapshot.
The FlowNet2, corruption and adversarial-training slice adds, after the
universal perturbation:
20. FlowNet2 (f32, seeded weights) serving 3 requests of 8 pairs at
   384x1280 through ``predict_flow``: 4 border-mode ``warp_fwd`` and 1
   ``spatial_corr_fwd`` launches per request, the flow against the same
   model with the plain warp and the plain correlation, pairs/s over
   requests 2-3, peak memory; ``warp_fwd`` in border mode at FlowNet2's
   (8, 3, 384, 1280) f32 against its plain version, timed beside the
   plain version, ``F.grid_sample`` and its bound.
21. I-FGSM with the attack CLI's defaults on that FlowNet2 at 256x640:
   per step 4 ``warp_fwd``, 1 ``spatial_corr_fwd`` and 1
   ``spatial_corr_bwd`` (the warps' gradient is the plain sampler's
   autograd), the eps-ball, the image range, the loss growing, ms per
   step, peak memory; one image gradient against the plain versions';
   then ``run_perturb_model --flownet FlowNet2 --synthetic 2 --n_step 3``.
22. ``run_perturb_model --perturb_method gaussian_noise --synthetic 2``
   on the default FlowNetC: the severity sweep 1-5 (a numpy corruption,
   which needs no cv2), one ``spatial_corr_fwd`` per forward, the
   five results folders, the noise growing with the severity.
23. The train CLI with ``--model RAFT --adversarial --synthetic 2
   --batch_size 1`` at 256x640 with 3 attack steps: (3 + 3) x 12 launches
   of ``alt_corr_fwd`` and ``alt_corr_bwd`` per batch and none of
   ``alt_corr_dcoords``, finite losses, moved parameters, the train step
   on the doubled batch, ms per batch.
PWC-Net's serving phase (7) also counts its 5 ``spatial_corr_fwd``
launches per request, holds the flow against the plain warp and the plain
correlation together, and times pairs/s with the plain correlation too, in
turns with the kernel; its FGSM (10) counts 5 launches of each correlation
kernel.

Any failed check raises, so the script exits non-zero and prints no result.
Before them, one line gives the patch step's ms per inner iteration and
iterations/s with the card, and one FlowNet2's pairs/s, its I-FGSM ms per
step and the adversarial train batch's ms.  The last three lines are the card's name and
power limit, a JSON object per
kernel (its launches on the main paths, its error against its plain
version, its time, the plain version's, the least time the card could take
and what bounds it, and the time of a PyTorch call that computes the same
function where there is one) and the result object.  TF32 is off
throughout, so f32 convolutions run in full f32.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

B, H, W = 8, 384, 1280
REQUESTS = 3
ITERS = 12
RADIUS, LEVELS = 4, 4
TB, TH, TW = 4, 288, 960  # the train step's geometry (bench.py:281-321)
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
TRAIN_KERNELS = ("alt_corr_fwd", "alt_corr_bwd")  # RAFT's train step
F32_TOL = 1e-4           # abs, the JAX package's bar (test_ops_correlation.py:327)
# corr_lookup_fwd vs its plain version, abs, f32 and bf16 pyramids alike:
# both widen the same taps to f32 and blend them in the same order, one
# rounding per product and sum, so they should agree bit for bit; the bar
# is the JAX package's (test_ops_correlation.py:267-268)
VOL_TOL = 1e-4
BF16_REL_TOL = 1e-5      # x max|corr|: same bf16 inputs, both accumulate in f32
# x max|grad|, f32 and bf16 alike: both sides sum the same products of the
# same inputs in f32, in other orders (the kernel's df2 atomics land in an
# order that changes from run to run)
BWD_REL_TOL = 1e-5
# alt_corr_dcoords vs its plain version, x max|dcoords|, f32 and bf16
# alike: both form the same dots of the same inputs in f32 (the kernel by
# lane FMAs and shuffles, the plain version by cuBLAS with TF32 off) and
# contract them with g in other orders
DCOORDS_REL_TOL = 1e-5
AB, AH, AW = 1, 256, 640  # the attack geometry (cli/run_perturb_model.py:44-45)
ATTACK_STEPS, ATTACK_EPS = 40, 0.02  # the attack CLI's defaults
ATTACK_SEED = 100  # the attack phase's images (torch_kernel_ab.py's first)
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
# spatial correlation kernels vs their plain versions, f32, x max|plain|:
# the same products of the same inputs summed in f32 in other orders.
# bf16: one bf16 ulp of the plain value (both round one f32 sum), or this
# f32 bar where a sum cancels below it
CORR_REL_TOL = 1e-5
# the correlation shapes of the main paths, (B, C, H, W), patch, dilation,
# dtype: FlowNetC serving, attacked and patch-attacked (f32), PWC-Net mixed
# levels 6..2
CORR_MAIN = {"flownetc": ((B, 256, H // 8, W // 8), 21, 2, torch.float32),
             "attack": ((1, 256, 256 // 8, 640 // 8), 21, 2, torch.float32),
             "patch": ((1, 256, 384 // 8, 1280 // 8), 21, 2, torch.float32)}
CORR_PWC = {f"pwc_l{lvl}": ((B, c, H >> lvl, W >> lvl), 9, 1, torch.bfloat16)
            for lvl, c in ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))}
CORR_RAGGED = {"ragged_c3": ((2, 3, 13, 21), 21, 2, torch.float32),
               "ragged_c33": ((2, 33, 37, 45), 9, 1, torch.bfloat16),
               "ragged_c196": ((1, 196, 7, 9), 21, 2, torch.bfloat16),
               # the generic kernel: P = 1 (the op's default) and 3, C > 16
               "p1_c40": ((2, 40, 13, 37), 1, 1, torch.float32),
               "p3_c35": ((2, 35, 19, 45), 3, 1, torch.bfloat16)}
# models with the correlation kernel vs the same with its plain version,
# f32 with TF32 off, relative L2 of the flows: summation order only
FLOW_F32_REL_L2 = 1e-5
# FlowNet-family serving: (ID, spatial_corr_fwd launches per request)
FLOWNETS = (("FlowNetC", 1), ("FlowNetCFlexLarger_k3_reps3", 1),
            ("FlowNetS", 0))
# the patch step: the JAX bench's geometry (bench.py:200-230): batch 1 at
# 384x1280, a 100x100 mask at rows and columns 100:200, 8 inner iterations
# pinned by loss_threshold=0; its images from a generator of its own
PB, PH, PW = 1, 384, 1280
PATCH_ITERS = 8
PATCH_SEED = 200
# the patch and universal CLIs' outputs, under the ignored build/
PATCH_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_patch"
# FlowNet2 (f32, TF32 off) with the warp and correlation kernels against
# the same with their plain versions, relative L2 of the flows: the
# correlation's sums in another order, carried through the cascade's four
# warps (the CPU parity with the JAX package: 1.2e-5 at 64x128,
# tests/test_torch_flownet2.py)
FLOWNET2_REL_L2 = 1e-4
# FlowNet2's image gradient with the kernels against the plain versions',
# relative L2: four chained warps make it jump where a sample coordinate
# crosses an integer; on the CPU a 1e-6 relative change of the input moves
# it by 2.3 % (tests/test_torch_flownet2.py)
FLOWNET2_GRAD_REL_L2 = 5e-2
# warp_fwd in border mode at FlowNet2's warp shape (B, C, H, W) f32
WARP_FLOWNET2 = (B, 3, H, W)
# the adversarial train CLI's batches: batch 1 at the attack geometry,
# 3 I-FGSM steps, 2 batches of INNER updates
ADV_TRAIN_STEPS, ADV_TRAIN_BATCHES, ADV_INNER = 3, 2, 3
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


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn()``: ``reps`` calls captured in one CUDA graph
    and replayed between CUDA events, so that the host's cost of each call
    (a Python wrapper's checks, the ctypes call: tens of us, as long as a
    small warp) stays out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, reps=1, warmup=0) / reps


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


def lookup_cases(gen, main_shape, more_shapes=(), smooth=False,
                 main="main", ragged=True):
    """(name, b, h, w, c, coords) for the kernel-vs-plain phases: the main
    path's feature shape (named ``main``), ``more_shapes`` ((name, (b, h,
    w, c)), ...) and with ``ragged`` a ragged one whose pooled levels drop
    rows and columns, each with calibrated (2 px of noise on every
    centre), wild and hand-placed edge centres, and with ``smooth`` a
    smooth field (``warp_flow``'s)."""
    from understanding_flow_robustness_tpu_torch.ops import coords_grid

    shapes = ((main, main_shape), *more_shapes)
    if ragged:
        shapes += (("ragged", (2, 13, 21, 64)),)
    for shape_name, (b, h, w, c) in shapes:
        grid = coords_grid(h, w, device="cuda")[None].expand(b, h, w, 2)
        noise = torch.randn((b, h, w, 2), generator=gen, device="cuda")
        edge = grid + noise
        edge[0, 0, :4] = torch.tensor(
            [[-50.0, -50.0], [500.0, 500.0], [-3.5, -3.5],
             [w - 0.25, h - 0.25]], device="cuda")
        edge[0, 1, :3] = torch.tensor(
            [[-1e30, 3.0], [3.0, 1e30], [w - 1.0, h - 1.0]], device="cuda")
        cases = [("calibrated", grid + 2.0 * noise),
                 ("wild", grid + 150.0 * noise), ("edge", edge)]
        if smooth:
            field = warp_flow(gen, b, h, w, "smooth").permute(0, 2, 3, 1)
            cases.append(("smooth", grid + field))
        for coords_name, coords in cases:
            yield f"{shape_name}/{coords_name}", b, h, w, c, coords


@contextlib.contextmanager
def path_counts(wrapper: str):
    """Every launch of ``correlation.<wrapper>`` inside (``_alt_corr_bwd_cuda``
    or ``_alt_corr_lookup_cuda``) adds its (8x8 query tile, level) path
    counter into the yielded int32 tensor: [l] the tile path, [LEVELS + l]
    the per-query path."""
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    counts = torch.zeros(2 * LEVELS, dtype=torch.int32, device="cuda")
    launch = getattr(corr, wrapper)
    setattr(corr, wrapper, lambda *a: launch(*a, path_counts=counts))
    try:
        yield counts
    finally:
        setattr(corr, wrapper, launch)


def path_share(counts: torch.Tensor) -> tuple:
    """(share of the (tile, level) pairs with a live window that took the
    tile path, a per-level summary)."""
    tile, per_query = counts[:LEVELS].tolist(), counts[LEVELS:].tolist()
    share = sum(tile) / max(1, sum(tile) + sum(per_query))
    return share, " ".join(f"L{lvl}:{t}/{t + p}" for lvl, (t, p) in
                           enumerate(zip(tile, per_query)))


def kernel_phase(gen, shape=(B, H // 8, W // 8, 256), main="main",
                 ragged=True) -> dict:
    """B1 against its plain version at ``shape`` (named ``main``, timed)
    and, with ``ragged``, at a ragged shape."""
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print(f"== alt_corr_fwd vs plain (TF32 off), {main} shape {shape} ==",
          flush=True)
    res = {}
    for name, b, h, w, c, coords in lookup_cases(
            gen, shape, smooth=True, main=main, ragged=ragged):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        cflat = coords.reshape(b, h * w, 2).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            with path_counts("_alt_corr_lookup_cuda") as counts:
                got = corr.alt_corr_lookup(f1, levels, cflat, RADIUS)
            ref = corr.alt_corr_lookup_reference(f1, levels, cflat, RADIUS)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_REL_TOL * scale
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            share, per_level = path_share(counts)
            print(f"{tag:32s} max_abs_err={err:.3e} tol={tol:.3e} "
                  f"max|corr|={scale:.3f}; tile path {100 * share:.1f}% "
                  f"({per_level})", flush=True)
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"{tag}: kernel output malformed")
            check(err <= tol, f"{tag}: kernel disagrees with plain version")
            res[tag] = err
            res[f"{tag}/tile_share"] = share
            res.setdefault("paths", counts.new_zeros(2 * LEVELS))
            res["paths"] += counts
            if name.split("/")[0] == main and not name.endswith("/edge"):
                k_ms = cuda_ms(lambda: corr.alt_corr_lookup(
                    f1, levels, cflat, RADIUS), reps=20)
                res[f"{tag}/ms"] = k_ms
                if name == f"{main}/calibrated":
                    p_ms = cuda_ms(lambda: corr.alt_corr_lookup_reference(
                        f1, levels, cflat, RADIUS), reps=5, warmup=1)
                    res[f"{tag}/plain_ms"] = p_ms
                    # per query and level: the (2r+2)^2 integer-grid dots
                    # of length C, a multiply-add each
                    flops = 2 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                    res[f"{tag}/bound"] = bound(
                        nbytes(f1, *levels, cflat, got), flops, dtype)
                    m = res[f"{tag}/bound"]
                    print(f"{tag:32s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                          f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}; "
                          f"the kernel at {100 * m['bound_ms'] / k_ms:.1f}% of "
                          "it) per lookup (4 levels)", flush=True)
                else:
                    print(f"{tag:32s} kernel {k_ms:.3f} ms per lookup",
                          flush=True)
            del got, ref
    paths = res["paths"]
    check(paths[:LEVELS].sum().item() > 0 and paths[LEVELS:].sum().item() > 0,
          f"alt_corr_fwd: the cases did not take both paths ({paths.tolist()})")
    return res


def backward_phase(gen, shape=(TB, TH // 8, TW // 8, 256),
                   more=(("attack", (AB, AH // 8, AW // 8, 256)),),
                   main="main", ragged=True) -> dict:
    """B2 against its plain backward at ``shape`` (named ``main``), the
    ``more`` shapes and, with ``ragged``, a ragged one; the calibrated and
    smooth bf16 cases timed, the plain backward at ``shape``'s."""
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print(f"== alt_corr_bwd vs plain backward (TF32 off), {main} shape "
          f"{shape} ==", flush=True)
    res = {}
    n2 = (2 * RADIUS + 1) ** 2
    for name, b, h, w, c, coords in lookup_cases(
            gen, shape, more, smooth=True, main=main, ragged=ragged):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        cflat = coords.reshape(b, h * w, 2).contiguous()
        g = torch.randn((b, h * w, LEVELS * n2), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            with path_counts("_alt_corr_bwd_cuda") as counts:
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
            share, per_level = path_share(counts)
            res[f"{tag}/tile_share"] = share
            res.setdefault("paths", counts.new_zeros(2 * LEVELS))
            res["paths"] += counts
            print(f"{tag:28s} (tile, level) pairs on the tile path: "
                  f"{100 * share:.1f}% ({per_level})", flush=True)
            if dtype == torch.bfloat16 and not name.startswith("ragged") \
                    and name.split("/")[1] in ("calibrated", "smooth"):
                k_ms = cuda_ms(lambda: corr._alt_corr_bwd_cuda(
                    f1, levels, cflat, g, RADIUS), reps=20)
                res[f"{tag}/ms"] = k_ms
                # per query and level: the (2r+2)^2 grid points' df1 and
                # df2 products of length C, a multiply-add each
                flops = 4 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                res[f"{tag}/bound"] = bound(
                    nbytes(f1, *levels, cflat, g, got[0], *got[1]), flops,
                    dtype)
                line = (f"{tag:28s} kernel {k_ms:.3f} ms, bound "
                        f"{res[f'{tag}/bound']['bound_ms']:.4f} ms "
                        f"({res[f'{tag}/bound']['bound_by']})")
                if tag == f"{main}/calibrated/bfloat16":
                    p_ms = cuda_ms(
                        lambda: corr.alt_corr_lookup_backward_reference(
                            f1, levels, cflat, g, RADIUS), reps=2, warmup=0)
                    res[f"{tag}/plain_ms"] = p_ms
                    line += f", plain {p_ms:.3f} ms"
                print(line + " per backward (4 levels)", flush=True)
            del got, ref
    paths = res["paths"]
    check(paths[:LEVELS].sum().item() > 0 and paths[LEVELS:].sum().item() > 0,
          "alt_corr_bwd: the cases did not take both paths "
          f"({paths.tolist()})")
    return res


def dcoords_phase(gen) -> dict:
    """B3: the lookup's coordinate gradient, driven through the op a user
    calls (``alt_corr_features`` with coords that require grad), then the
    kernel against its plain version on the same inputs."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print("== alt_corr_dcoords (B3) vs plain coordinate gradient (TF32 off) "
          "==", flush=True)
    res = {}
    b, h, w, c = B, H // 8, W // 8, 256
    n2 = (2 * RADIUS + 1) ** 2
    fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    g = torch.randn((b, h * w, LEVELS * n2), generator=gen, device="cuda")
    grid = ops.coords_grid(h, w, device="cuda")[None].expand(b, h, w, 2)
    noise = torch.randn((b, h, w, 2), generator=gen, device="cuda")
    far = grid + 2.0 * noise
    far[0, 0, :6] = torch.tensor(
        [[-1e30, 3.0], [3.0, 1e30], [1e30, -1e30], [-50.0, -50.0],
         [500.0, 500.0], [-3.5, -3.5]], device="cuda")
    cases = {"calibrated": grid + 2.0 * noise, "wild": grid + 150.0 * noise,
             "far": far, "integer": grid.clone()}

    # the op's coordinate-gradient path, the only one that launches B3
    coords = cases["calibrated"].clone().requires_grad_()
    ops.LAUNCH_COUNTS.clear()
    out = ops.alt_corr_features(fm1, fm2, coords, LEVELS, RADIUS,
                                compute_dtype=torch.bfloat16)
    out.backward(g.reshape(out.shape))
    torch.cuda.synchronize()
    n = {k: ops.LAUNCH_COUNTS[k] for k in
         ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords")}
    res["launches"] = n["alt_corr_dcoords"]
    check(n == {"alt_corr_fwd": 1, "alt_corr_bwd": 0, "alt_corr_dcoords": 1},
          f"coordinate gradient of alt_corr_features: launches {n}")
    f1b, lvb = corr.prepare_alt_corr(fm1, fm2, LEVELS, torch.bfloat16)
    ref = corr.alt_corr_coords_grad_reference(
        f1b, lvb, cases["calibrated"].reshape(b, h * w, 2), g, RADIUS)
    err = (coords.grad.reshape(ref.shape) - ref).abs().max().item()
    tol = DCOORDS_REL_TOL * ref.abs().max().item()
    print(f"alt_corr_features(coords.requires_grad) + backward: launches {n} "
          f"(no model path launches B3: RAFT detaches its coords every "
          f"iteration); coords.grad vs plain max_abs_err={err:.3e} "
          f"tol={tol:.3e}", flush=True)
    check(err <= tol, "op's coordinate gradient disagrees with plain version")
    del out, coords, ref

    for dtype in (torch.float32, torch.bfloat16):
        f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
        for name, cc in cases.items():
            cflat = cc.reshape(b, h * w, 2).contiguous()
            got = corr._alt_corr_dcoords_cuda(f1, levels, cflat, g, RADIUS)
            ref = corr.alt_corr_coords_grad_reference(f1, levels, cflat, g,
                                                      RADIUS)
            torch.cuda.synchronize()
            tag = f"main/{name}/{str(dtype).split('.')[-1]}"
            check(got.shape == ref.shape and got.dtype == torch.float32
                  and bool(torch.isfinite(got).all()),
                  f"{tag}: kernel output malformed")
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = DCOORDS_REL_TOL * scale
            print(f"{tag:32s} max_abs_err={err:.3e} tol={tol:.3e} "
                  f"max|dcoords|={scale:.3f}", flush=True)
            check(err <= tol, f"{tag}: kernel disagrees with plain version")
            if name == "far":
                check(got[0, :5].abs().max().item() == 0,
                      f"{tag}: windows wholly outside got a gradient")
            res[tag] = err
            if name == "calibrated":
                k_ms = cuda_ms(lambda: corr._alt_corr_dcoords_cuda(
                    f1, levels, cflat, g, RADIUS), reps=20)
                p_ms = cuda_ms(lambda: corr.alt_corr_coords_grad_reference(
                    f1, levels, cflat, g, RADIUS), reps=3, warmup=1)
                res[f"{tag}/ms"], res[f"{tag}/plain_ms"] = k_ms, p_ms
                # per query and level: the (2r+2)^2 integer-grid dots of
                # length C, a multiply-add each (B1's work; the window
                # derivatives and the contraction with g are ~1 %)
                flops = 2 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                res[f"{tag}/bound"] = bound(
                    nbytes(f1, *levels, cflat, g, got), flops, dtype)
                print(f"{tag:32s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                      f"bound {res[f'{tag}/bound']['bound_ms']:.4f} ms "
                      f"({res[f'{tag}/bound']['bound_by']}) per coordinate "
                      "gradient (4 levels)", flush=True)
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
    # which path B1 took for the coords of a request's 12 iterations
    for point, model in points.items():
        with path_counts("_alt_corr_lookup_cuda") as counts:
            predict_flow(model, *requests[0])
        share, per_level = path_share(counts)
        res[f"{point}/tile_share"] = share
        print(f"{point} request's own coords: (tile, level) pairs of "
              f"alt_corr_fwd on the tile path {100 * share:.1f}% ({per_level}, "
              f"summed over {ITERS} iterations)", flush=True)
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
                        # the kernel and grid_sample replayed from a CUDA
                        # graph (device time), and the kernel launched
                        # from Python back to back
                        k_ms = graph_ms(lambda: ops.warp_backward(
                            img, flow, mode), reps=50)
                        launched_ms = cuda_ms(lambda: ops.warp_backward(
                            img, flow, mode), reps=50)
                        p_ms = cuda_ms(lambda: ops.warp_backward_reference(
                            img, flow, mode), reps=10)
                        l_ms = graph_ms(grid_sample_call(img, flow, mode),
                                        reps=50)
                        res[f"{mode}/main"] = {
                            "tag": tag, "max_abs_err": err.max().item(),
                            "ms": k_ms, "launched_ms": launched_ms,
                            "plain_ms": p_ms, "library_ms": l_ms,
                            # 4 taps per channel, a multiply-add each
                            **bound(nbytes(img, flow, got),
                                    8 * b * c * h * w, dtype)}
                        m = res[f"{mode}/main"]
                        print(f"{tag:38s} kernel {k_ms:.4f} ms ("
                              f"{launched_ms:.4f} launched from Python), "
                              f"plain {p_ms:.4f} ms, grid_sample {l_ms:.4f} "
                              "ms, "
                              f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}"
                              "; the kernel at "
                              f"{100 * m['bound_ms'] / k_ms:.0f}% of it)",
                              flush=True)
                    del got, ref
            del flow
    return res


def corr_block_grid_sample(pyramid, coords):
    """The reference CorrBlock's sampling (models/raft/corr.py:72-96) as one
    ``F.grid_sample(align_corners=True, padding_mode="zeros")`` per level
    over the (B*N, 1, Hl, Wl) level with a (B*N, 9, 9, 2) grid, for its
    time: the grids (row s, column t sampling (x/2^l - r + s,
    y/2^l - r + t), so the output is s-major) are built outside the
    timing.  A bf16 level needs a bf16 grid, which rounds the
    coordinates."""
    F = torch.nn.functional
    b, h, w, _ = coords.shape
    bn, n = b * h * w, 2 * RADIUS + 1
    d = torch.arange(-RADIUS, RADIUS + 1, device=coords.device,
                     dtype=torch.float32)
    calls = []
    for lvl, p in enumerate(pyramid):
        hl, wl = p.shape[2:]
        c = coords.reshape(bn, 1, 1, 2) / 2 ** lvl
        x = (c[..., 0] + d[:, None]).expand(bn, n, n)  # [q, s, t]
        y = (c[..., 1] + d[None, :]).expand(bn, n, n)
        grid = torch.stack([2 * x / max(wl - 1, 1) - 1,
                            2 * y / max(hl - 1, 1) - 1], dim=-1).to(p.dtype)
        vol = p.reshape(bn, 1, hl, wl)
        calls.append((vol, grid))

    def run():  # the four sample calls, each (B*N, 1, 9, 9)
        return [F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for v, g in calls]
    return run


def needed_taps(pyramid, coords) -> int:
    """The volume taps this run's windows need: per query and level, the
    (2r+2)^2 integer taps around the centre that lie inside the level
    (windows that straddle or leave the level need fewer)."""
    b, h, w, _ = coords.shape
    c = coords.reshape(-1, 2).double()
    total = 0
    offs = torch.arange(-RADIUS, RADIUS + 2, device=coords.device)
    for lvl, p in enumerate(pyramid):
        hl, wl = p.shape[2:]
        cx = (c[:, 0] / 2 ** lvl).clamp(-(RADIUS + 2.0), wl + RADIUS + 1.0)
        cy = (c[:, 1] / 2 ** lvl).clamp(-(RADIUS + 2.0), hl + RADIUS + 1.0)
        xs = cx.floor().long()[:, None] + offs
        ys = cy.floor().long()[:, None] + offs
        nx = ((xs >= 0) & (xs < wl)).sum(1)
        ny = ((ys >= 0) & (ys < hl)).sum(1)
        total += int((nx * ny).sum().item())
    return total


def volume_kernel_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch import ops

    print("== corr_lookup_fwd vs plain, RAFT's volume pyramid ==", flush=True)
    res = {}
    n2 = (2 * RADIUS + 1) ** 2
    for name, b, h, w, c, coords in lookup_cases(gen, (B, H // 8, W // 8, 256)):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        coords = coords.contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            pyr = ops.volume_pyramid(fm1, fm2, LEVELS,
                                     None if dtype == torch.float32 else dtype)
            got = ops.corr_lookup(pyr, coords)
            ref = ops.corr_lookup_reference(pyr, coords)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            check(tuple(got.shape) == (b, h, w, LEVELS * n2)
                  and got.dtype == torch.float32
                  and bool(torch.isfinite(got).all()),
                  f"{tag}: kernel output malformed")
            err = (got - ref).abs().max().item()
            print(f"{tag:32s} max_abs_err={err:.3e} tol={VOL_TOL:.0e} "
                  f"max|corr|={ref.abs().max().item():.3f}", flush=True)
            check(err <= VOL_TOL, f"{tag}: kernel disagrees with plain version")
            res[tag] = err
            if name == "main/calibrated":
                lib = corr_block_grid_sample(pyr, coords)
                k_ms = cuda_ms(lambda: ops.corr_lookup(pyr, coords), reps=50)
                p_ms = cuda_ms(lambda: ops.corr_lookup_reference(pyr, coords),
                               reps=5, warmup=1)
                l_ms = cuda_ms(lib, reps=20)
                lib_out = torch.cat([o.reshape(b, h, w, -1) for o in lib()], -1)
                lib_err = (lib_out.float() - got).abs().max().item()
                del lib_out
                taps = needed_taps(pyr, coords)
                # per output: 4 products and 3 sums, in f32
                res[f"{tag}/main"] = {
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    "library_ms": l_ms, "taps": taps,
                    **bound(taps * pyr[0].element_size()
                            + nbytes(coords, got),
                            7 * got.numel(), torch.float32)}
                m = res[f"{tag}/main"]
                print(f"{tag:32s} kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                      f"grid_sample x{LEVELS} {l_ms:.4f} ms (vs kernel "
                      f"{lib_err:.2e}), bound {m['bound_ms']:.4f} ms "
                      f"({m['bound_by']}, {taps} taps of "
                      f"{b * h * w * LEVELS * (2 * RADIUS + 2) ** 2})",
                      flush=True)
            del pyr, got, ref
    return res


def volume_model_phase(gen) -> dict:
    """RAFT-12 on its volume path, serving the model phase's workload."""
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== RAFT-12 volume path (corr_impl=\"volume\") ==", flush=True)
    res = {}
    wild = fetch_model("RAFT", device="cuda", seed=0, corr_impl="volume")
    cal = FlowModel("RAFT", scale_flow_head(wild.module, 0.05), wild.device)
    points = {"calibrated": cal, "wild": wild}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while serving
    flows = {}
    LAUNCH_COUNTS.clear()
    for point, model in points.items():
        for i, (a, b) in enumerate(requests):
            before = dict(LAUNCH_COUNTS)
            flow = predict_flow(model, a, b)
            torch.cuda.synchronize()
            n = {k: LAUNCH_COUNTS[k] - before.get(k, 0)
                 for k in ("corr_lookup_fwd", "alt_corr_fwd")}
            check(tuple(flow.shape) == (B, H, W, 2)
                  and bool(torch.isfinite(flow).all()),
                  f"{point} request {i}: flow malformed")
            check(n == {"corr_lookup_fwd": ITERS, "alt_corr_fwd": 0},
                  f"{point} request {i}: launches {n}, not {ITERS} of "
                  "corr_lookup_fwd and none of alt_corr_fwd")
            flows[point, i] = flow
    res["launches"] = LAUNCH_COUNTS["corr_lookup_fwd"]
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"corr_lookup_fwd launches while serving {len(points)}x{REQUESTS} "
          f"requests: {res['launches']} ({ITERS} per request), alt_corr_fwd "
          f"{LAUNCH_COUNTS['alt_corr_fwd']}; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)

    # against the plain lookup and the alt path, same weights
    a, b = requests[0]
    for point, model in points.items():
        model.module.plain_lookup = True
        plain = predict_flow(model, a, b)
        model.module.plain_lookup = False
        model.module.corr_impl = "alt"
        alt = predict_flow(model, a, b)
        model.module.corr_impl = "volume"
        for other, ref in (("plain", plain), ("alt", alt)):
            mx, rel = flow_stats(flows[point, 0], ref)
            res[f"bf16/{point}/vs_{other}_rel_epe"] = rel
            print(f"bf16 {point}: volume path vs {other} max|dflow|={mx:.3e} "
                  f"px, rel EPE={100 * rel:.4f}%", flush=True)
    check(res["bf16/calibrated/vs_plain_rel_epe"] <= BF16_REL_EPE_TOL
          and res["bf16/wild/vs_plain_rel_epe"] <= BF16_REL_EPE_TOL,
          "bf16: volume kernel vs plain lookup beyond the 1% bar")
    check(res["bf16/calibrated/vs_alt_rel_epe"] <= BF16_REL_EPE_TOL,
          "bf16 calibrated: volume path vs alt path beyond the 1% bar")
    m32 = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", device="cuda", seed=0,
                      corr_impl="volume")
    m32 = FlowModel(m32.name, scale_flow_head(m32.module, 0.05), m32.device)
    vol = predict_flow(m32, a, b)
    m32.module.corr_impl = "alt"
    alt = predict_flow(m32, a, b)
    mx, rel = flow_stats(vol, alt)
    res["f32/calibrated/vs_alt_max_abs_px"] = mx
    print(f"f32 calibrated (TF32 off): volume path vs alt path "
          f"max|dflow|={mx:.3e} px (tol {F32_FLOW_TOL_PX}), rel EPE="
          f"{100 * rel:.6f}%", flush=True)
    check(mx <= F32_FLOW_TOL_PX, "f32: volume path vs alt path beyond bound")
    del m32, vol, alt

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
        print(f"volume {point}: {B * n / dt:.2f} pairs/s ({1e3 * dt / n:.1f} "
              f"ms per request of {B} pairs, {n} requests)", flush=True)
    return res


def taps_phase(gen) -> dict:
    """RAFT-12 with its feature taps, one request at full width."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        get_feature_map_keys,
        raft_model,
    )

    print("== RAFT-12 feature taps (return_features=True) ==", flush=True)
    model = fetch_model("RAFT", device="cuda", seed=0, return_features=True)
    a = torch.rand((B, H, W, 3), generator=gen, device="cuda") * 255.0
    b = torch.rand((B, H, W, 3), generator=gen, device="cuda") * 255.0
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    lookups = []

    def recording_lookup(*args):
        lookups.append(ops.corr_lookup(*args))
        return lookups[-1]

    h8, w8, n = H // 8, W // 8, (H // 8) * (W // 8)
    shapes = {"fmap1": (B, 256, h8, w8), "fmap2": (B, 256, h8, w8),
              "net": (B, 128, h8, w8), "inp": (B, 128, h8, w8)}
    shapes.update({f"corr_pyramid_{i}": (B, n, h8 >> i, w8 >> i)
                   for i in range(LEVELS)})
    for it in range(ITERS):
        shapes.update({
            f"idx_corr_vol_{it}": (B, LEVELS * (2 * RADIUS + 1) ** 2, h8, w8),
            f"net_{it}": (B, 128, h8, w8), f"motion_features_{it}": (B, 128, h8, w8),
            f"cor1_{it}": (B, 256, h8, w8), f"cor_{it}": (B, 192, h8, w8),
            f"cor_flo_{it}": (B, 256, h8, w8), f"flow_pred_{it}": (B, 2, H, W)})
    with torch.inference_mode():
        model.module(a, b)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        raft_model.corr_lookup = recording_lookup
        ops.LAUNCH_COUNTS.clear()
        try:
            t0 = time.perf_counter()
            _, flow_up, feats = model.module(a, b)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            raft_model.corr_lookup = ops.corr_lookup
    launches = ops.LAUNCH_COUNTS["corr_lookup_fwd"]
    keys = get_feature_map_keys("RAFT")
    check(list(feats) == keys, "taps: keys differ from get_feature_map_keys")
    for k in keys:
        check(tuple(feats[k].shape) == shapes[k],
              f"taps: {k} is {tuple(feats[k].shape)}, not {shapes[k]}")
        check(bool(torch.isfinite(feats[k]).all()), f"taps: {k} not finite")
    check(launches == ITERS and len(lookups) == ITERS,
          f"taps: corr_lookup_fwd launched {launches} times, not {ITERS}")
    for it, out in enumerate(lookups):
        check(torch.equal(feats[f"idx_corr_vol_{it}"], out.permute(0, 3, 1, 2)),
              f"taps: idx_corr_vol_{it} is not the kernel's lookup output")
    check(torch.equal(feats[f"flow_pred_{ITERS - 1}"], flow_up),
          "taps: flow_pred of the last iteration is not flow_up")
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in feats.values()}
    held = sum(storages.values()) / 2 ** 30
    res = {"launches": launches, "ms": ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "taps_gib": held, "base_gib": base / 2 ** 30}
    print(f"taps: {len(keys)} keys, shapes and finiteness as expected, "
          f"idx_corr_vol_0..{ITERS - 1} equal to the kernel's output; "
          f"{launches} corr_lookup_fwd launches; request {ms:.1f} ms; taps "
          f"hold {held:.2f} GiB; peak memory {res['peak_mem_gib']:.2f} GiB "
          f"(model and inputs {res['base_gib']:.2f} GiB)", flush=True)
    return res


def wocontext_phase(gen) -> dict:
    """RAFT_FlowNetCEncoder_WoContext, calibrated, on its (alt) path."""
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    name = "RAFT_FlowNetCEncoder_WoContext"
    print(f"== {name} serving, calibrated ==", flush=True)
    m = fetch_model(name, device="cuda", seed=0)
    model = FlowModel(name, scale_flow_head(m.module, 0.05), m.device)
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    res = {}
    flows = []
    LAUNCH_COUNTS.clear()
    for i, (a, b) in enumerate(requests):
        before = dict(LAUNCH_COUNTS)
        flow = predict_flow(model, a, b)
        torch.cuda.synchronize()
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0)
             for k in ("alt_corr_fwd", "corr_lookup_fwd")}
        check(tuple(flow.shape) == (B, H, W, 2)
              and bool(torch.isfinite(flow).all()),
              f"{name} request {i}: flow malformed")
        check(n == {"alt_corr_fwd": ITERS, "corr_lookup_fwd": 0},
              f"{name} request {i}: launches {n}, not {ITERS} of alt_corr_fwd")
        flows.append(flow)
    res["launches"] = LAUNCH_COUNTS["alt_corr_fwd"]
    res["mean_flow_px"] = torch.stack(
        [torch.linalg.vector_norm(f, dim=-1).mean() for f in flows]).mean().item()
    a, b = requests[0]
    model.module.plain_lookup = True
    plain = predict_flow(model, a, b)
    model.module.plain_lookup = False
    mx, rel = flow_stats(flows[0], plain)
    res["rel_epe_vs_plain"] = rel
    print(f"alt_corr_fwd launches while serving {REQUESTS} requests: "
          f"{res['launches']} ({ITERS} per request); mean |flow| "
          f"{res['mean_flow_px']:.3f} px; kernel vs plain lookup "
          f"max|dflow|={mx:.3e} px, rel EPE={100 * rel:.4f}%", flush=True)
    check(rel <= BF16_REL_EPE_TOL, f"{name}: kernel vs plain lookup beyond "
                                   "the 1% bar")
    for a, b in requests[:2]:
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in requests * 2:
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res["pairs_per_s"] = B * 2 * REQUESTS / dt
    print(f"{name}: {res['pairs_per_s']:.2f} pairs/s ({1e3 * dt / (2 * REQUESTS):.1f}"
          f" ms per request of {B} pairs)", flush=True)
    return res


def warp_model_phase(gen, name: str, warps: int, corrs: int = 0) -> dict:
    """``name`` serving REQUESTS requests of B pairs at HxW through
    ``predict_flow``, each warp and each of its ``corrs`` correlations
    through the kernels; then the same model with the plain warp and the
    plain correlation together, and pairs/s, with ``corrs`` also with the
    plain correlation alone (the path before the correlation kernel)."""
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

    # the main path: count the kernels' launches while serving
    flows = []
    LAUNCH_COUNTS.clear()
    expect = {"warp_fwd": warps, "spatial_corr_fwd": corrs}
    for i, (a, b) in enumerate(requests):
        before = dict(LAUNCH_COUNTS)
        flow = predict_flow(model, a, b)
        torch.cuda.synchronize()
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0) for k in expect}
        check(tuple(flow.shape) == (B, H, W, 2),
              f"{name} request {i}: flow shape {tuple(flow.shape)}")
        check(bool(torch.isfinite(flow).all()),
              f"{name} request {i}: non-finite flow")
        check(n == expect, f"{name} request {i}: launches {n}, not {expect}")
        flows.append(flow)
    res["launches"] = LAUNCH_COUNTS["warp_fwd"]
    res["corr_launches"] = LAUNCH_COUNTS["spatial_corr_fwd"]
    res["mean_flow_px"] = torch.stack(
        [torch.linalg.vector_norm(f, dim=-1).mean() for f in flows]
    ).mean().item()
    print(f"launches while serving {REQUESTS} requests: warp_fwd "
          f"{res['launches']} ({warps} per request), spatial_corr_fwd "
          f"{res['corr_launches']} ({corrs} per request); mean |flow| "
          f"{res['mean_flow_px']:.3f} px", flush=True)

    # the kernels against the plain warp and correlation, end to end
    a, b = requests[0]
    points = [(model, flows[0], mixed)]
    if mixed:  # PWC-Net's f32 configuration as well
        m32 = fetch_model(name, device="cuda", seed=0, mixed_precision=False)
        points.append((m32, predict_flow(m32, a, b), False))
    what = "warp and correlation kernels" if corrs else "warp kernel"
    for m, got, bf16 in points:
        m.module.plain_warp = True
        if corrs:
            m.module.plain_corr = True
        plain = predict_flow(m, a, b)
        m.module.plain_warp = False
        if corrs:
            m.module.plain_corr = False
        mx, rel = flow_stats(got, plain)
        key = "bf16" if bf16 else "f32"
        res[f"{key}/max_abs_px"], res[f"{key}/rel_epe"] = mx, rel
        bar = (f"rel EPE bound {100 * BF16_REL_EPE_TOL:g}%" if bf16
               else f"max bound {FLOW_F32_TOL_PX} px")
        print(f"{key}: {what} vs plain versions max|dflow|={mx:.3e} px, "
              f"rel EPE={100 * rel:.5f}% ({bar})", flush=True)
        check(rel <= BF16_REL_EPE_TOL if bf16 else mx <= FLOW_F32_TOL_PX,
              f"{name} {key}: {what} vs plain versions beyond bound")
    del points

    # steady-state throughput; with correlations also on the plain
    # correlation (the path before its kernel), the two in turns
    variants = ("kernel", "plain_corr") if corrs else ("kernel",)
    times = {v: [] for v in variants}
    for _ in range(2):
        for v in variants:
            if corrs:
                model.module.plain_corr = v == "plain_corr"
            for a, b in requests[:1]:
                predict_flow(model, a, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a, b in requests:
                predict_flow(model, a, b)
            torch.cuda.synchronize()
            times[v].append(time.perf_counter() - t0)
    if corrs:
        model.module.plain_corr = False
    for v, dts in times.items():
        dt, n = sum(dts), REQUESTS * len(dts)
        key = "pairs_per_s" if v == "kernel" else "plain_corr_pairs_per_s"
        res[key] = B * n / dt
        print(f"{name}{'' if v == 'kernel' else ' (plain correlation)'}: "
              f"{B * n / dt:.2f} pairs/s ({1e3 * dt / n:.1f} ms per request "
              f"of {B} pairs, {n} requests)", flush=True)
    return res


def corr_pairs(h: int, w: int, patch: int, dil: int) -> int:
    """The (pixel, displacement) pairs whose displaced pixel lies inside an
    h x w map: the products a correlation needs per image and channel."""
    r = (patch - 1) // 2
    offs = [(k - r) * dil for k in range(patch)]
    return (sum(max(0, h - abs(d)) for d in offs)
            * sum(max(0, w - abs(d)) for d in offs))


def _corr_err(got, ref, dtype) -> tuple:
    """(max abs error, whether it is within the bar CORR_REL_TOL states)."""
    err = (got.float() - ref.float()).abs()
    bar = CORR_REL_TOL * ref.float().abs().max().item()
    if dtype == torch.float32:
        return err.max().item(), err.max().item() <= bar
    return err.max().item(), bool(
        (err <= torch.clamp(bf16_ulp(ref.float()), min=bar)).all())


def spatial_corr_phase(gen) -> dict:
    """csrc/spatial_corr_fwd.cu and csrc/spatial_corr_bwd.cu against the
    plain version and its autograd on the same inputs, at the main paths'
    shapes and ragged ones; times at FlowNetC's serving and patch shapes
    and PWC-Net's level 2 (forward) and at FlowNetC's attack and patch
    shapes and PWC-Net's level 2 (backward)."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print("== spatial_corr_fwd / spatial_corr_bwd vs plain (TF32 off) ==",
          flush=True)
    res = {}
    for name, (shape, patch, dil, dtype) in {**CORR_MAIN, **CORR_PWC,
                                             **CORR_RAGGED}.items():
        # the patch shape draws from a generator of its own, so that the
        # other cases and later phases draw as before
        cg = torch.Generator(device="cuda").manual_seed(PATCH_SEED) \
            if name == "patch" else gen
        f1 = torch.randn(shape, generator=cg, device="cuda").to(dtype)
        f2 = torch.randn(shape, generator=cg, device="cuda").to(dtype)
        g = torch.randn((shape[0], patch ** 2) + shape[2:], generator=cg,
                        device="cuda").to(dtype)
        got = ops.spatial_correlation(f1, f2, patch, dilation_patch=dil)
        ref = ops.spatial_correlation_reference(f1, f2, patch, dil)
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"{name}: spatial_corr_fwd output malformed")
        err, ok = _corr_err(got, ref, dtype)
        # the backward kernel (f32 sums written in the inputs' dtype)
        # against the plain version's autograd in f32 on the same values,
        # at the forward's bar
        dk = corr._spatial_corr_bwd_cuda(f1, f2, g, patch, dil)
        a, b = f1.float().requires_grad_(), f2.float().requires_grad_()
        dp = torch.autograd.grad(ops.spatial_correlation_reference(
            a, b, patch, dil), (a, b), g.float())
        torch.cuda.synchronize()
        bres = [_corr_err(k, p, dtype) for k, p in zip(dk, dp)]
        babs, bok = max(e for e, _ in bres), all(o for _, o in bres)
        berr = max((k.float() - p).abs().max().item() / p.abs().max().item()
                   for k, p in zip(dk, dp))
        bar = "1e-5 x max|plain|" if dtype == torch.float32 else \
            "1 bf16 ulp (1e-5 x max|plain| at cancellations)"
        print(f"{name:12s} {tuple(shape)} P={patch} d={dil} "
              f"{str(dtype).split('.')[-1]}: fwd max_abs_err={err:.3e}; "
              f"bwd max err / max|grad| = {berr:.2e} (bar {bar})", flush=True)
        check(ok, f"{name}: spatial_corr_fwd disagrees with the plain version")
        check(all(k.dtype == dtype for k in dk) and bok,
              f"{name}: spatial_corr_bwd disagrees with the plain version's "
              "autograd")
        res[name] = {"fwd_err": err, "bwd_err": babs, "bwd_rel_err": berr}
        pairs = corr_pairs(shape[2], shape[3], patch, dil) * shape[0] * shape[1]
        if name in ("flownetc", "patch", "pwc_l2"):
            k_ms = cuda_ms(lambda: ops.spatial_correlation(
                f1, f2, patch, dilation_patch=dil), reps=20)
            p_ms = cuda_ms(lambda: ops.spatial_correlation_reference(
                f1, f2, patch, dil), reps=3, warmup=1)
            # a multiply-add per pair inside the map and channel
            res[name].update(ms=k_ms, plain_ms=p_ms, **bound(
                nbytes(f1, f2, got), 2 * pairs, dtype))
            m = res[name]
            print(f"{name:12s} forward: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.3f} ms, bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}; the kernel at "
                  f"{100 * m['bound_ms'] / k_ms:.1f}% of it)", flush=True)
        if name in ("attack", "patch", "pwc_l2"):
            k_ms = cuda_ms(lambda: corr._spatial_corr_bwd_cuda(
                f1, f2, g, patch, dil), reps=20)
            a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
            out = ops.spatial_correlation_reference(a, b, patch, dil)
            p_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (a, b), g, retain_graph=True), reps=3, warmup=1)
            # two multiply-adds per pair and channel (df1 and df2); g read
            # and the gradients written once, in the inputs' dtype
            res[f"{name}/bwd"] = {"ms": k_ms, "plain_ms": p_ms, **bound(
                nbytes(f1, f2, g, *dk), 4 * pairs, dtype)}
            m = res[f"{name}/bwd"]
            print(f"{name:12s} backward: kernel {k_ms:.4f} ms, plain "
                  f"(autograd) {p_ms:.3f} ms, bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}; the kernel at "
                  f"{100 * m['bound_ms'] / k_ms:.1f}% of it)", flush=True)
            del out
        del f1, f2, g, got, ref, dk, dp
    return res


def flownet_phase(gen) -> dict:
    """The FlowNet family serving REQUESTS requests of B pairs at HxW
    through ``predict_flow``: launches of the correlation kernel per
    request, the flow against the same model with the plain correlation,
    pairs/s over the requests after the first; then one taps request on
    FlowNetC."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        get_feature_map_keys,
        predict_flow,
    )
    from understanding_flow_robustness_tpu_torch.models.flownet_family import (
        correlate_flownetc,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    res = {"launches": 0}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    for name, corrs in FLOWNETS:
        print(f"== {name} serving, batch {B} at {H}x{W}, f32 ==", flush=True)
        model = fetch_model(name, device="cuda", seed=0)
        torch.cuda.synchronize()
        flows = []
        LAUNCH_COUNTS.clear()
        for i, (a, b) in enumerate(requests):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = LAUNCH_COUNTS["spatial_corr_fwd"]
            flows.append(predict_flow(model, a, b))
            n = LAUNCH_COUNTS["spatial_corr_fwd"] - before
            check(n == corrs, f"{name} request {i}: spatial_corr_fwd "
                              f"launched {n} times, not {corrs}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for i, flow in enumerate(flows):
            check(tuple(flow.shape) == (B, H, W, 2)
                  and bool(torch.isfinite(flow).all()),
                  f"{name} request {i}: flow malformed")
        res["launches"] += LAUNCH_COUNTS["spatial_corr_fwd"]
        pps = B * (REQUESTS - 1) / dt
        res[f"{name}/pairs_per_s"] = pps
        mag = torch.linalg.vector_norm(flows[0], dim=-1).mean().item()
        line = (f"{name}: {pps:.2f} pairs/s ({1e3 * dt / (REQUESTS - 1):.1f} "
                f"ms per request of {B} pairs, requests 2-{REQUESTS}); "
                f"spatial_corr_fwd {corrs} per request; mean |flow| "
                f"{mag:.3f} px")
        if corrs:
            model.module.plain_corr = True
            plain = predict_flow(model, *requests[0])
            model.module.plain_corr = False
            rel = ((flows[0] - plain).norm() / plain.norm()).item()
            res[f"{name}/rel_l2_vs_plain"] = rel
            line += (f"; kernel vs plain correlation rel L2 {rel:.2e} (bound "
                     f"{FLOW_F32_REL_L2:g})")
            check(rel <= FLOW_F32_REL_L2, f"{name}: flow with the kernel "
                                          "beyond bound of the plain one's")
        print(line, flush=True)
        del model, flows

    print("== FlowNetC feature taps (return_features=True), one request ==",
          flush=True)
    model = fetch_model("FlowNetC", device="cuda", seed=0,
                        return_features=True)
    a, b = (x.permute(0, 3, 1, 2) for x in requests[0])
    LAUNCH_COUNTS.clear()
    with torch.inference_mode():
        t0 = time.perf_counter()
        flow, feats = model.module(a, b)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        plain = correlate_flownetc(feats["conv3a"], feats["conv3b"],
                                   plain=True)
    h2, w2 = H // 2, W // 2
    shapes = {"conv1a": (B, 64, h2, w2), "conv1b": (B, 64, h2, w2),
              "conv2a": (B, 128, h2 // 2, w2 // 2),
              "conv2b": (B, 128, h2 // 2, w2 // 2),
              "conv3a": (B, 256, H // 8, W // 8),
              "conv3b": (B, 256, H // 8, W // 8),
              "corr": (B, 441, H // 8, W // 8),
              "conv_redir": (B, 32, H // 8, W // 8),
              "conv3_1": (B, 256, H // 8, W // 8)}
    keys = get_feature_map_keys("FlowNetC")
    check(sorted(feats) == sorted(keys), "FlowNetC taps: keys differ from "
                                         "get_feature_map_keys")
    for k in keys:
        check(tuple(feats[k].shape) == shapes[k]
              and bool(torch.isfinite(feats[k]).all()),
              f"FlowNetC taps: {k} is {tuple(feats[k].shape)}, not "
              f"{shapes[k]}, or not finite")
    err, ok = _corr_err(feats["corr"], plain, torch.float32)
    check(ok and LAUNCH_COUNTS["spatial_corr_fwd"] == 1,
          "FlowNetC taps: corr is not the kernel's correlation, or it was "
          f"launched {LAUNCH_COUNTS['spatial_corr_fwd']} times")
    res["launches"] += LAUNCH_COUNTS["spatial_corr_fwd"]
    check(tuple(flow.shape) == (B, 2, H, W), "FlowNetC taps: flow malformed")
    print(f"taps: {len(keys)} keys, shapes and finiteness as expected; corr "
          f"within {err:.2e} of the plain correlation; 1 spatial_corr_fwd "
          f"launch; request {ms:.1f} ms", flush=True)
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
    # one more step: which path B2 took for the coords of its 12 iterations
    with path_counts("_alt_corr_bwd_cuda") as counts:
        losses.append(step(batches[0])["loss"])
    share, per_level = path_share(counts)
    print(f"train step's own coords: (tile, level) pairs of alt_corr_bwd on "
          f"the tile path {100 * share:.1f}% ({per_level}, summed over "
          f"{ITERS} iterations)", flush=True)
    res = {f"launches/{k}": LAUNCH_COUNTS[k] for k in TRAIN_KERNELS}
    res["tile_share"] = share
    print(f"kernel launches while training {TRAIN_WARMUP + TRAIN_STEPS + 1} "
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


def attack_phase() -> dict:
    """The global-attack path: I-FGSM with the CLI's defaults on RAFT at
    the attack geometry, then the image gradient against the plain lookup's
    and one FGSM on PWC-Net.  The images come from a generator of this
    phase's own (ATTACK_SEED), so that cases added to earlier phases leave
    them as they are: the image gradients' distance from the plain lookup's
    depends on the images (1e-4 to 3e-3 in f32, the same to five digits
    with either design of alt_corr_bwd; scripts/torch_kernel_ab.py --e2e)."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PerturbConfig,
        flow_attack_loss,
        make_attack,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== I-FGSM on RAFT-12, batch {AB} at {AH}x{AW}, {ATTACK_STEPS} "
          f"steps, eps {ATTACK_EPS}, l2 ==", flush=True)
    res = {}
    model = fetch_model("RAFT", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(ATTACK_SEED)
    a = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    b = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")

    def target(m, x, y):  # a synthetic GT offset from the clean flow
        flow = predict_flow(m, x, y)
        return torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    gt = target(model, a, b)
    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=ATTACK_EPS, n_step=ATTACK_STEPS)
    attack = make_attack(predict, cfg)
    with path_counts("_alt_corr_bwd_cuda") as counts:  # warm-up
        make_attack(predict, dataclasses.replace(cfg, n_step=2))(a, b, gt)
    share, per_level = path_share(counts)
    res["tile_share"] = share
    print(f"attack's own coords: (tile, level) pairs of alt_corr_bwd on the "
          f"tile path {100 * share:.1f}% ({per_level}, 2 steps)", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while attacking
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    n0, n1, adv0, adv1 = attack(a, b, gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: LAUNCH_COUNTS[k] for k in
         ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords")}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(n == {"alt_corr_fwd": ITERS * ATTACK_STEPS,
                "alt_corr_bwd": ITERS * ATTACK_STEPS, "alt_corr_dcoords": 0},
          f"attack: launches {n}, not {ITERS} of each lookup kernel per "
          "step and none of alt_corr_dcoords")
    res["ms_per_step"] = 1e3 * dt / ATTACK_STEPS
    res["steps_per_s"] = ATTACK_STEPS / dt
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    nmax = max(n0.abs().max().item(), n1.abs().max().item())
    check(nmax <= ATTACK_EPS + 1e-6, f"attack: noise {nmax} outside the "
                                     "eps-ball")
    check(0.0 <= min(adv0.min().item(), adv1.min().item())
          and max(adv0.max().item(), adv1.max().item()) <= 1.0,
          "attack: adversarial images outside [0, 1]")
    with torch.no_grad():
        before = flow_attack_loss(predict(a, b), gt, "l2").item()
        after = flow_attack_loss(predict(adv0, adv1), gt, "l2").item()
    res["loss_clean"], res["loss_attacked"] = before, after
    print(f"attack: launches {n} ({ITERS} of each lookup kernel per step); "
          f"max|noise|={nmax:.4f}; l2 loss {before:.3f} -> {after:.3f}; "
          f"{res['ms_per_step']:.2f} ms per step, {res['steps_per_s']:.2f} "
          f"steps/s ({ATTACK_STEPS} steps, {1e3 * dt:.0f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    check(after > before, "attack: the l2 loss did not grow")
    del n0, n1, adv0, adv1

    # one image gradient through the kernels against the plain lookup's
    for name, dtype, bnd in (
            ("RAFT_adv_kitti2012_ifgsm_l2_002", "f32", GRAD_F32_REL_L2),
            ("RAFT", "bf16", GRAD_BF16_REL_L2)):
        m = fetch_model(name, device="cuda", seed=0)
        kernel = FlowModel(name, scale_flow_head(m.module, 0.05), m.device)
        plain = FlowModel(name, copy.deepcopy(kernel.module), m.device)
        plain.module.plain_lookup = True
        gt = target(kernel, a, b)
        grads = []
        for mm in (kernel, plain):
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            loss = flow_attack_loss(predict_flow_differentiable(mm, x, y),
                                    gt, "l2")
            grads.append(torch.autograd.grad(loss, (x, y)))
        rels = [((k - p).norm() / p.norm()).item() for k, p in zip(*grads)]
        res[f"{dtype}/image_grad_rel_l2"] = max(rels)
        # the image gradients sit upstream of every layer, like the early
        # encoder layers that set the worst-tensor bound of grad_phase
        print(f"{dtype} ({name}, calibrated): image gradient with the kernels "
              f"vs plain lookup, rel L2 {rels[0]:.3e} / {rels[1]:.3e} "
              f"(bound {bnd[0]:g})", flush=True)
        check(max(rels) <= bnd[0], f"{dtype}: image gradient with the "
                                   "kernels beyond bound of the plain lookup's")
        del m, kernel, plain, grads

    # one FGSM on PWC-Net: the attack crosses the warp kernel and the
    # correlation's two kernels
    pwc = fetch_model("PWCNet", device="cuda", seed=0)
    gt = target(pwc, a, b)
    LAUNCH_COUNTS.clear()
    n0, n1, adv0, adv1 = make_attack(
        lambda x, y: predict_flow_differentiable(pwc, x, y),
        dataclasses.replace(cfg, perturb_method="fgsm"))(a, b, gt)
    torch.cuda.synchronize()
    res.update({f"pwc_launches/{k}": LAUNCH_COUNTS[k] for k in
                ("warp_fwd", "spatial_corr_fwd", "spatial_corr_bwd")})
    check(LAUNCH_COUNTS["warp_fwd"] == 4,
          f"PWC-Net FGSM: warp_fwd launched {LAUNCH_COUNTS['warp_fwd']} "
          "times, not 4")
    check(LAUNCH_COUNTS["spatial_corr_fwd"] == 5
          and LAUNCH_COUNTS["spatial_corr_bwd"] == 5,
          "PWC-Net FGSM: the correlation kernels launched "
          f"{LAUNCH_COUNTS['spatial_corr_fwd']} and "
          f"{LAUNCH_COUNTS['spatial_corr_bwd']} times, not 5 and 5")
    check(bool(torch.isfinite(n0).all()) and n0.abs().max().item() <= ATTACK_EPS
          + 1e-6 and 0.0 <= adv1.min().item() and adv1.max().item() <= 1.0,
          "PWC-Net FGSM: noise or images out of range")
    with torch.no_grad():
        before = flow_attack_loss(predict_flow(pwc, a, b), gt, "l2").item()
        after = flow_attack_loss(predict_flow(pwc, adv0, adv1), gt, "l2").item()
    print(f"PWC-Net FGSM: warp_fwd launches {res['pwc_launches/warp_fwd']} "
          f"(the gradient through the plain sampler), spatial_corr_fwd / "
          f"_bwd {res['pwc_launches/spatial_corr_fwd']} / "
          f"{res['pwc_launches/spatial_corr_bwd']}; l2 loss {before:.3f} -> "
          f"{after:.3f}", flush=True)
    return res


@contextlib.contextmanager
def leaky_relu_signs(module):
    """Every ``nn.LeakyReLU`` of ``module`` appends the sign of its input
    (``> 0``) to the yielded list at each forward inside."""
    signs = []
    hooks = [m.register_forward_hook(lambda m, i, o: signs.append(i[0] > 0))
             for m in module.modules() if isinstance(m, torch.nn.LeakyReLU)]
    try:
        yield signs
    finally:
        for h in hooks:
            h.remove()


def flownetc_attack_phase() -> dict:
    """I-FGSM with the attack CLI's defaults on ``fetch_model("FlowNetC")``
    (the CLI's default model, f32) at the attack geometry, each step's
    backward through ``spatial_corr_bwd``; then one image gradient with the
    kernels against one with the plain correlation."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PerturbConfig,
        flow_attack_loss,
        make_attack,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== I-FGSM on FlowNetC, batch {AB} at {AH}x{AW}, {ATTACK_STEPS} "
          f"steps, eps {ATTACK_EPS}, l2 ==", flush=True)
    res = {}
    model = fetch_model("FlowNetC", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(ATTACK_SEED)
    a = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    b = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    flow = predict_flow(model, a, b)
    gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=ATTACK_EPS, n_step=ATTACK_STEPS)
    make_attack(predict, dataclasses.replace(cfg, n_step=2))(a, b, gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while attacking
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    n0, n1, adv0, adv1 = make_attack(predict, cfg)(a, b, gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: LAUNCH_COUNTS[k] for k in ("spatial_corr_fwd", "spatial_corr_bwd")}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(n == {"spatial_corr_fwd": ATTACK_STEPS,
                "spatial_corr_bwd": ATTACK_STEPS},
          f"FlowNetC attack: launches {n}, not one of each per step")
    res["ms_per_step"] = 1e3 * dt / ATTACK_STEPS
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    nmax = max(n0.abs().max().item(), n1.abs().max().item())
    check(nmax <= ATTACK_EPS + 1e-6, f"FlowNetC attack: noise {nmax} outside "
                                     "the eps-ball")
    check(0.0 <= min(adv0.min().item(), adv1.min().item())
          and max(adv0.max().item(), adv1.max().item()) <= 1.0,
          "FlowNetC attack: adversarial images outside [0, 1]")
    with torch.no_grad():
        before = flow_attack_loss(predict(a, b), gt, "l2").item()
        after = flow_attack_loss(predict(adv0, adv1), gt, "l2").item()
    res["loss_clean"], res["loss_attacked"] = before, after
    print(f"FlowNetC attack: launches {n}; max|noise|={nmax:.4f}; l2 loss "
          f"{before:.3f} -> {after:.3f}; {res['ms_per_step']:.2f} ms per step "
          f"({ATTACK_STEPS} steps, {1e3 * dt:.0f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    check(after > before, "FlowNetC attack: the l2 loss did not grow")

    # one image gradient with the kernels, one with the plain correlation
    # (f32, TF32 off), held to the worst-tensor bound of RAFT's early layers
    # (GRAD_F32_REL_L2): the image gradient sits upstream of every layer.
    # Two witnesses of why it is not at the forward's 1e-5: the leaky-ReLU
    # inputs (nn.LeakyReLU, sign-preserving) whose sign differs between the
    # two forwards, where the slope flips between 1 and 0.1; and a third
    # gradient in f64 with the plain correlation, the one both f32 paths
    # round, with each path's distance to it
    signs = []
    grads = []
    for plain in (False, True):
        model.module.plain_corr = plain
        with leaky_relu_signs(model.module) as sign:
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            loss = flow_attack_loss(predict(x, y), gt, "l2")
            grads.append(torch.autograd.grad(loss, (x, y)))
        signs.append(sign)
    flips = sum(int((p != q).sum()) for p, q in zip(*signs))
    n_act = sum(p.numel() for p in signs[0])
    del signs
    model.module.plain_corr = True
    model.module.double()
    try:
        x, y = a.double().requires_grad_(), b.double().requires_grad_()
        loss = flow_attack_loss(predict(x, y), gt.double(), "l2")
        exact = torch.autograd.grad(loss, (x, y))
    finally:
        model.module.float()
        model.module.plain_corr = False

    def rel(u, v):
        return [((p.double() - q).norm() / q.norm()).item()
                for p, q in zip(u, v)]

    rels = rel(grads[0], grads[1])
    to_exact = [rel(grads[0], exact), rel(grads[1], exact)]
    res["image_grad_rel_l2"] = max(rels)
    res["image_grad_witness"] = {"leaky_relu_sign_flips": flips,
                                 "leaky_relu_inputs": n_act,
                                 "kernel_to_f64": to_exact[0],
                                 "plain_to_f64": to_exact[1]}
    print(f"f32 FlowNetC: image gradient with the kernels vs plain "
          f"correlation, rel L2 {rels[0]:.3e} / {rels[1]:.3e} (bound "
          f"{GRAD_F32_REL_L2[0]:g}); leaky-ReLU inputs of another sign in "
          f"the two forwards: {flips} of {n_act}; rel L2 to the f64 "
          f"gradient: kernels {to_exact[0][0]:.3e} / {to_exact[0][1]:.3e}, "
          f"plain {to_exact[1][0]:.3e} / {to_exact[1][1]:.3e}", flush=True)
    check(max(rels) <= GRAD_F32_REL_L2[0], "FlowNetC: image gradient with "
          "the kernels beyond bound of the plain correlation's")
    return res


def attack_cli_phase(flownet=None) -> dict:
    """The attack CLI with ``--perturb_method ifgsm --synthetic 2 --n_step
    3`` on ``flownet``, or without ``--flownet`` on its default
    (FlowNetC); FlowNet2 adds its four warps a forward."""
    from understanding_flow_robustness_tpu_torch.cli import run_perturb_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    name = flownet or run_perturb_model.build_parser().parse_args([]).flownet
    print(f"== attack CLI: {name}{'' if flownet else ' (the default)'}, "
          "I-FGSM, --synthetic 2 --n_step 3 ==", flush=True)
    out = Path(__file__).resolve().parent / "build" / "chip_smoke_attack"
    shutil.rmtree(out, ignore_errors=True)
    argv = (["--flownet", flownet] if flownet else []) + [
        "--perturb_method", "ifgsm", "--synthetic", "2", "--n_step", "3",
        "--output_path", str(out)]
    LAUNCH_COUNTS.clear()
    res = run_perturb_model.main(argv)
    # per pair: the clean, adversarial and noise-only flows and 3 steps,
    # each forward with RAFT's 12 lookups or FlowNetC's one correlation
    per, kernels = ((ITERS, ("alt_corr_fwd", "alt_corr_bwd")) if
                    name.startswith("RAFT") else
                    (1, ("spatial_corr_fwd", "spatial_corr_bwd")))
    expect = {kernels[0]: 2 * per * (3 + 3), kernels[1]: 2 * per * 3}
    if name == "FlowNet2":  # and its four border warps a forward
        expect["warp_fwd"] = 2 * 4 * (3 + 3)
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"attack CLI: launches {n}, not {expect}")
    path = out / "kitti2015" / name / "both" / "ifgsm_l2" / "0.02"
    keys = [line.split(":")[0] for line in
            (path / "results0.txt").read_text().splitlines()]
    check(keys == [k for k in res if k != "time_per_frame"] and len(keys) == 10,
          f"attack CLI: results0.txt keys {keys}")
    check(all(math.isfinite(v[0]) for v in res.values()),
          "attack CLI: non-finite metric")
    print(f"attack CLI: launches {n}; results0.txt with {len(keys)} keys; "
          f"epe {res['flow_epe_origin'][0]:.3f} -> {res['flow_epe'][0]:.3f}; "
          f"time_per_frame {res['time_per_frame'][0]:.3f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return {"launches/" + k: v for k, v in n.items()}


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


@contextlib.contextmanager
def recording(module, name: str, builds_step: bool = False):
    """Wraps ``module.<name>`` so that every call appends its result to the
    yielded list; with ``builds_step`` (``make_patch_attack_step``,
    ``make_universal_attack_step``) every call of a step it builds appends
    (the step's result, its seconds with the device synchronised)."""
    results = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if not builds_step:
            results.append(out)
            return out

        def step(*sa):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = out(*sa)
            torch.cuda.synchronize()
            results.append((res, time.perf_counter() - t))
            return res
        return step

    setattr(module, name, wrapped)
    try:
        yield results
    finally:
        setattr(module, name, fn)


def patch_step_phase() -> dict:
    """The patch attack's inner loop on FlowNetC (f32) at the JAX bench's
    geometry: PATCH_ITERS iterations pinned by ``loss_threshold=0``, each a
    forward and a backward through the correlation kernels to both
    composited images, the canvas update and the host's read of the loss;
    then one iteration's update with the kernels against the plain
    correlation's and an f64 one's."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PatchAttackConfig,
        make_patch_attack_step,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== patch attack on FlowNetC, batch {PB} at {PH}x{PW}, 100x100 "
          f"mask, {PATCH_ITERS} inner iterations ==", flush=True)
    res = {}
    model = fetch_model("FlowNetC", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(PATCH_SEED)
    a = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    b = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    mask = torch.zeros_like(a)
    mask[:, 100:200, 100:200] = 1.0
    patch = torch.rand(a.shape, generator=gen, device="cuda") * mask

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    cfg = PatchAttackConfig(max_count=PATCH_ITERS, loss_threshold=0.0)
    one = dataclasses.replace(cfg, max_count=1)
    target = -1.0 * predict_flow(model, a, b)
    # warm-up; its one iteration's loss is the first loss of the main run
    first = make_patch_attack_step(predict, one)(a, b, patch, mask, patch,
                                                 target)[3].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches over the clean flow and
    # the inner loop
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    target = -1.0 * predict_flow(model, a, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adv_tgt, adv_ref, new, loss, count = make_patch_attack_step(
        predict, cfg)(a, b, patch, mask, patch, target)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    n = {k: LAUNCH_COUNTS[k] for k in ("spatial_corr_fwd", "spatial_corr_bwd")}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(count == PATCH_ITERS and n == {"spatial_corr_fwd": PATCH_ITERS + 1,
                                         "spatial_corr_bwd": PATCH_ITERS},
          f"patch step: {count} iterations, launches {n}, not "
          f"{PATCH_ITERS} and one of each per iteration plus the clean "
          "flow's forward")
    res["ms_per_iter"] = 1e3 * dt / PATCH_ITERS
    res["iters_per_s"] = PATCH_ITERS / dt
    res["clean_flow_ms"] = 1e3 * (t1 - t0)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    outside = mask == 0
    check(torch.equal(adv_tgt[outside], a[outside])
          and torch.equal(adv_ref[outside], b[outside]),
          "patch step: adversarial images differ from the clean ones outside "
          "the mask")
    check(0.0 <= min(adv_tgt.min().item(), adv_ref.min().item())
          and max(adv_tgt.max().item(), adv_ref.max().item()) <= 1.0,
          "patch step: adversarial images outside [0, 1]")
    last = loss.item()
    res["loss_first"], res["loss_last"] = first, last
    print(f"patch step: launches {n}; {count} iterations; cossim loss "
          f"{first:.6f} -> {last:.6f} (last one evaluated); "
          f"{res['ms_per_iter']:.2f} ms per inner iteration, "
          f"{res['iters_per_s']:.2f} iterations/s ({PATCH_ITERS} iterations, "
          f"{1e3 * dt:.0f} ms; clean flow {res['clean_flow_ms']:.1f} ms); "
          f"peak memory {res['peak_mem_gib']:.2f} GiB", flush=True)
    check(math.isfinite(last) and last < first,
          "patch step: the loss is not finite or did not fall")
    del adv_tgt, adv_ref, new

    # one iteration's update, 0.5 lr (g_tgt + g_ref) clamped, with the
    # kernels and with the plain correlation (f32, TF32 off), held to phase
    # 15's image-gradient bound, with its witnesses: the leaky-ReLU inputs
    # whose sign differs between the two forwards, and each update's
    # distance to the update in f64 with the plain correlation
    step = make_patch_attack_step(predict, one)
    signs, updates = [], []
    for plain in (False, True):
        model.module.plain_corr = plain
        with leaky_relu_signs(model.module) as sign:
            updates.append(step(a, b, patch, mask, patch, target)[2] - patch)
        signs.append(sign)
    flips = sum(int((p != q).sum()) for p, q in zip(*signs))
    n_act = sum(p.numel() for p in signs[0])
    del signs
    model.module.plain_corr = True
    model.module.double()
    try:
        d = [x.double() for x in (a, b, patch, mask, target)]
        exact = step(d[0], d[1], d[2], d[3], d[2], d[4])[2] - d[2]
    finally:
        model.module.float()
        model.module.plain_corr = False

    def rel(u, v):
        return ((u.double() - v.double()).norm() / v.double().norm()).item()

    r = rel(updates[0], updates[1])
    res["update_rel_l2"] = r
    res["update_witness"] = {"leaky_relu_sign_flips": flips,
                             "leaky_relu_inputs": n_act,
                             "kernel_to_f64": rel(updates[0], exact),
                             "plain_to_f64": rel(updates[1], exact)}
    clamped = (exact.abs() >= 2.0).double().mean().item()
    print(f"f32 FlowNetC patch update with the kernels vs plain correlation, "
          f"rel L2 {r:.3e} (bound {GRAD_F32_REL_L2[0]:g}); leaky-ReLU inputs "
          f"of another sign: {flips} of {n_act}; rel L2 to the f64 update: "
          f"kernels {res['update_witness']['kernel_to_f64']:.3e}, plain "
          f"{res['update_witness']['plain_to_f64']:.3e}; share of the canvas "
          f"at the +-2 clamp {clamped:.2e}", flush=True)
    check(updates[1].abs().max().item() > 0 and r <= GRAD_F32_REL_L2[0],
          "patch step: update with the kernels beyond bound of the plain "
          "correlation's")
    return res


def patch_cli_phase() -> dict:
    """The patch CLI on FlowNetC at the reference's largest patch (0.4 of
    384: a 153-pixel circle), 2 epochs of 3 synthetic 384x1280 batches;
    then test_patch on its epoch-1 patch in the default, --true_motion and
    --different_pos modes."""
    from understanding_flow_robustness_tpu_torch.cli import (
        patch_attack as cli_patch,
    )
    from understanding_flow_robustness_tpu_torch.cli import test_patch
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== patch CLI: FlowNetC, --synthetic 3 at {PH}x{PW}, --patch-size "
          "0.4, --epochs 2 --max-count 2 ==", flush=True)
    out = PATCH_OUT / "flownetc"
    shutil.rmtree(out, ignore_errors=True)
    res = {}
    argv = ["--flownet", "FlowNetC", "--synthetic", "3", "--synthetic-size",
            str(PH), str(PW), "--image-size", "384", "--patch-size", "0.4",
            "--epochs", "2", "--max-count", "2", "--output", str(out),
            "--name", "run"]
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    with recording(cli_patch, "make_patch_attack_step", True) as steps, \
            recording(cli_patch, "validate_patch") as metrics:
        patch, _ = cli_patch.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = [r[4] for r, _ in steps]
    # the steps after the first (which runs the backward's first, tuning
    # pass): ms per inner iteration inside the CLI
    res["cli_ms_per_iter"] = (1e3 * sum(t for _, t in steps[1:])
                              / sum(counts[1:]))
    # per epoch: 3 batches of a clean forward and their inner iterations,
    # 1 validation sample of a clean and an adversarial forward
    expect = {"spatial_corr_fwd": len(counts) + sum(counts) + 2 * 2,
              "spatial_corr_bwd": sum(counts)}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(len(counts) == 6 and n == expect,
          f"patch CLI: {len(counts)} batches of {counts} iterations, "
          f"launches {n}, not {expect}")
    for e in (0, 1):
        f = out / "run" / "patches" / f"epoch_{e}.npy"
        check(f.exists() and np.load(f).shape == (1, 153, 153, 3),
              f"patch CLI: {f.name} missing or not (1, 153, 153, 3)")
    check(len(metrics) == 2 and all(math.isfinite(v) for m in metrics
                                    for v in m.values()),
          f"patch CLI: validation metrics {metrics}")
    print(f"patch CLI: {len(counts)} batches of {counts} inner iterations "
          f"({res['cli_ms_per_iter']:.2f} ms each after the first batch); "
          f"launches {n}; patches/epoch_{{0,1}}.npy (1, 153, 153, 3); epoch "
          f"1 epe {metrics[1]['epe']:.3f} adv_epe {metrics[1]['adv_epe']:.3f} "
          f"cos_sim {metrics[1]['cos_sim']:.3f} adv_cos_sim "
          f"{metrics[1]['adv_cos_sim']:.3f}; {dt:.1f} s", flush=True)
    check(patch.shape == (1, 153, 153, 3), "patch CLI: patch malformed")

    for mode, suffix in (([], ""), (["--true_motion"], "_true_motion"),
                         (["--different_pos"], "_different_pos")):
        LAUNCH_COUNTS.clear()
        avg = test_patch.main([
            "--patch_path", str(out / "run" / "patches" / "epoch_1.npy"),
            "--synthetic", "2", "--synthetic-size", str(PH), str(PW),
            "--no_viz", "--output", str(out)] + mode)
        n = LAUNCH_COUNTS["spatial_corr_fwd"]
        res["launches/spatial_corr_fwd"] += n
        d = out / "test_patch"
        rows = (d / f"test_result_scenes{suffix}.csv").read_text().splitlines()
        check(n == 4 and len(rows) == 3 and len(avg) == 4
              and all(math.isfinite(v) for v in avg)
              and (d / f"test_results{suffix}.csv").exists(),
              f"test_patch{suffix}: launches {n}, {len(rows)} CSV rows, "
              f"averages {avg}")
        print(f"test_patch{suffix or ' (default)'}: 2 scenes, launches "
              f"{n}; epe {avg[0]:.3f} adv_epe {avg[1]:.3f} cos_sim "
              f"{avg[2]:.3f} adv_cos_sim {avg[3]:.3f}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return res


def patch_lookup_phase() -> tuple:
    """B1 and B2 against their plain versions at the feature shape the
    RAFT patch CLI gives them (batch PB at PHxPW: (1, 48, 160, 256)), with
    calibrated, wild, edge and smooth centres, from a generator of this
    phase's own."""
    gen = torch.Generator(device="cuda").manual_seed(PATCH_SEED + 1)
    shape = (PB, PH // 8, PW // 8, 256)
    return (kernel_phase(gen, shape, main="patch", ragged=False),
            backward_phase(gen, shape, more=(), main="patch", ragged=False))


def patch_cli_raft_phase() -> dict:
    """The patch CLI on RAFT (mixed precision): 12 launches of each lookup
    kernel per inner iteration, none of the coordinate gradient's; then one
    inner iteration's update with the kernels against the plain lookup's
    at phase 16's geometry, bf16 and f32."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PatchAttackConfig,
        make_patch_attack_step,
    )
    from understanding_flow_robustness_tpu_torch.cli import (
        patch_attack as cli_patch,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== patch CLI: RAFT, --synthetic 2 at {PH}x{PW}, --patch-size 0.4, "
          "--epochs 1 --max-count 2 ==", flush=True)
    out = PATCH_OUT / "raft"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--flownet", "RAFT", "--synthetic", "2", "--synthetic-size",
            str(PH), str(PW), "--patch-size", "0.4", "--epochs", "1",
            "--max-count", "2", "--output", str(out)]
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    with recording(cli_patch, "make_patch_attack_step", True) as steps, \
            recording(cli_patch, "validate_patch") as metrics:
        cli_patch.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = [r[4] for r, _ in steps]
    ms_per_iter = 1e3 * steps[-1][1] / counts[-1]
    expect = {"alt_corr_fwd": ITERS * (len(counts) + sum(counts) + 2),
              "alt_corr_bwd": ITERS * sum(counts), "alt_corr_dcoords": 0}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(len(counts) == 2 and sum(counts) > 0 and n == expect,
          f"RAFT patch CLI: {len(counts)} batches of {counts} iterations, "
          f"launches {n}, not {expect}")
    check(len(metrics) == 1 and all(math.isfinite(v) for v in
                                    metrics[0].values()),
          f"RAFT patch CLI: validation metrics {metrics}")
    print(f"RAFT patch CLI: {counts} inner iterations ({ms_per_iter:.2f} ms "
          f"each in the second batch); launches {n} ({ITERS} of each lookup "
          f"kernel per iteration); epe {metrics[0]['epe']:.3f} adv_epe "
          f"{metrics[0]['adv_epe']:.3f}; {dt:.1f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    res = {"ms_per_iter": ms_per_iter,
           **{f"launches/{k}": v for k, v in n.items()}}

    # one inner iteration's update, 0.5 lr (g_tgt + g_ref) clamped, with
    # the kernels and with the plain lookup, batch 1 at 384x1280 with phase
    # 16's images, mask and patch, in bf16 autocast (how the CLI serves
    # RAFT) and in f32 (TF32 off), with the CLI's own seeded weights (their
    # ~150 px iterates put the lookups' centres far off the grid) and with
    # the flow head scaled to trained magnitudes (calibrated).  Held, as
    # attack_phase holds the image gradient: the calibrated l2 update, f32
    # and bf16.  Printed: the CLI's cossim loss, which starts at its
    # stationary point (the target is -flow), so its update is the small
    # flow change the patch makes and carries each path's rounding; and
    # each bf16 update's distance to the f32 plain one
    gen = torch.Generator(device="cuda").manual_seed(PATCH_SEED)
    a = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    b = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    mask = torch.zeros_like(a)
    mask[:, 100:200, 100:200] = 1.0
    patch = torch.rand(a.shape, generator=gen, device="cuda") * mask
    bases = {"bf16": fetch_model("RAFT", device="cuda", seed=0),
             "f32": fetch_model("RAFT", device="cuda", seed=0,
                                mixed_precision=False)}

    def rel(u, v):
        return ((u - v).norm() / v.norm()).item()

    for kind in ("cli_weights", "calibrated"):
        models = {}
        for prec, base in bases.items():
            module = (base.module if kind == "cli_weights"
                      else scale_flow_head(base.module, 0.05))
            models[prec, "kernels"] = FlowModel("RAFT", module, base.device)
            models[prec, "plain"] = FlowModel("RAFT", copy.deepcopy(module),
                                              base.device)
            models[prec, "plain"].module.plain_lookup = True
        target = -1.0 * predict_flow(models["bf16", "kernels"], a, b)
        for loss in ("l2", "cossim"):
            cfg = PatchAttackConfig(max_count=1, loss_threshold=0.0,
                                    l2=loss == "l2")
            u = {}
            for key, mm in models.items():
                step = make_patch_attack_step(
                    lambda x, y, mm=mm: predict_flow_differentiable(mm, x, y),
                    cfg)
                u[key] = step(a, b, patch, mask, patch, target)[2] - patch
                check(bool(torch.isfinite(u[key]).all())
                      and u[key].abs().max().item() > 0,
                      f"RAFT patch update ({kind}, {loss}, {key}): not "
                      "finite or zero")
            r16 = rel(u["bf16", "kernels"], u["bf16", "plain"])
            r32 = rel(u["f32", "kernels"], u["f32", "plain"])
            ref = u["f32", "plain"]
            w = (rel(u["bf16", "kernels"], ref), rel(u["bf16", "plain"], ref))
            held = kind == "calibrated" and loss == "l2"
            tag = f"{kind}/{loss}"
            res[f"update_rel_l2/{tag}/bf16"] = r16
            res[f"update_rel_l2/{tag}/f32"] = r32
            res[f"update_to_f32/{tag}"] = w
            print(f"RAFT patch update ({kind}, {loss}), kernels vs plain "
                  f"lookup: bf16 rel L2 {r16:.3e} (bound "
                  f"{GRAD_BF16_REL_L2[0]:g}), f32 {r32:.3e} (bound "
                  f"{GRAD_F32_REL_L2[0]:g}){'' if held else ', not held'}; "
                  f"bf16 to the f32 plain update: kernels {w[0]:.3e}, "
                  f"plain {w[1]:.3e}; share at the +-2 clamp "
                  f"{(ref.abs() >= 2.0).float().mean().item():.2e}",
                  flush=True)
            if held:
                check(r16 <= GRAD_BF16_REL_L2[0]
                      and r32 <= GRAD_F32_REL_L2[0],
                      "RAFT patch update with the kernels beyond bound of "
                      "the plain lookup's")
            del u
        del models
    return res


def universal_phase() -> dict:
    """The universal-perturbation CLI on FlowNetC at its defaults (256x640,
    ifgsm, cossim, eps 0.02) for one epoch of 2 synthetic batches of 3
    steps; then the attack CLI's --universal_evaluation of its snapshot;
    then the CLI once more with --flow_loss l2, each batch's steps checked
    to lower the loss."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        flow_attack_loss,
    )
    from understanding_flow_robustness_tpu_torch.cli import (
        run_perturb_model,
        universal_perturbation,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== universal perturbation CLI: FlowNetC, --synthetic 2 --epochs 1 "
          "--n_step 3 ==", flush=True)
    out = PATCH_OUT / "universal"
    shutil.rmtree(out, ignore_errors=True)
    res = {}
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    with recording(universal_perturbation, "make_universal_attack_step",
                   True) as steps:
        n0, n1 = universal_perturbation.main([
            "--synthetic", "2", "--epochs", "1", "--n_step", "3", "--seed",
            "1", "--output_path", str(out)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # the second batch's 3 steps (the first runs the backward's first,
    # tuning pass)
    res["ms_per_step"] = 1e3 * steps[-1][1] / 3
    # per batch a clean forward and 3 steps; the epoch's report 2 forwards
    expect = {"spatial_corr_fwd": 2 * (1 + 3) + 2, "spatial_corr_bwd": 2 * 3}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    res.update({f"launches/{k}": v for k, v in n.items()})
    nmax = max(np.abs(n0).max(), np.abs(n1).max())
    check(n == expect, f"universal CLI: launches {n}, not {expect}")
    check(0 < nmax <= 0.02 + 1e-6, f"universal CLI: max|noise| {nmax}")
    run_dir = (out / "kitti2015" / "FlowNetC" / "universal" / "both"
               / "ifgsm_cossim" / "0.02" / "0.002_3_1")
    snap = np.load(run_dir / "perturbations" / "epoch_0.npy")
    check(snap.shape == (1, 2, 256, 640, 3), f"universal CLI: snapshot "
                                             f"{snap.shape}")
    print(f"universal CLI: launches {n} (one spatial_corr_bwd per step); "
          f"max|noise| {nmax:.4f} (eps 0.02); snapshot {snap.shape}; "
          f"{res['ms_per_step']:.2f} ms per step (second batch); {dt:.1f} s "
          "with the model's build", flush=True)

    LAUNCH_COUNTS.clear()
    ev = run_perturb_model.main([
        "--universal_evaluation", "--folder_name", "0.002_3_1",
        "--epoch_number", "0", "--perturb_method", "ifgsm", "--flow_loss",
        "cossim", "--synthetic", "2", "--output_path", str(out)])
    n = LAUNCH_COUNTS["spatial_corr_fwd"]
    res["launches/spatial_corr_fwd"] += n
    check(n == 2 * 3 and LAUNCH_COUNTS["spatial_corr_bwd"] == 0
          and (run_dir / "results0.txt").exists()
          and all(math.isfinite(v[0]) for v in ev.values()),
          f"universal evaluation: launches {n}, results0.txt "
          f"{(run_dir / 'results0.txt').exists()}")
    print(f"universal evaluation: read perturbations/epoch_0.npy; epe "
          f"{ev['flow_epe_origin'][0]:.3f} -> {ev['flow_epe'][0]:.3f}; "
          f"results0.txt written; spatial_corr_fwd {n}", flush=True)

    # the defaults' cossim descent toward -flow starts at cossim's
    # stationary point, where the gradient is rounding noise: run the CLI
    # once more in l2, where each batch's 3 steps must lower the loss
    losses = []
    make = universal_perturbation.make_universal_attack_step

    def make_checked(predict, cfg):
        step = make(predict, cfg)

        def loss(x, y, target):
            with torch.no_grad():
                return flow_attack_loss(predict(x, y), target, "l2").item()

        def checked(img0, img1, n0, n1, target):
            before = loss(torch.clamp(img0 + n0, 0.0, 1.0),
                          torch.clamp(img1 + n1, 0.0, 1.0), target)
            adv = step(img0, img1, n0, n1, target)
            losses.append((before, loss(adv[0], adv[1], target)))
            return adv
        return checked

    universal_perturbation.make_universal_attack_step = make_checked
    try:
        universal_perturbation.main([
            "--synthetic", "2", "--epochs", "1", "--n_step", "3", "--seed",
            "1", "--flow_loss", "l2", "--output_path", str(out)])
    finally:
        universal_perturbation.make_universal_attack_step = make
    res["l2_losses"] = losses
    print("universal CLI, --flow_loss l2: per batch the l2 loss to -flow "
          "before -> after its 3 steps: " + "; ".join(
              f"{u:.4f} -> {v:.4f}" for u, v in losses), flush=True)
    check(len(losses) == 2 and all(v < u for u, v in losses),
          f"universal CLI, l2: the steps did not lower the loss ({losses})")
    shutil.rmtree(out, ignore_errors=True)
    return res


def flownet2_phase(gen) -> tuple:
    """FlowNet2 serving REQUESTS requests of B pairs at HxW through
    ``predict_flow``: 4 ``warp_fwd`` and 1 ``spatial_corr_fwd`` launches a
    request, the flow against the same model with the plain warp and the
    plain correlation, pairs/s over the requests after the first, peak
    memory; then ``warp_fwd`` in border mode at FlowNet2's warp shape
    against its plain version, timed.  Returns (results, the model)."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== FlowNet2 serving, batch {B} at {H}x{W}, f32 ==", flush=True)
    res = {}
    model = fetch_model("FlowNet2", device="cuda", seed=0)
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while serving
    expect = {"warp_fwd": 4, "spatial_corr_fwd": 1}
    flows = []
    LAUNCH_COUNTS.clear()
    for i, (a, b) in enumerate(requests):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(LAUNCH_COUNTS)
        flows.append(predict_flow(model, a, b))
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0) for k in expect}
        check(n == expect, f"FlowNet2 request {i}: launches {n}, not "
                           f"{expect}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res.update({f"launches/{k}": LAUNCH_COUNTS[k] for k in expect})
    for i, flow in enumerate(flows):
        check(tuple(flow.shape) == (B, H, W, 2)
              and bool(torch.isfinite(flow).all()),
              f"FlowNet2 request {i}: flow malformed")
    res["pairs_per_s"] = B * (REQUESTS - 1) / dt
    res["ms_per_request"] = 1e3 * dt / (REQUESTS - 1)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    mag = torch.linalg.vector_norm(flows[0], dim=-1).mean().item()

    model.module.plain_warp = model.module.plain_corr = True
    plain = predict_flow(model, *requests[0])
    model.module.plain_warp = model.module.plain_corr = False
    diff = flows[0] - plain
    rel = (diff.norm() / plain.norm()).item()
    res["rel_l2_vs_plain"] = rel
    res["max_abs_px_vs_plain"] = diff.abs().max().item()
    print(f"FlowNet2: {res['pairs_per_s']:.2f} pairs/s "
          f"({res['ms_per_request']:.1f} ms per request of {B} pairs, "
          f"requests 2-{REQUESTS}); per request warp_fwd 4, "
          f"spatial_corr_fwd 1; mean |flow| {mag:.3f} px; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB; kernels vs plain warp and "
          f"correlation rel L2 {rel:.2e} (bound {FLOWNET2_REL_L2:g}), max "
          f"|dflow| {res['max_abs_px_vs_plain']:.2e} px", flush=True)
    check(rel <= FLOWNET2_REL_L2, "FlowNet2: flow with the kernels beyond "
                                  "bound of the plain versions'")
    del flows, plain, diff, requests

    # B4 in border mode at FlowNet2's warp shape: a smooth flow, f32
    b, c, h, w = WARP_FLOWNET2
    img = torch.rand((b, c, h, w), generator=gen, device="cuda")
    flow = warp_flow(gen, b, h, w, "smooth")
    got = ops.warp_backward(img, flow, "border")
    ref = ops.warp_backward_reference(img, flow, "border")
    err = (got - ref).abs().max().item()
    tol = WARP_F32_REL_TOL * img.abs().max().item()
    check(err <= tol, f"warp_fwd border at {WARP_FLOWNET2}: {err} > {tol}")
    k_ms = graph_ms(lambda: ops.warp_backward(img, flow, "border"), reps=50)
    p_ms = cuda_ms(lambda: ops.warp_backward_reference(img, flow, "border"),
                   reps=10)
    l_ms = graph_ms(grid_sample_call(img, flow, "border"), reps=50)
    res["warp"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                   "library_ms": l_ms,
                   **bound(nbytes(img, flow, got), 8 * b * c * h * w,
                           torch.float32)}
    wb = res["warp"]
    print(f"warp_fwd border {WARP_FLOWNET2} f32: max_abs_err={err:.3e} "
          f"(tol {tol:.1e}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"grid_sample {l_ms:.4f} ms, bound {wb['bound_ms']:.4f} ms "
          f"({wb['bound_by']}; the kernel at "
          f"{100 * wb['bound_ms'] / k_ms:.0f}% of it)", flush=True)
    return res, model


def flownet2_attack_phase(model) -> dict:
    """I-FGSM with the attack CLI's defaults on FlowNet2 (f32) at the
    attack geometry: per step 4 ``warp_fwd``, 1 ``spatial_corr_fwd`` and 1
    ``spatial_corr_bwd``; then one image gradient with the kernels against
    one with the plain warp and correlation; then the attack CLI on
    FlowNet2."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PerturbConfig,
        flow_attack_loss,
        make_attack,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        predict_flow,
        predict_flow_differentiable,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== I-FGSM on FlowNet2, batch {AB} at {AH}x{AW}, {ATTACK_STEPS} "
          f"steps, eps {ATTACK_EPS}, l2 ==", flush=True)
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(ATTACK_SEED)
    a = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    b = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    flow = predict_flow(model, a, b)
    gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=ATTACK_EPS, n_step=ATTACK_STEPS)
    make_attack(predict, dataclasses.replace(cfg, n_step=2))(a, b, gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while attacking
    expect = {"warp_fwd": 4 * ATTACK_STEPS,
              "spatial_corr_fwd": ATTACK_STEPS,
              "spatial_corr_bwd": ATTACK_STEPS}
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    n0, n1, adv0, adv1 = make_attack(predict, cfg)(a, b, gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(n == expect, f"FlowNet2 attack: launches {n}, not {expect}")
    res["ms_per_step"] = 1e3 * dt / ATTACK_STEPS
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    nmax = max(n0.abs().max().item(), n1.abs().max().item())
    check(nmax <= ATTACK_EPS + 1e-6, f"FlowNet2 attack: noise {nmax} outside "
                                     "the eps-ball")
    check(0.0 <= min(adv0.min().item(), adv1.min().item())
          and max(adv0.max().item(), adv1.max().item()) <= 1.0,
          "FlowNet2 attack: adversarial images outside [0, 1]")
    with torch.no_grad():
        before = flow_attack_loss(predict(a, b), gt, "l2").item()
        after = flow_attack_loss(predict(adv0, adv1), gt, "l2").item()
    res["loss_clean"], res["loss_attacked"] = before, after
    print(f"FlowNet2 attack: launches {n}; max|noise|={nmax:.4f}; l2 loss "
          f"{before:.3f} -> {after:.3f}; {res['ms_per_step']:.2f} ms per step "
          f"({ATTACK_STEPS} steps, {1e3 * dt:.0f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    check(after > before, "FlowNet2 attack: the l2 loss did not grow")

    # one image gradient with the kernels, one with the plain warp and
    # correlation (f32, TF32 off)
    grads = []
    for plain in (False, True):
        model.module.plain_warp = model.module.plain_corr = plain
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        loss = flow_attack_loss(predict(x, y), gt, "l2")
        grads.append(torch.autograd.grad(loss, (x, y)))
    model.module.plain_warp = model.module.plain_corr = False
    rels = [((p - q).norm() / q.norm()).item() for p, q in zip(*grads)]
    check(all(bool(torch.isfinite(g).all()) for g in grads[0]),
          "FlowNet2: non-finite image gradient")
    res["image_grad_rel_l2"] = max(rels)
    print(f"f32 FlowNet2: image gradient with the kernels vs plain warp and "
          f"correlation, rel L2 {rels[0]:.3e} / {rels[1]:.3e} (bound "
          f"{FLOWNET2_GRAD_REL_L2:g})", flush=True)
    check(max(rels) <= FLOWNET2_GRAD_REL_L2, "FlowNet2: image gradient with "
          "the kernels beyond bound of the plain versions'")
    del grads
    cli = attack_cli_phase("FlowNet2")
    res.update({f"cli_{k}": v for k, v in cli.items()})
    return res


def corruption_phase() -> dict:
    """The attack CLI's corruption sweep on its default FlowNetC:
    ``--perturb_method gaussian_noise --synthetic 2``, severities 1-5 on
    the host, one ``spatial_corr_fwd`` per forward (the clean, corrupted
    and noise-only flows of each pair), the five results folders."""
    from understanding_flow_robustness_tpu_torch.cli import run_perturb_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== corruption sweep: FlowNetC, gaussian_noise, severities 1-5, "
          "--synthetic 2 ==", flush=True)
    out = PATCH_OUT / "corruption"
    shutil.rmtree(out, ignore_errors=True)
    seen = []
    run = run_perturb_model.run

    def timed_run(predict, samples, cfg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run(predict, samples, cfg)
        torch.cuda.synchronize()
        seen.append((cfg.output_path, r, time.perf_counter() - t))
        return r

    LAUNCH_COUNTS.clear()
    run_perturb_model.run = timed_run
    try:
        run_perturb_model.main(["--perturb_method", "gaussian_noise",
                                "--synthetic", "2", "--output_path",
                                str(out)])
    finally:
        run_perturb_model.run = run
    expect = {"spatial_corr_fwd": 5 * 2 * 3, "spatial_corr_bwd": 0}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"corruption sweep: launches {n}, not {expect}")
    base = out / "kitti2015" / "FlowNetC" / "both" / "gaussian_noise"
    check([Path(p) for p, _, _ in seen] == [base / str(s)
                                             for s in range(1, 6)],
          f"corruption sweep: folders {[p for p, _, _ in seen]}")
    for p, r, _ in seen:
        check((Path(p) / "results0.txt").exists()
              and all(math.isfinite(v[0]) for v in r.values()),
              f"corruption sweep: {p} has no results0.txt or a non-finite "
              "metric")
    l1 = [r["noise0_l1pix"][0] for _, r, _ in seen]
    check(all(u < v for u, v in zip(l1, l1[1:])),
          f"corruption sweep: the noise does not grow with the severity {l1}")
    secs = [t for _, _, t in seen]
    print(f"corruption sweep: launches {n}; results0.txt in 5 folders; "
          "mean |noise| by severity " + ", ".join(f"{v:.4f}" for v in l1)
          + "; epe " + ", ".join(f"{r['flow_epe'][0]:.3f}" for _, r, _ in seen)
          + "; seconds per severity (2 pairs, host corruption included) "
          + ", ".join(f"{t:.2f}" for t in secs), flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return {"launches/spatial_corr_fwd": n["spatial_corr_fwd"],
            "s_per_severity": secs}


def adv_train_phase() -> dict:
    """The train CLI's adversarial training on RAFT (the registry's, mixed
    precision) at the attack geometry, batch 1, ADV_TRAIN_STEPS I-FGSM
    steps and ADV_INNER updates a batch: the launches of the lookup
    kernels (12 a forward or backward, none of ``alt_corr_dcoords``),
    the train step on the doubled batch, finite losses, moved parameters,
    ms per batch."""
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train
    from understanding_flow_robustness_tpu_torch.models import fetch_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import (
        checkpoint,
        trainer,
    )

    print(f"== adversarial train CLI: RAFT, batch {AB} at {AH}x{AW}, "
          f"{ADV_TRAIN_STEPS} I-FGSM steps, {ADV_TRAIN_BATCHES} batches ==",
          flush=True)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_adv"
    shutil.rmtree(ckpt, ignore_errors=True)
    shapes, stamps, counts = [], [], []
    make_step = trainer.make_train_step

    def spy_step(*a, **k):
        step = make_step(*a, **k)

        def run(batch):
            shapes.append(tuple(batch["image1"].shape))
            out = step(batch)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts.append({k: LAUNCH_COUNTS[k] for k in
                           ("alt_corr_fwd", "alt_corr_bwd",
                            "alt_corr_dcoords")})
            return out
        return run

    argv = ["--model", "RAFT", "--adversarial", "--synthetic",
            str(ADV_TRAIN_BATCHES), "--num_steps",
            str(ADV_TRAIN_BATCHES - 1), "--batch_size", str(AB),
            "--image_size", str(AH), str(AW), "--perturb_n_step",
            str(ADV_TRAIN_STEPS), "--name", "adv", "--checkpoint_dir",
            str(ckpt)]
    LAUNCH_COUNTS.clear()
    trainer.make_train_step = spy_step
    try:
        out = cli_train.main(argv)
    finally:
        trainer.make_train_step = make_step
    per_batch = (ADV_TRAIN_STEPS + ADV_INNER) * ITERS
    expect = {"alt_corr_fwd": ADV_TRAIN_BATCHES * per_batch,
              "alt_corr_bwd": ADV_TRAIN_BATCHES * per_batch,
              "alt_corr_dcoords": 0}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"adversarial train CLI: launches {n}, not {expect}")
    # per batch: the attack's steps before its first update
    first = counts[ADV_INNER]["alt_corr_fwd"] - counts[ADV_INNER - 1][
        "alt_corr_fwd"]
    check(first == (ADV_TRAIN_STEPS + 1) * ITERS,
          f"adversarial train CLI: {first} alt_corr_fwd launches between "
          "batches, not the attack's and one update's")
    check(out["total_steps"] == ADV_TRAIN_BATCHES
          and len(shapes) == ADV_TRAIN_BATCHES * ADV_INNER
          and all(sh == (2 * AB, AH, AW, 3) for sh in shapes),
          f"adversarial train CLI: {out['total_steps']} batches, train-step "
          f"batches {shapes}")
    check(all(math.isfinite(m["loss"]) for m in out["history"]),
          "adversarial train CLI: non-finite loss")
    init = fetch_model("RAFT", device="cpu", seed=1234).module.state_dict()
    trained = checkpoint.load_weights(str(ckpt / "adv" / "adv.pth"),
                                      fetch_model("RAFT", device="cpu")
                                      .module).state_dict()
    moved = sum(not torch.equal(init[k], trained[k]) for k in init
                if init[k].is_floating_point() and "running" not in k)
    n_params = sum(1 for k in init if init[k].is_floating_point()
                   and "running" not in k)
    # AdamW moves every weight its gradient or its decay reaches; a zero
    # bias with an exactly zero gradient would stay
    check(moved >= 0.9 * n_params, f"adversarial train CLI: {moved} of "
                                   f"{n_params} parameter tensors moved")
    ms = 1e3 * (stamps[2 * ADV_INNER - 1] - stamps[ADV_INNER - 1])
    print(f"adversarial train CLI: launches {n} ({per_batch} of each lookup "
          f"kernel a batch: {ADV_TRAIN_STEPS} attack steps and {ADV_INNER} "
          f"updates of {ITERS} iterations); train step on {shapes[0]}; "
          f"losses " + ", ".join(f"{m['loss']:.3f}" for m in out["history"])
          + f"; {moved} of {n_params} parameter tensors moved; {ms:.1f} ms "
          "for the second batch (attack and 3 updates)", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"launches/alt_corr_fwd": n["alt_corr_fwd"],
            "launches/alt_corr_bwd": n["alt_corr_bwd"], "ms_per_batch": ms}


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
    KERNELS = _build.KERNELS
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
    dres = phase(dcoords_phase, gen)
    wres = phase(warp_phase, gen)
    vkres = phase(volume_kernel_phase, gen)
    mres = phase(model_phase, gen)
    vres = phase(volume_model_phase, gen)
    fres = phase(taps_phase, gen)
    cres = phase(wocontext_phase, gen)
    sres = phase(warp_model_phase, gen, "SpyNet", 6)
    pres = phase(warp_model_phase, gen, "PWCNet", 4, 5)
    tres = phase(train_phase, gen)
    phase(grad_phase, gen)
    scres = phase(spatial_corr_phase, gen)
    fnres = phase(flownet_phase, gen)
    ares = phase(attack_phase)
    fares = phase(flownetc_attack_phase)
    acres = phase(attack_cli_phase, "RAFT")
    afres = phase(attack_cli_phase)
    phase(cli_phase)
    psres = phase(patch_step_phase)
    pcres = phase(patch_cli_phase)
    plres, pbres = phase(patch_lookup_phase)
    prres = phase(patch_cli_raft_phase)
    ures = phase(universal_phase)
    f2res, flownet2 = phase(flownet2_phase, gen)
    f2ares = phase(flownet2_attack_phase, flownet2)
    del flownet2
    crres = phase(corruption_phase)
    atres = phase(adv_train_phase)
    print(f"all phases, build included: {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"patch attack, FlowNetC, batch {PB} at {PH}x{PW} ({card}): "
          f"{psres['ms_per_iter']:.3f} ms per inner iteration, "
          f"{psres['iters_per_s']:.2f} iterations/s; in the CLI "
          f"{pcres['cli_ms_per_iter']:.3f} ms; RAFT "
          f"{prres['ms_per_iter']:.3f} ms; universal step on FlowNetC at "
          f"256x640 {ures['ms_per_step']:.3f} ms", flush=True)
    print(f"FlowNet2, batch {B} at {H}x{W} ({card}): "
          f"{f2res['pairs_per_s']:.2f} pairs/s; its I-FGSM at {AH}x{AW} "
          f"{f2ares['ms_per_step']:.2f} ms per step; adversarial train "
          f"batch on RAFT at {AH}x{AW} {atres['ms_per_batch']:.1f} ms",
          flush=True)

    print(card)  # name, power limit: nvidia-smi's own line

    def patch_err(r):  # the worst case at the RAFT patch CLI's shape
        return max(v for k, v in r.items() if k.startswith("patch/")
                   and k.count("/") == 2)
    fwd = "main/calibrated/bfloat16"
    warp = wres["spynet/main"]
    vol = vkres["main/calibrated/bfloat16/main"]
    print(json.dumps({"kernels": [{
        "name": "alt_corr_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:91",
        "launches": (mres["launches"] + cres["launches"]
                     + tres["launches/alt_corr_fwd"]
                     + ares["launches/alt_corr_fwd"]
                     + acres["launches/alt_corr_fwd"]
                     + prres["launches/alt_corr_fwd"]
                     + atres["launches/alt_corr_fwd"]),
        "max_abs_err": kres[fwd],
        "ms": kres[f"{fwd}/ms"],
        "plain_ms": kres[f"{fwd}/plain_ms"],
        **kres[f"{fwd}/bound"],
        "library_ms": None,
        "smooth_ms": kres["main/smooth/bfloat16/ms"],
        "wild_ms": kres["main/wild/bfloat16/ms"],
        "serving_tile_share": mres["calibrated/tile_share"],
        "serving_wild_tile_share": mres["wild/tile_share"],
        "patch_shape_max_abs_err": patch_err(plres),
        "patch_shape_ms": plres["patch/calibrated/bfloat16/ms"],
        "patch_shape_plain_ms": plres["patch/calibrated/bfloat16/plain_ms"],
        "patch_shape_bound_ms":
            plres["patch/calibrated/bfloat16/bound"]["bound_ms"],
    }, {
        "name": "alt_corr_bwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_bwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:571",
        "launches": (tres["launches/alt_corr_bwd"]
                     + ares["launches/alt_corr_bwd"]
                     + acres["launches/alt_corr_bwd"]
                     + prres["launches/alt_corr_bwd"]
                     + atres["launches/alt_corr_bwd"]),
        "max_abs_err": bres[fwd],
        "ms": bres[f"{fwd}/ms"],
        "plain_ms": bres[f"{fwd}/plain_ms"],
        **bres[f"{fwd}/bound"],
        "library_ms": None,
        "smooth_ms": bres["main/smooth/bfloat16/ms"],
        "attack_ms": bres["attack/calibrated/bfloat16/ms"],
        "attack_bound_ms":
            bres["attack/calibrated/bfloat16/bound"]["bound_ms"],
        "train_step_tile_share": tres["tile_share"],
        "patch_shape_max_abs_err": patch_err(pbres),
        "patch_shape_ms": pbres["patch/calibrated/bfloat16/ms"],
        "patch_shape_plain_ms": pbres["patch/calibrated/bfloat16/plain_ms"],
        "patch_shape_bound_ms":
            pbres["patch/calibrated/bfloat16/bound"]["bound_ms"],
        "raft_patch_update_rel_l2_bf16":
            prres["update_rel_l2/calibrated/l2/bf16"],
        "raft_patch_update_rel_l2_f32":
            prres["update_rel_l2/calibrated/l2/f32"],
    }, {
        "name": "alt_corr_dcoords",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_dcoords.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:91",
        "launches": dres["launches"],
        "max_abs_err": dres[fwd],
        "ms": dres[f"{fwd}/ms"],
        "plain_ms": dres[f"{fwd}/plain_ms"],
        **dres[f"{fwd}/bound"],
        "library_ms": None,
    }, {
        "name": "warp_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/warp_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/warp_tile.py:53",
        "launches": (sres["launches"] + pres["launches"]
                     + ares["pwc_launches/warp_fwd"]
                     + f2res["launches/warp_fwd"]
                     + f2ares["launches/warp_fwd"]
                     + f2ares["cli_launches/warp_fwd"]),
        "max_abs_err": warp["max_abs_err"],
        "ms": warp["ms"],
        "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"],
        "bound_by": warp["bound_by"],
        "library_ms": warp["library_ms"],
        "grid_sample_ms": warp["library_ms"],
        "launched_ms": warp["launched_ms"],
        "flownet2_border_max_abs_err": f2res["warp"]["max_abs_err"],
        "flownet2_border_ms": f2res["warp"]["ms"],
        "flownet2_border_plain_ms": f2res["warp"]["plain_ms"],
        "flownet2_border_bound_ms": f2res["warp"]["bound_ms"],
        "flownet2_border_grid_sample_ms": f2res["warp"]["library_ms"],
    }, {
        "name": "corr_lookup_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/corr_lookup_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/corr_lookup_fused.py:59",
        "launches": vres["launches"] + fres["launches"],
        "max_abs_err": vol["max_abs_err"],
        "ms": vol["ms"],
        "plain_ms": vol["plain_ms"],
        "bound_ms": vol["bound_ms"],
        "bound_by": vol["bound_by"],
        "library_ms": vol["library_ms"],
        "grid_sample_ms": vol["library_ms"],
    }, {
        "name": "spatial_corr_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/spatial_corr_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/correlation.py:56",
        "launches": (fnres["launches"] + pres["corr_launches"]
                     + ares["pwc_launches/spatial_corr_fwd"]
                     + fares["launches/spatial_corr_fwd"]
                     + afres["launches/spatial_corr_fwd"]
                     + psres["launches/spatial_corr_fwd"]
                     + pcres["launches/spatial_corr_fwd"]
                     + ures["launches/spatial_corr_fwd"]
                     + f2res["launches/spatial_corr_fwd"]
                     + f2ares["launches/spatial_corr_fwd"]
                     + f2ares["cli_launches/spatial_corr_fwd"]
                     + crres["launches/spatial_corr_fwd"]),
        "max_abs_err": scres["flownetc"]["fwd_err"],
        "ms": scres["flownetc"]["ms"],
        "plain_ms": scres["flownetc"]["plain_ms"],
        "bound_ms": scres["flownetc"]["bound_ms"],
        "bound_by": scres["flownetc"]["bound_by"],
        "library_ms": None,
        "pwc_l2_ms": scres["pwc_l2"]["ms"],
        "pwc_l2_plain_ms": scres["pwc_l2"]["plain_ms"],
        "pwc_l2_bound_ms": scres["pwc_l2"]["bound_ms"],
        "patch_shape_max_abs_err": scres["patch"]["fwd_err"],
        "patch_shape_ms": scres["patch"]["ms"],
        "patch_shape_plain_ms": scres["patch"]["plain_ms"],
        "patch_shape_bound_ms": scres["patch"]["bound_ms"],
    }, {
        "name": "spatial_corr_bwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/spatial_corr_bwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/correlation.py:56",
        "launches": (ares["pwc_launches/spatial_corr_bwd"]
                     + fares["launches/spatial_corr_bwd"]
                     + afres["launches/spatial_corr_bwd"]
                     + psres["launches/spatial_corr_bwd"]
                     + pcres["launches/spatial_corr_bwd"]
                     + ures["launches/spatial_corr_bwd"]
                     + f2ares["launches/spatial_corr_bwd"]
                     + f2ares["cli_launches/spatial_corr_bwd"]),
        "max_abs_err": scres["attack"]["bwd_err"],
        "ms": scres["attack/bwd"]["ms"],
        "plain_ms": scres["attack/bwd"]["plain_ms"],
        "bound_ms": scres["attack/bwd"]["bound_ms"],
        "bound_by": scres["attack/bwd"]["bound_by"],
        "library_ms": None,
        "pwc_l2_ms": scres["pwc_l2/bwd"]["ms"],
        "pwc_l2_plain_ms": scres["pwc_l2/bwd"]["plain_ms"],
        "pwc_l2_bound_ms": scres["pwc_l2/bwd"]["bound_ms"],
        "patch_shape_max_abs_err": scres["patch"]["bwd_err"],
        "patch_shape_ms": scres["patch/bwd"]["ms"],
        "patch_shape_plain_ms": scres["patch/bwd"]["plain_ms"],
        "patch_shape_bound_ms": scres["patch/bwd"]["bound_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
