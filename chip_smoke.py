#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA device and prints its name and power limit.
2. Builds the CUDA kernel from ``understanding_flow_robustness_tpu_torch/
   csrc/`` (into ``build/torch_kernels/``) and prints the build time.
3. Holds the kernel against its plain PyTorch version on the card, at the
   RAFT main path's shape and at a ragged shape, in f32 and bf16, for
   calibrated, wild and out-of-volume centres; times both at the main
   path's shape.
4. Drives the main path: RAFT-12 (seeded random weights) serving 3 requests
   of 8 frame pairs at 384x1280 through ``predict_flow``, at the calibrated
   (``scale_flow_head(0.05)``) and the wild (raw init) operating point;
   checks shapes, finiteness and that every forward launched the kernel 12
   times; compares the flow with the plain lookup; times pairs/s.

Any failed check raises, so the script exits non-zero and prints no result.
The last two lines are a JSON object per kernel and the result object.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

B, H, W = 8, 384, 1280
REQUESTS = 3
ITERS = 12
RADIUS, LEVELS = 4, 4
F32_TOL = 1e-4           # abs, the JAX package's bar (test_ops_correlation.py:327)
BF16_REL_TOL = 1e-5      # x max|corr|: same bf16 inputs, both accumulate in f32
F32_FLOW_TOL_PX = 1e-2   # max abs flow difference, kernel vs plain lookup, f32
BF16_REL_EPE_TOL = 0.01  # mean EPE / mean |flow|, the 1% bar (BASELINE.md)
CAL_BAND = (5.0, 40.0)   # trained-checkpoint mean |flow| band (bench.py:115)
# sanity bounds of the calibrated magnitude (tests/test_bf16_drift.py:120):
# the random draw decides where in or near CAL_BAND it lands
CAL_SANITY = (1.0, 60.0)


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


def lookup_cases(gen):
    """(name, b, h, w, c, coords) for the kernel-vs-plain phase: the main
    path's feature shape and a ragged one whose pooled levels drop rows and
    columns, each with calibrated, wild and hand-placed edge centres."""
    from understanding_flow_robustness_tpu_torch.ops import coords_grid

    for shape_name, (b, h, w, c) in (("main", (B, H // 8, W // 8, 256)),
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

    print("== kernel vs plain (TF32 off) ==", flush=True)
    res = {}
    for name, b, h, w, c, coords in lookup_cases(gen):
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
                    print(f"{tag:32s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                          "per lookup (4 levels)", flush=True)
                else:
                    print(f"{tag:32s} kernel {k_ms:.3f} ms per lookup",
                          flush=True)
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
    _build.load_library("alt_corr_fwd")
    build_s = time.perf_counter() - t0
    log = _build.library_path("alt_corr_fwd").with_suffix(".log")
    print(f"build: alt_corr_fwd in {build_s:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS.get('alt_corr_fwd', 0.0):.2f} s)",
          flush=True)
    print(log.read_text().strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kres = kernel_phase(gen)
    mres = model_phase(gen)

    print(card)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": [{
        "name": "alt_corr_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:91",
        "launches": mres["launches"],
        "max_abs_err": kres["main/calibrated/bfloat16"],
        "ms": kres["main/calibrated/bfloat16/ms"],
        "plain_ms": kres["main/calibrated/bfloat16/plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
