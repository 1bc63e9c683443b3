#!/usr/bin/env python3
"""Time the port's lookup kernels (B1 ``csrc/alt_corr_fwd.cu``, its
backward B2 ``csrc/alt_corr_bwd.cu``, its coordinate gradient B3
``csrc/alt_corr_dcoords.cu``, the volume lookup B5
``csrc/corr_lookup_fwd.cu``), its warp kernel (B4, ``csrc/warp_fwd.cu``)
and its spatial-correlation kernels (``csrc/spatial_corr_fwd.cu``,
``csrc/spatial_corr_bwd.cu``) of one checkout, for an A/B of two commits
on one card.

    python3 scripts/torch_kernel_ab.py [--root DIR] [--reps 20] [--e2e]

``--root`` is the checkout whose ``understanding_flow_robustness_tpu_torch``
is imported (default: this one); its kernels are built there.  To compare
with the parent commit, unpack it into a directory that .gitignore lists
and run, in one call on one card, parent, change, change, parent:

    git archive HEAD~1 | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/torch_kernel_ab.py --root $r; done

Inputs are made on the card from fixed seeds, so every run times the same
values.  B1 is timed through ``correlation.alt_corr_lookup`` and B5
through ``ops.corr_lookup`` (on ``ops.volume_pyramid``) at RAFT's serving
shape (B=8, 48x160 queries, C=256, 4 levels), bf16 and f32, for
calibrated, smooth and wild (grid + 150 px of per-query noise) centres,
with B1's tile-path share where its wrapper counts paths.  B2 is timed
through ``correlation._alt_corr_bwd_cuda`` (the wrapper, with its zeroed
df2 levels) at RAFT's train shape (B=4, 36x120, C=256) and the attack
shape (B=1, 32x80, C=256), bf16, for per-query jittered ("calibrated":
grid + 2 px noise) and smooth (grid + a x4 bilinear upsample of 3 px
noise) centres; B3 through ``correlation._alt_corr_dcoords_cuda`` at
RAFT's serving shape (r = 4) and small RAFT's (r = 3, C=128), bf16 and
f32, for calibrated and wild centres, with its tile-path share where its
wrapper counts paths; B4 through ``ops.warp_backward`` at SPyNet's finest warp
(B=8, 3x384x1280, f32, "spynet") and PWC-Net's level 2 (B=8, 32x96x320,
bf16, "zeros_mask") on a smooth flow, beside ``F.grid_sample`` on the same
grid.  Times are CUDA-event means of back-to-back calls; B4's and
``grid_sample``'s are replayed from a CUDA graph (device time; a warp of
PWC-Net's is as short as the host's cost of one call), beside B4 launched
from Python ("launched_ms").  The bound is the bytes each input and output
moves once over 3.35 TB/s (for B1 and B3 the larger of that and their dots over
the inputs' peak rate; for B5 only the window taps inside the levels
count).
``--e2e`` adds what the kernels move end to end: RAFT-12 serving pairs/s
(batch 8 at 384x1280, 2 + 6 requests of ``predict_flow``) on the alt path
at the calibrated and the wild operating point, on the volume path
(calibrated) and for ``RAFT_FlowNetCEncoder_WoContext`` (calibrated);
RAFT-12 train frames/s (mixed precision, batch 4 at 288x960, 2 + 5 steps
of ``make_train_step``), I-FGSM steps/s (RAFT-12, batch 1 at 256x640, 2 +
10 steps of ``make_attack``), and, for 4 seeded image pairs at the attack
geometry, the relative L2 distance of the f32 image gradient with the
kernels from the one with the plain lookup (``chip_smoke.py``'s
attack-gradient check).  Where the checkout has them, ``--e2e`` also times
the correlation models serving 8 pairs at 384x1280 (2 + 6 requests of
``predict_flow``): PWC-Net in its registry precision (bf16 convolutions,
f32 flow heads), FlowNetC, Robust FlowNetC (``FlowNetCFlexLarger_k3_reps3``)
and FlowNetS in f32, FlowNetC again with its correlation's plain version
(``plain_corr``), and I-FGSM on FlowNetC (batch 1 at 256x640, the attack
CLI's 40 steps of eps 0.02, l2, after a 2-step warm-up) in ms per step,
and FlowNetC's inner patch iteration (batch 1 at 384x1280, a 100x100
mask, 16 iterations after a 2-iteration warm-up) in ms.  Where the
checkout has them, the spatial-correlation kernels are timed through their
wrappers: ``csrc/spatial_corr_fwd.cu`` at FlowNetC's serving shape (B=8,
C=256, 48x160, patch 21, dilation 2, f32) and PWC-Net's level 2 (B=8,
C=32, 96x320, patch 9, bf16), ``csrc/spatial_corr_bwd.cu`` at FlowNetC's
attack (B=1, 32x80) and patch (B=1, 48x160) shapes and PWC-Net's level 2.
Prints the card's name and power limit and one JSON line.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
RADIUS, LEVELS = 4, 4
LOOKUP_SHAPE = (8, 48, 160, 256)  # RAFT serving: batch 8 at 384x1280
B2_SHAPES = {"train": (4, 36, 120, 256), "attack": (1, 32, 80, 256)}
# B3's shapes: RAFT serving at r = 4, small RAFT serving at r = 3
B3_SHAPES = {"r4": ((8, 48, 160, 256), 4), "r3": ((8, 48, 160, 128), 3)}
B4_SHAPES = {"spynet": ((8, 3, 384, 1280), torch.float32),
             "zeros_mask": ((8, 32, 96, 320), torch.bfloat16)}
# the spatial correlation kernels' main shapes: (B, C, H, W), patch,
# dilation, dtype
SPATIAL_FWD = {"flownetc": ((8, 256, 48, 160), 21, 2, torch.float32),
               "pwc_l2": ((8, 32, 96, 320), 9, 1, torch.bfloat16)}
SPATIAL_BWD = {"attack": ((1, 256, 32, 80), 21, 2, torch.float32),
               "patch": ((1, 256, 48, 160), 21, 2, torch.float32),
               "pwc_l2": ((8, 32, 96, 320), 9, 1, torch.bfloat16)}


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
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
    and replayed between CUDA events (no per-call host cost)."""
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


def smooth_field(gen, b, h, w, amp):
    """(b, 2, h, w): a x4 bilinear upsample of amp-scaled noise."""
    coarse = amp * torch.randn((b, 2, h // 4 + 1, w // 4 + 1), generator=gen,
                               device="cuda")
    return torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                           align_corners=False)


def needed_taps(pyr, coords) -> int:
    """The volume taps this run's windows need: per query and level, the
    (2r+2)^2 integer taps around the centre inside the level."""
    c = coords.reshape(-1, 2).double()
    offs = torch.arange(-RADIUS, RADIUS + 2, device=coords.device)
    total = 0
    for lvl, p in enumerate(pyr):
        hl, wl = p.shape[2:]
        cx = (c[:, 0] / 2 ** lvl).clamp(-(RADIUS + 2.0), wl + RADIUS + 1.0)
        cy = (c[:, 1] / 2 ** lvl).clamp(-(RADIUS + 2.0), hl + RADIUS + 1.0)
        xs = cx.floor().long()[:, None] + offs
        ys = cy.floor().long()[:, None] + offs
        nx = ((xs >= 0) & (xs < wl)).sum(1)
        ny = ((ys >= 0) & (ys < hl)).sum(1)
        total += int((nx * ny).sum().item())
    return total


def time_b1_b5(ops, corr, reps: int) -> dict:
    import inspect

    counted = "path_counts" in inspect.signature(
        corr._alt_corr_lookup_cuda).parameters
    b, h, w, c = LOOKUP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    grid = ops.coords_grid(h, w, device="cuda")[None]
    kinds = {
        "calibrated": grid + 2.0 * torch.randn((b, h, w, 2), generator=gen,
                                               device="cuda"),
        "smooth": grid + smooth_field(gen, b, h, w, 3.0).permute(0, 2, 3, 1),
        "wild": grid + 150.0 * torch.randn((b, h, w, 2), generator=gen,
                                           device="cuda"),
    }
    res = {"b1": {}, "b5": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
        pyr = ops.volume_pyramid(fm1, fm2, LEVELS,
                                 None if dtype == torch.float32 else dtype)
        for kind, coords in kinds.items():
            coords = coords.contiguous()
            cflat = coords.reshape(b, h * w, 2)
            out = corr.alt_corr_lookup(f1, levels, cflat, RADIUS)
            ms = cuda_ms(lambda: corr.alt_corr_lookup(f1, levels, cflat,
                                                      RADIUS), reps)
            flops = 2 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
            entry = {"ms": ms, "bound_ms": 1e3 * max(
                nbytes(f1, *levels, cflat, out) / HBM_BYTES_PER_S,
                flops / PEAK_FLOPS[dtype])}
            if counted:
                counts = torch.zeros(2 * LEVELS, dtype=torch.int32,
                                     device="cuda")
                corr._alt_corr_lookup_cuda(f1, levels, cflat, RADIUS,
                                           path_counts=counts)
                tile, per_query = counts[:LEVELS].sum(), counts[LEVELS:].sum()
                entry["tile_share"] = (tile / (tile + per_query)).item()
                entry["path_counts"] = counts.tolist()
            res["b1"][f"{name}/{kind}"] = entry
            out = ops.corr_lookup(pyr, coords)
            ms = cuda_ms(lambda: ops.corr_lookup(pyr, coords), 2 * reps)
            moved = (needed_taps(pyr, coords) * pyr[0].element_size()
                     + nbytes(coords, out))
            res["b5"][f"{name}/{kind}"] = {
                "ms": ms, "bound_ms": 1e3 * moved / HBM_BYTES_PER_S}
            del out
        del f1, levels, pyr
    return res


def time_serving() -> dict:
    """Steady-state pairs/s of RAFT-12 serving 8 pairs at 384x1280: the alt
    path calibrated and wild, the volume path and WoContext calibrated."""
    import time

    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        scale_flow_head,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    requests = [(torch.rand((8, 384, 1280, 3), generator=gen, device="cuda"),
                 torch.rand((8, 384, 1280, 3), generator=gen, device="cuda"))
                for _ in range(3)]
    res = {}
    for key, name, kw, calibrated in (
            ("raft_alt_calibrated", "RAFT", {}, True),
            ("raft_alt_wild", "RAFT", {}, False),
            ("raft_volume_calibrated", "RAFT", {"corr_impl": "volume"}, True),
            ("wocontext_calibrated", "RAFT_FlowNetCEncoder_WoContext", {},
             True)):
        model = fetch_model(name, device="cuda", seed=0, **kw)
        if calibrated:
            model = FlowModel(name, scale_flow_head(model.module, 0.05),
                              model.device)
        for a, b in requests[:2]:
            predict_flow(model, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in requests * 2:
            predict_flow(model, a, b)
        torch.cuda.synchronize()
        res[f"{key}_pairs_per_s"] = 8 * 2 * len(requests) / (
            time.perf_counter() - t0)
        del model
        torch.cuda.empty_cache()
    return res


def time_b2(ops, corr, reps: int) -> dict:
    res = {}
    for shape_name, (b, h, w, c) in B2_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        g = torch.randn((b, h * w, LEVELS * (2 * RADIUS + 1) ** 2),
                        generator=gen, device="cuda")
        grid = ops.coords_grid(h, w, device="cuda")[None]
        kinds = {
            "calibrated": grid + 2.0 * torch.randn((b, h, w, 2), generator=gen,
                                                   device="cuda"),
            "smooth": grid + smooth_field(gen, b, h, w, 3.0).permute(0, 2, 3, 1),
        }
        f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, torch.bfloat16)
        for kind, coords in kinds.items():
            cflat = coords.reshape(b, h * w, 2).contiguous()
            out = corr._alt_corr_bwd_cuda(f1, levels, cflat, g, RADIUS)
            ms = cuda_ms(lambda: corr._alt_corr_bwd_cuda(
                f1, levels, cflat, g, RADIUS), reps)
            moved = nbytes(f1, *levels, cflat, g, out[0], *out[1])
            res[f"{shape_name}/{kind}"] = {
                "ms": ms, "bound_ms": 1e3 * moved / HBM_BYTES_PER_S}
    return res


def time_b3(ops, corr, reps: int) -> dict:
    import inspect

    counted = "path_counts" in inspect.signature(
        corr._alt_corr_dcoords_cuda).parameters
    res = {}
    for name, ((b, h, w, c), r) in B3_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        g = torch.randn((b, h * w, LEVELS * (2 * r + 1) ** 2), generator=gen,
                        device="cuda")
        grid = ops.coords_grid(h, w, device="cuda")[None]
        kinds = {kind: (grid + spread * torch.randn(
            (b, h, w, 2), generator=gen, device="cuda")).reshape(
                b, h * w, 2).contiguous()
            for kind, spread in (("calibrated", 2.0), ("wild", 150.0))}
        for dtype in (torch.bfloat16, torch.float32):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            for kind, cflat in kinds.items():
                out = corr._alt_corr_dcoords_cuda(f1, levels, cflat, g, r)
                ms = cuda_ms(lambda: corr._alt_corr_dcoords_cuda(
                    f1, levels, cflat, g, r), reps)
                flops = 2 * (2 * r + 2) ** 2 * c * b * h * w * LEVELS
                entry = {"ms": ms, "bound_ms": 1e3 * max(
                    nbytes(f1, *levels, cflat, g, out) / HBM_BYTES_PER_S,
                    flops / PEAK_FLOPS[dtype])}
                if counted:
                    counts = torch.zeros(2 * LEVELS, dtype=torch.int32,
                                         device="cuda")
                    corr._alt_corr_dcoords_cuda(f1, levels, cflat, g, r,
                                                path_counts=counts)
                    tile = counts[:LEVELS].sum()
                    entry["tile_share"] = (tile / counts.sum()).item()
                res[f"{name}/{str(dtype).split('.')[-1]}/{kind}"] = entry
                del out
    return res


def time_b4(ops, reps: int) -> dict:
    from understanding_flow_robustness_tpu_torch.ops.interp import (
        warp_sample_coords,
    )

    res = {}
    for mode, ((b, c, h, w), dtype) in B4_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(2)
        img = torch.rand((b, c, h, w), generator=gen, device="cuda").to(dtype)
        flow = smooth_field(gen, b, h, w, 3.0)
        out = ops.warp_backward(img, flow, mode)
        ms = graph_ms(lambda: ops.warp_backward(img, flow, mode), reps * 5)
        launched_ms = cuda_ms(lambda: ops.warp_backward(img, flow, mode),
                              reps * 5)
        x, y, _ = warp_sample_coords(flow, mode)
        grid = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1],
                           dim=-1).to(dtype)
        pad = "border" if mode == "border" else "zeros"
        lib_ms = graph_ms(lambda: torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode=pad,
            align_corners=False), reps * 5)
        res[mode] = {"ms": ms, "launched_ms": launched_ms,
                     "grid_sample_ms": lib_ms,
                     "bound_ms": 1e3 * nbytes(img, flow, out) / HBM_BYTES_PER_S}
    return res


def corr_pairs(h: int, w: int, patch: int, dil: int) -> int:
    """The (pixel, displacement) pairs whose displaced pixel lies inside an
    h x w map: the products a correlation needs per image and channel."""
    r = (patch - 1) // 2
    offs = [(k - r) * dil for k in range(patch)]
    return (sum(max(0, h - abs(d)) for d in offs)
            * sum(max(0, w - abs(d)) for d in offs))


def time_spatial(corr, reps: int) -> dict:
    """``spatial_corr_fwd`` and ``spatial_corr_bwd`` (both gradients, one
    launch) through their wrappers at the main paths' shapes, with the
    bound: the larger of the bytes each input and output moves once over
    3.35 TB/s and the products inside the map (a multiply-add each; two for
    the backward) over the inputs' peak rate."""
    if not hasattr(corr, "_spatial_corr_fwd_cuda"):
        return {}
    res = {}
    for kind, shapes in (("fwd", SPATIAL_FWD), ("bwd", SPATIAL_BWD)):
        for name, (shape, patch, dil, dtype) in shapes.items():
            gen = torch.Generator(device="cuda").manual_seed(6)
            f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            pairs = corr_pairs(shape[2], shape[3], patch, dil) * shape[0] \
                * shape[1]
            if kind == "fwd":
                out = corr._spatial_corr_fwd_cuda(f1, f2, patch, dil)
                ms = cuda_ms(lambda: corr._spatial_corr_fwd_cuda(
                    f1, f2, patch, dil), reps)
                moved, flops = nbytes(f1, f2, out), 2 * pairs
            else:
                g = torch.randn((shape[0], patch ** 2) + shape[2:],
                                generator=gen, device="cuda").to(dtype)
                out = corr._spatial_corr_bwd_cuda(f1, f2, g, patch, dil)
                ms = cuda_ms(lambda: corr._spatial_corr_bwd_cuda(
                    f1, f2, g, patch, dil), reps)
                moved, flops = nbytes(f1, f2, g, *out), 4 * pairs
            res[f"{kind}/{name}"] = {"ms": ms, "bound_ms": 1e3 * max(
                moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])}
            del out
    return res


def time_e2e() -> dict:
    import time

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
    from understanding_flow_robustness_tpu_torch.training import (
        fetch_optimizer,
        make_train_step,
    )

    res = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = fetch_model("RAFT", device="cuda", seed=0)
    optimizer, scheduler = fetch_optimizer(list(model.module.parameters()),
                                           lr=1e-4, num_steps=1000)
    step = make_train_step(model.module, optimizer, scheduler, is_raft=True)
    batch = {"image1": torch.rand((4, 288, 960, 3), generator=gen, device="cuda"),
             "image2": torch.rand((4, 288, 960, 3), generator=gen, device="cuda"),
             "flow": torch.randn((4, 288, 960, 2), generator=gen, device="cuda"),
             "valid": torch.ones((4, 288, 960), device="cuda")}
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(batch)
    torch.cuda.synchronize()
    res["train_frames_per_s"] = 4 * 5 / (time.perf_counter() - t0)
    del model, optimizer, step, batch

    model = fetch_model("RAFT", device="cuda", seed=0)
    a = torch.rand((1, 256, 640, 3), generator=gen, device="cuda")
    b = torch.rand((1, 256, 640, 3), generator=gen, device="cuda")
    flow = predict_flow(model, a, b)
    gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)
    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=0.02, n_step=2)
    attack = make_attack(lambda x, y: predict_flow_differentiable(model, x, y),
                         cfg)
    attack(a, b, gt)
    attack = make_attack(lambda x, y: predict_flow_differentiable(model, x, y),
                         dataclasses.replace(cfg, n_step=10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    attack(a, b, gt)
    torch.cuda.synchronize()
    res["attack_steps_per_s"] = 10 / (time.perf_counter() - t0)

    m = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", device="cuda", seed=0)
    kernel = FlowModel(m.name, scale_flow_head(m.module, 0.05), m.device)
    rels = []
    for seed in range(4):
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        a = torch.rand((1, 256, 640, 3), generator=g, device="cuda")
        b = torch.rand((1, 256, 640, 3), generator=g, device="cuda")
        flow = predict_flow(kernel, a, b)
        gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)
        grads = []
        for plain in (False, True):
            kernel.module.plain_lookup = plain
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            loss = flow_attack_loss(predict_flow_differentiable(kernel, x, y),
                                    gt, "l2")
            grads.append(torch.autograd.grad(loss, (x, y)))
        kernel.module.plain_lookup = False
        rels.append(max(((k - p).norm() / p.norm()).item()
                        for k, p in zip(*grads)))
    res["f32_image_grad_rel_l2"] = rels
    return res


def time_correlation_models() -> dict:
    """Pairs/s of the correlation models the checkout ports (PWC-Net; the
    FlowNet family with FlowNetC's plain-correlation twin) and FlowNetC's
    I-FGSM ms per step."""
    import time

    from understanding_flow_robustness_tpu_torch import attacks, models

    ported = set(getattr(models.registry, "_SPECS", {}))
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [(torch.rand((8, 384, 1280, 3), generator=gen, device="cuda"),
                 torch.rand((8, 384, 1280, 3), generator=gen, device="cuda"))
                for _ in range(2)]
    res = {}
    for key, name, plain in (
            ("pwcnet", "PWCNet", False), ("flownetc", "FlowNetC", False),
            ("flownetc_plain_corr", "FlowNetC", True),
            ("robust_flownetc", "FlowNetCFlexLarger_k3_reps3", False),
            ("flownets", "FlowNetS", False)):
        if name not in ported:
            continue
        model = models.fetch_model(name, device="cuda", seed=0)
        model.module.plain_corr = plain
        for a, b in requests:
            models.predict_flow(model, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in requests * 3:
            models.predict_flow(model, a, b)
        torch.cuda.synchronize()
        res[f"{key}_pairs_per_s"] = 8 * 6 / (time.perf_counter() - t0)
        del model
        torch.cuda.empty_cache()
    if "FlowNetC" not in ported:
        return res
    model = models.fetch_model("FlowNetC", device="cuda", seed=0)
    a = torch.rand((1, 256, 640, 3), generator=gen, device="cuda")
    b = torch.rand((1, 256, 640, 3), generator=gen, device="cuda")
    flow = models.predict_flow(model, a, b)
    gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return models.predict_flow_differentiable(model, x, y)

    cfg = attacks.PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                                output_norm=0.02, n_step=2)
    attacks.make_attack(predict, cfg)(a, b, gt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    attacks.make_attack(predict, dataclasses.replace(cfg, n_step=40))(a, b, gt)
    torch.cuda.synchronize()
    res["flownetc_ifgsm_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / 40
    if hasattr(attacks, "make_patch_attack_step"):
        res.update(time_patch_iteration(model))
    return res


def time_patch_iteration(model, iters: int = 16) -> dict:
    """FlowNetC's inner patch iteration (f32, batch 1 at 384x1280, the JAX
    bench's 100x100 mask, ``loss_threshold=0`` pinning ``iters``
    iterations, after a 2-iteration warm-up), as ``chip_smoke.py``'s patch
    phase runs it: ms per iteration."""
    import time

    from understanding_flow_robustness_tpu_torch import attacks, models

    gen = torch.Generator(device="cuda").manual_seed(200)
    a = torch.rand((1, 384, 1280, 3), generator=gen, device="cuda")
    b = torch.rand((1, 384, 1280, 3), generator=gen, device="cuda")
    mask = torch.zeros_like(a)
    mask[:, 100:200, 100:200] = 1.0
    patch = torch.rand(a.shape, generator=gen, device="cuda") * mask
    target = -1.0 * models.predict_flow(model, a, b)

    def predict(x, y):
        return models.predict_flow_differentiable(model, x, y)

    res = {}
    for n in (2, iters):
        step = attacks.make_patch_attack_step(predict, attacks.PatchAttackConfig(
            max_count=n, loss_threshold=0.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(a, b, patch, mask, patch, target)
        torch.cuda.synchronize()
        res["flownetc_patch_ms_per_iter"] = 1e3 * (
            time.perf_counter() - t0) / n
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--e2e", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    assert Path(ops.__file__).resolve().is_relative_to(root), ops.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    res = {"root": args.root, **time_b1_b5(ops, corr, args.reps),
           "b2": time_b2(ops, corr, args.reps),
           "b3": time_b3(ops, corr, args.reps), "b4": time_b4(ops, args.reps),
           "spatial": time_spatial(corr, args.reps)}
    if args.e2e:
        res["e2e"] = {**time_serving(), **time_e2e(),
                      **time_correlation_models()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
