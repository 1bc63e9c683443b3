#!/usr/bin/env python3
"""Time B3 (``csrc/alt_corr_dcoords.cu``) against variants of itself, each
one of its design choices undone, in one process on one card.

    python3 scripts/torch_b3_variants.py [--reps 20]

Each variant is a text edit of the committed source, written under the
ignored ``build/b3_variants/`` and built with ``ops/_build.py``'s flags:
``no_prefetch`` drops the L2 prefetch of the level's cotangent lines,
``batch1`` contracts one query at a time (``kBatch = 1``),
``whole_tiles`` gives f32 one block a tile (``kSplit = 1``) and
``no_reg_cap`` lifts f32's 48-register cap (``kMinBlocks`` 3).  Every
variant must give the committed kernel's bits.  Timed at RAFT's serving
shape (B=8, 48x160, C=256, r = 4) and small RAFT's (C=128, r = 3), bf16
for calibrated (grid + 2 px of noise) and wild (+ 150 px) centres, f32
for calibrated; CUDA-event means of back-to-back calls, in turns (the
committed kernel first, then the variants, then in reverse, twice).
Prints the card's name and power limit and one JSON line.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_kernel_ab import cuda_ms  # noqa: E402

from understanding_flow_robustness_tpu_torch import ops  # noqa: E402
from understanding_flow_robustness_tpu_torch.ops import _build  # noqa: E402
from understanding_flow_robustness_tpu_torch.ops import correlation as corr  # noqa: E402

LEVELS = 4
SHAPES = {"r4": ((8, 48, 160, 256), 4), "r3": ((8, 48, 160, 128), 3)}
PREFETCH = """  for (int e = tid; e < kPart * kLines; e += kThreads) {
    const int j = e / kLines;
    const long long q = query(m0 + j);
    if (q >= 0) {
      prefetch_l2(g + q * stride + l * kNn + min(32 * (e - j * kLines), kNn - 1));
    }
  }
"""
VARIANTS = {
    "no_prefetch": [(PREFETCH, "")],
    "batch1": [("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")],
    "whole_tiles": [("std::is_same<T, float>::value ? 4 : 1;",
                     "std::is_same<T, float>::value ? 1 : 1;")],
    "no_reg_cap": [("kCpl == 2 && R <= 4 ? 10 : 3;", "kCpl == 2 && R <= 4 ? 3 : 3;")],
}


def build_variants() -> dict:
    src = (_build.CSRC_DIR / "alt_corr_dcoords.cu").read_text()
    out_dir = ROOT / "build" / "b3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_libraries(["alt_corr_dcoords"])
    fns = {}
    vp, i32, ptr = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).ufr_alt_corr_dcoords
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, ptr(vp), ptr(i32), i32, vp, vp, vp, vp, i32, i32,
                       i32, i32, i32, i32, vp, vp]
        fns[name] = fn
    return fns


def launch(fn, f1, levels, coords, g, r):
    """One call of a variant's entry point, as the wrapper makes it."""
    B, N, C = f1.shape
    out = torch.empty((B, N, 2), device="cuda")
    partial = torch.empty((B, N, LEVELS, 2), device="cuda")
    ptrs, hw = corr._level_args(levels)
    H1, W1 = corr._query_grid(levels, N)
    err = fn(f1.data_ptr(), ptrs, hw, LEVELS, coords.data_ptr(), g.data_ptr(),
             partial.data_ptr(), out.data_ptr(), B, H1, W1, C, r,
             int(f1.dtype == torch.bfloat16), None,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: {err}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    variants = build_variants()
    res = {}
    for shape_name, ((b, h, w, c), r) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        g = torch.randn((b, h * w, LEVELS * (2 * r + 1) ** 2), generator=gen,
                        device="cuda")
        grid = ops.coords_grid(h, w, device="cuda")[None]
        centres = {kind: (grid + spread * torch.randn(
            (b, h, w, 2), generator=gen, device="cuda")).reshape(
                b, h * w, 2).contiguous()
            for kind, spread in (("calibrated", 2.0), ("wild", 150.0))}
        for dtype, kinds in ((torch.bfloat16, ("calibrated", "wild")),
                             (torch.float32, ("calibrated",))):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            for kind in kinds:
                cc = centres[kind]
                fns = {"committed": lambda: corr._alt_corr_dcoords_cuda(
                    f1, levels, cc, g, r)}
                fns.update({name: (lambda fn=fn: launch(fn, f1, levels, cc,
                                                        g, r))
                            for name, fn in variants.items()})
                ref = fns["committed"]()
                for name, fn in fns.items():
                    if not torch.equal(fn(), ref):
                        raise SystemExit(f"{name} disagrees with the "
                                         "committed kernel")
                times = {name: [] for name in fns}
                order = list(fns)
                for turn in (order, order[::-1], order, order[::-1]):
                    for name in turn:
                        times[name].append(cuda_ms(fns[name], args.reps))
                tag = f"{shape_name}/{str(dtype).split('.')[-1]}/{kind}"
                res[tag] = times
                print(tag, json.dumps({k: [round(t, 4) for t in v]
                                       for k, v in times.items()}), flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
