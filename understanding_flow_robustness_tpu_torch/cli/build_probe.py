#!/usr/bin/env python3
"""Time nvcc on the port's kernel sources, to choose how they are built.

    python -m understanding_flow_robustness_tpu_torch.cli.build_probe \
        [--out build/probe]

Compiles every ``csrc/<name>.cu`` of ``ops/_build.KERNELS`` with
``_build.NVCC_FLAGS`` minus ``--split-compile`` (the flags of the parent
build), first one at a time, then the four radius-templated window kernels
(csrc/radius.cuh) alone with ``--split-compile=0``, then all seven at once
without and with it, and prints each build's wall seconds.  The libraries
land in ``--out`` (default ``build/probe``, ignored by git); nothing of
``build/torch_kernels`` is touched.  Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from pathlib import Path

from ..ops import _build

WINDOW_KERNELS = ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords",
                  "corr_lookup_fwd")
SPLIT = "--split-compile=0"


def _cmd(name: str, split: bool, out: Path) -> list:
    flags = [f for f in _build.NVCC_FLAGS if f != SPLIT]
    if split:
        flags.append(SPLIT)
    tag = "split" if split else "plain"
    return [_build._nvcc(), *flags, "-o", str(out / f"lib{name}_{tag}.so"),
            str(_build.CSRC_DIR / f"{name}.cu")]


def _together(names, split: bool, out: Path) -> dict:
    """Every source of ``names`` compiled at once: each one's wall time."""
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(_cmd(n, split, out), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for n in names}
    ends = {}
    while len(ends) < len(procs):
        for n, p in procs.items():
            if n not in ends and p.poll() is not None:
                if p.returncode:
                    raise RuntimeError(f"nvcc failed on {n}: "
                                       f"{p.stderr.read().decode()[-2000:]}")
                ends[n] = time.perf_counter() - t0
        time.sleep(0.05)
    return ends


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="build/probe")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    res = {"alone": {}, "alone_split": {}}
    for name in _build.KERNELS:
        res["alone"][name] = _together([name], False, out)[name]
    for name in WINDOW_KERNELS:
        res["alone_split"][name] = _together([name], True, out)[name]
    res["together"] = _together(_build.KERNELS, False, out)
    res["together_split"] = _together(_build.KERNELS, True, out)
    for key, times in res.items():
        print(f"{key:15s} " + ", ".join(f"{n} {t:.2f} s"
                                        for n, t in times.items()))
    print(f"all seven at once: {max(res['together'].values()):.2f} s, with "
          f"{SPLIT} {max(res['together_split'].values()):.2f} s "
          f"({os.cpu_count()} cores)")
    return res


if __name__ == "__main__":
    main()
