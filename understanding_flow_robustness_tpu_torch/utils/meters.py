"""Metric meters and terminal/experiment logging (the port's own copy of
``understanding_flow_robustness_tpu/utils/meters.py``, which imports no
JAX; standard library only).

Reference: patch_attacks/logger.py — AverageMeter with min/max tracking
(:83-114), the multi-bar TermLogger (:7-55, simplified to plain stdout
progress lines since blessings/progressbar aren't in this environment) and
the CSV/TensorBoard writer plumbing.
"""

from __future__ import annotations

import csv
import os
import sys
import time
from typing import Sequence


class AverageMeter:
    """Tracks mean/min/max of i parallel values (logger.py:83-114)."""

    def __init__(self, i: int = 1, precision: int = 3):
        self.meters = i
        self.precision = precision
        self.reset(self.meters)

    def reset(self, i: int):
        self.val = [0.0] * i
        self.avg = [0.0] * i
        self.sum = [0.0] * i
        self.min = [float("inf")] * i
        self.max = [-float("inf")] * i
        self.count = 0

    def update(self, val, n: int = 1):
        if not isinstance(val, (list, tuple)):
            val = [val]
        assert len(val) == self.meters
        self.count += n
        for i, v in enumerate(val):
            v = float(v)
            self.val[i] = v
            self.sum[i] += v * n
            self.avg[i] = self.sum[i] / self.count
            self.min[i] = min(self.min[i], v)
            self.max[i] = max(self.max[i], v)

    def __repr__(self):
        val = " ".join(f"{v:.{self.precision}f}" for v in self.val)
        avg = " ".join(f"{a:.{self.precision}f}" for a in self.avg)
        return f"{val} ({avg})"


class TermLogger:
    """Plain-stdout stand-in for the reference's blessings multi-bar UI
    (logger.py:7-55): epoch/train/valid/attack progress lines."""

    def __init__(self, n_epochs: int, train_size: int, valid_size: int,
                 attack_size: int = 0):
        self.n_epochs = n_epochs
        self.train_size = train_size
        self.valid_size = valid_size
        self.attack_size = attack_size
        self.epoch_bar = _Bar("epoch", n_epochs)
        self.train_bar = _Bar("train", train_size)
        self.valid_bar = _Bar("valid", valid_size)
        self.attack_bar = _Bar("attack", attack_size, quiet=True)

    def train_writer_write(self, text):
        sys.stdout.write(text + "\n")

    def valid_writer_write(self, text):
        sys.stdout.write(text + "\n")

    def reset_train_bar(self):
        self.train_bar = _Bar("train", self.train_size)

    def reset_valid_bar(self):
        self.valid_bar = _Bar("valid", self.valid_size)

    def reset_attack_bar(self):
        self.attack_bar = _Bar("attack", self.attack_size, quiet=True)


class _Bar:
    def __init__(self, name: str, total: int, quiet: bool = False):
        self.name = name
        self.total = total
        self.n = 0
        self.quiet = quiet
        self.t0 = time.time()

    def update(self, n: int):
        self.n = n
        if not self.quiet and self.total:
            dt = time.time() - self.t0
            sys.stdout.write(
                f"\r{self.name} {self.n}/{self.total} ({dt:.0f}s)"
            )
            if self.n >= self.total:
                sys.stdout.write("\n")
            sys.stdout.flush()


class CsvLogger:
    """Append-only CSV results files (test_patch.py:226-236-style)."""

    def __init__(self, path: str, header: Sequence[str]):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # a zero-byte leftover from a crashed run still needs the header
        new = (not os.path.exists(path)
               or os.path.getsize(path) == 0)
        self._f = open(path, "a", newline="", encoding="utf-8")
        self._w = csv.writer(self._f)
        if new:
            self._w.writerow(header)
            self._f.flush()

    def write(self, row: Sequence):
        self._w.writerow(row)
        self._f.flush()

    def close(self):
        self._f.close()


def make_summary_writer(log_dir: str):
    """TensorBoard writer (tensorboardX, as the reference uses at
    patch_attacks/main.py:194-195); returns None if unavailable."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(log_dir)
    except Exception:
        return None
