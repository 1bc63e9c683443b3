"""Profiling and determinism utilities (counterpart of
``understanding_flow_robustness_tpu/utils/profiling.py``).

The reference's observability is wall-clock AverageMeters
(patch_attacks/main.py:356-366) and per-frame timing logs
(global_attacks/perturb_main.py:543,589,814); its determinism knobs are
cudnn.deterministic and manual seeds (perturb_main.py:149-154).  Here:
``torch.profiler`` traces, per-step host timers, and host seeding (device
randomness goes through explicit ``torch.Generator``s seeded by the
caller).
"""

from __future__ import annotations

import contextlib
import os
import random
import time

import numpy as np
import torch


def seed_everything(seed: int) -> "np.random.RandomState":
    """Seed the host RNGs (perturb_main.py:149-154 equivalent) and return
    a ``RandomState`` of ``seed``, as the JAX package does."""
    random.seed(seed)
    np.random.seed(seed)
    return np.random.RandomState(seed)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, CPU and (where there is a
    card) CUDA activity, written at its end as a Chrome trace
    ``<log_dir>/<host>_<pid>.<ns>.pt.trace.json`` (TensorBoard's profiler
    plugin and Perfetto read it); yields the profiler.  Unlike the JAX
    package's ``jax.profiler`` context, which swallows every profiler
    error, a trace that cannot start or be written raises."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Per-step wall-clock tracking (batch_time / data_time meters,
    patch_attacks/main.py:356-366)."""

    def __init__(self):
        self.t_last = time.time()
        self.data_time = 0.0
        self.batch_time = 0.0
        self.n = 0
        self.total_data = 0.0
        self.total_batch = 0.0

    def data_loaded(self):
        now = time.time()
        self.data_time = now - self.t_last
        self.total_data += self.data_time
        self.t_last = now

    def step_done(self):
        now = time.time()
        self.batch_time = now - self.t_last
        self.total_batch += self.batch_time
        self.t_last = now
        self.n += 1

    def summary(self) -> dict:
        n = max(self.n, 1)
        return {
            "avg_data_time": self.total_data / n,
            "avg_batch_time": self.total_batch / n,
            "steps": self.n,
        }
