"""Profiling helpers: step timing and ``torch.profiler`` trace capture.

A throughput meter the train CLI reports per epoch, and a context manager
that writes a Chrome trace of the CPU and (on the card) CUDA activity of
its block, in place of the JAX package's ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class StepTimer:
    """Steps/s and images/s since the last ``reset``: host wall clock, so
    an end-to-end rate (pipeline and launches included), not device time."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._images = 0

    def step(self, batch_size: int):
        self._steps += 1
        self._images += batch_size

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    def rates(self):
        dt = max(self.seconds, 1e-9)
        return self._steps / dt, self._images / dt


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where the
    card is present) and write ``logdir/trace.json`` (Chrome / Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
