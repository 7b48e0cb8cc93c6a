"""Tracing / profiling helpers.

Counterpart of ``ppde_tpu/profiling.py``:
  * ``trace(dir)``: a context manager that records a ``torch.profiler``
    trace (CPU and CUDA activities) around any run section and writes it
    into ``dir`` as a Chrome trace (``trace.json``);
  * ``SegmentTimer``: per-segment wall times without host syncs inside
    segments (timing happens at natural segment boundaries);
  * ``annotate``: a named span for custom regions
    (``torch.profiler.record_function``).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with profiling.trace('/tmp/trace'): run()``.
    CUDA activity is recorded when a CUDA device is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span visible in profiler traces."""
    return torch.profiler.record_function(name)


class SegmentTimer:
    """Accumulates per-segment wall times; zero overhead inside segments."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def total(self) -> float:
        return sum(self.times)

    def summary(self) -> str:
        if not self.times:
            return "no segments timed"
        import numpy as np

        t = np.asarray(self.times)
        return (f"{len(t)} segments: total {t.sum():.2f}s, "
                f"mean {t.mean()*1e3:.1f}ms, p50 {np.median(t)*1e3:.1f}ms, "
                f"max {t.max()*1e3:.1f}ms")
