"""Profiling hooks: torch.profiler traces and step timing / throughput
counters (the port's counterpart of lanegcn_tpu/utils/profiling.py).

Wrap any region in trace_context(log_dir) to capture a torch.profiler trace
of the host and, on a card, its kernels, written into log_dir as a Chrome
trace (chrome://tracing or Perfetto); StepTimer keeps rolling scen/s and
edges/s counters.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace (CPU, and CUDA where available) of the
    enclosed region into log_dir/trace.json (no-op if log_dir is None)."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling-window throughput: scenarios/s and message-edges/s, on the
    host's clock (time.perf_counter) between tick() calls."""

    def __init__(self, window: int = 50):
        self.times: deque = deque(maxlen=window)
        self.scen: deque = deque(maxlen=window)
        self.edges: deque = deque(maxlen=window)
        self._last = None

    def tick(self, scenarios: int = 0, edges: int = 0):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            self.scen.append(scenarios)
            self.edges.append(edges)
        self._last = now

    @property
    def scen_per_s(self) -> float:
        dt = sum(self.times)
        return sum(self.scen) / dt if dt > 0 else 0.0

    @property
    def edges_per_s(self) -> float:
        dt = sum(self.times)
        return sum(self.edges) / dt if dt > 0 else 0.0

    @property
    def step_ms(self) -> float:
        return 1000.0 * sum(self.times) / len(self.times) if self.times else 0.0
