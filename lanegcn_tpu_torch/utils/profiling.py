"""Profiling hook: torch.profiler traces (the port's counterpart of
lanegcn_tpu/utils/profiling.py's trace_context).

Wrap any region in trace_context(log_dir) to capture a torch.profiler trace
of the host and, on a card, its kernels, written into log_dir as a Chrome
trace (chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
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
