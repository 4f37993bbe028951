"""Tracing (counterpart of the JAX ``utils/profiling.py``): :func:`trace`
wraps a region in ``torch.profiler`` and writes a Chrome trace (viewable in
Perfetto or ``chrome://tracing``) into a directory. It serves the CLI's
``--profile_dir``."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body on the host, and on the card when one is there,
    then write ``<log_dir>/trace_<pid>_<ms>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
