"""Tracing (counterpart of the JAX ``utils/profiling.py``): :func:`trace`
wraps a region in ``torch.profiler`` and writes a Chrome trace (viewable in
Perfetto or ``chrome://tracing``) into a directory. It serves the CLI's
``--profile_dir``. :func:`annotate` names a host phase on the profiler's
own timeline.

The program's spans, each a phase of host work, siblings and never nested
(a trace's reader names an idle stretch of the device by the outermost
range over it):

- ``caption.features_in``, ``caption.search``, ``caption.tokens_out``
  (:class:`..api.Captioner`) and ``caption.strings``
  (:func:`..data.coco.decode_captions`);
- ``train.permute``, ``train.gather``, ``train.dispatch``, ``train.losses``,
  ``train.save_best``, ``train.snapshot`` (:mod:`..train.loops`), and
  ``train.capture`` and ``train.dispatch`` (:class:`..train.steps.BestLossChunk`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named host range on the profiler's timeline while a profiler of
    this process runs (``torch.profiler.record_function``); otherwise one
    shared no-op context, so a span costs one check when nothing traces.
    The check is the process-wide flag that every ``torch.profiler`` and
    ``torch.autograd.profiler`` run sets, not the calling thread's
    profiler state: a profiler started with ``profile_all_threads`` also
    records the spans of the Captioner's calls from another thread (the
    server's batcher). Never open one inside a CUDA graph's capture."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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
