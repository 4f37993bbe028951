"""Status printing and training-metric writers.

The trainers log scalars under the reference's tag names
(``{Value,Policy,Reward} Network-loss``), as the JAX package does, to
``<log_dir>/metrics.jsonl`` (one ``{tag, value, step}`` per line) and, as
the reference does (trainers.py:138), to TensorBoard event files in
``<log_dir>/runs`` through ``torch.utils.tensorboard``. Where that import
fails (no ``tensorboard`` package), the JSONL log is written alone.
"""

from __future__ import annotations

import json
import os
import sys
import types
from typing import Optional


def print_green(text: str) -> None:
    print("\033[32m", text, "\033[0m", sep="", flush=True)


def print_red(text: str) -> None:
    print("\033[31m", text, "\033[0m", sep="", flush=True)


class NullWriter:
    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlWriter:
    """Append-only JSONL scalar log, line-buffered so that a killed run
    keeps every line it wrote."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def close(self) -> None:
        self._f.close()


class TeeWriter:
    def __init__(self, *writers):
        self._writers = writers

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        for w in self._writers:
            w.add_scalar(tag, value, step)

    def close(self) -> None:
        for w in self._writers:
            w.close()


def make_metrics_writer(log_dir: Optional[str], tensorboard: bool = True):
    """``<log_dir>/metrics.jsonl`` teed with TensorBoard into
    ``<log_dir>/runs`` (JSONL alone when ``torch.utils.tensorboard`` does
    not import), or a writer that drops everything when ``log_dir`` is
    None."""
    if log_dir is None:
        return NullWriter()
    writers = [JsonlWriter(os.path.join(log_dir, "metrics.jsonl"))]
    if tensorboard:
        # TensorBoard's own switch: with ``tensorboard.compat.notf`` importable
        # it writes its event files through its stub and never imports
        # TensorFlow (which, where installed, imports other frameworks)
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception:  # no tensorboard package: the JSONL log alone, as the JAX writer
            SummaryWriter = None
        if SummaryWriter is not None:
            writers.append(SummaryWriter(log_dir=os.path.join(log_dir, "runs")))
    return TeeWriter(*writers) if len(writers) > 1 else writers[0]
