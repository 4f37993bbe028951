"""Status printing and training-metric writers.

The trainers log scalars under the reference's tag names
(``{Value,Policy,Reward} Network-loss``), as the JAX package does. The
port writes JSONL only (one ``{tag, value, step}`` per line); the JAX
package's TensorBoard writer is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def print_green(text: str) -> None:
    print("\033[32m", text, "\033[0m", sep="", flush=True)


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


def make_metrics_writer(log_dir: Optional[str]):
    """``<log_dir>/metrics.jsonl``, or a writer that drops everything when
    ``log_dir`` is None."""
    if log_dir is None:
        return NullWriter()
    return JsonlWriter(os.path.join(log_dir, "metrics.jsonl"))
