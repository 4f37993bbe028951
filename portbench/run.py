"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up and measures the cell for ``--seconds`` on the card, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``, then ``checks``
(each compared number beside its limit), which standard error ends with
too. Without a card, or with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


class Context:
    """What an entry gets: the cell, the run's arguments, the device, a
    working directory for what the program writes, the spans, and the
    tracer (started and stopped by the entry around its traced stretch)."""

    def __init__(self, cell: harness.Cell, seed: int, seconds: int, trace: bool, device: str,
                 workdir: str, config_override: dict | None = None,
                 traffic_override: dict | None = None):
        self.cell = cell
        self.config = dict(cell.config, **(config_override or {}))
        self.traffic = dict(cell.spec["traffic"], **(traffic_override or {}))
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.workdir = workdir
        self.spans = harness.Spans()
        self.tracer = harness.Tracer() if trace else None
        self.memory_peak = 0


def run_cell(cell: harness.Cell, seed: int, seconds: int, trace: bool, device: str = "cuda",
             config_override: dict | None = None, traffic_override: dict | None = None,
             t_start: float | None = None) -> dict:
    """Run ``cell`` and return its result line (a dict) with ``checks``
    last. ``device="cpu"`` (tests only) runs the program's plain versions
    at whatever sizes the overrides give."""
    t_start = _T0 if t_start is None else t_start
    entry = harness.entry_module(cell.entry)
    with tempfile.TemporaryDirectory(prefix="portbench-", dir=os.environ.get("TMPDIR")) as work:
        ctx = Context(cell, seed, seconds, trace, device, work, config_override, traffic_override)
        ctx.t_start = t_start
        out = entry.run(ctx)
    checks = out["checks"]  # name -> (value, limit)
    correct = all(v == v and v <= lim for v, lim in checks.values())  # NaN fails
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        if trace:
            value = harness.metric_reader(m["name"]).read(ctx, out)
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": out["device"]}
    if trace and ctx.tracer is not None and ctx.tracer.trace is not None:
        result["device"]["busy_s"] = ctx.tracer.trace.busy_s()
        result["device"]["window_s"] = ctx.tracer.trace.window_s
        result["breakdown"] = harness.breakdown(ctx.tracer.trace)
        out.setdefault("notes", {})["device_names"] = harness.device_names(ctx.tracer.trace)
    result["checks"] = {k: {"value": float(v), "limit": float(lim)}
                        for k, (v, lim) in checks.items()}
    result["_notes"] = dict(out.get("notes", {}), spans_s=ctx.spans.seconds())
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    harness.cache_env(ROOT)
    cell = harness.load_cell(ROOT, args.workload)
    import torch
    need = int(cell.spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = harness.card_line()
    print(f"portbench: {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=harness.process_start())
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded in this process that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    notes = result.pop("_notes")
    notes["card"] = card
    notes["written_bytes"] = harness.written_bytes()
    t = os.times()
    notes["cpu_s"] = [t.user, t.system]
    notes["loadavg"] = harness.loadavg()
    print("portbench notes: " + json.dumps(notes), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
