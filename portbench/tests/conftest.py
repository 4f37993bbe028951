"""Shared settings of the benchmark's own tests: the checkout on the path,
and the tiny sizes at which a cell runs on the CPU (the program's plain
versions; its kernels run only on the card)."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "portbench")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"vocab_size": 30, "input_dim": 16, "wordvec_dim": 16, "hidden_dim": 16}
TINY_TRAFFIC = {
    "a2c-e512": {"train_images": 50, "train_captions": 1300, "epoch_seconds": 1.0},
    "policy-xe-w2v300": {"train_images": 50, "train_captions": 1300, "epoch_seconds": 1.0},
    "beam5-e512": {"val_images": 300, "group_rows": 64, "check_calls_from": 2, "check_calls": 2,
                   "trace_calls": 2},
}
TINY_CONFIG = {"a2c-e512": TINY, "beam5-e512": TINY,
               "policy-xe-w2v300": dict(TINY, wordvec_dim=12)}
SEED = 2**31 + 977


def load_cell(cell_name: str, root: Path = ROOT):
    """A cell by name. ``a2c-e512`` is kept beside the benchmark, entry and
    limits ready, but not listed in BENCHMARK.json (its runs spread past
    any bound while the A2C chunk is eager): it is loaded here with the
    end-to-end metrics a training cell reports."""
    from portbench import harness
    try:
        return harness.load_cell(root, cell_name)
    except KeyError:
        spec = harness.load_json(harness.HERE / "workloads" / f"{cell_name}.json")
        config = harness.load_json(harness.HERE / "configs" / f"{spec['config']}.json")
        bench = harness.load_json(root / "BENCHMARK.json")
        e2e = [m for m in bench["end_to_end"] if m["name"] in ("setup_s", "train_samples_per_s")]
        return harness.Cell(cell_name, spec, config, e2e, [])


def run_tiny(cell_name: str, seed: int = SEED, root: Path = ROOT, seconds: int = 1):
    """One untraced run of a cell on the CPU at the tiny sizes; the result
    line as a dict."""
    import run as bench
    return bench.run_cell(load_cell(cell_name, root), seed, seconds, False, device="cpu",
                          config_override=TINY_CONFIG[cell_name],
                          traffic_override=TINY_TRAFFIC[cell_name])


def tiny_ctx(cell_name: str, seed: int, work: str):
    """A run's context for a cell at the tiny sizes on the CPU, working in
    ``work``, and the cell's entry."""
    import run as bench
    from portbench import harness
    cell = load_cell(cell_name)
    ctx = bench.Context(cell, seed, 0, False, "cpu", work, TINY_CONFIG[cell_name],
                        TINY_TRAFFIC[cell_name])
    ctx.t_start = time.perf_counter()
    return ctx, harness.entry_module(cell.entry)
