"""The benchmark's machinery: cells found by name, the card and the
checkout's caches, spans, the trainers' epoch clock, and the profiler's
trace reduced to device operations.

A cell is ``workloads/<cell>.json`` (its configuration, its entry, its
traffic and its checks' limits); its configuration is
``configs/<config>.json``; its entry is ``entries/<entry>.py``, which
drives the program and its reference; each per-layer metric is
``metrics/<metric>.py``. Which metrics a cell reports is read from
``BENCHMARK.json`` at the checkout's root. Adding a cell, a configuration,
a traffic mix or a per-layer metric therefore adds files and edits none.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "image_captioning_through_rl_tpu")


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (Linux:
    ``/proc/self/stat`` against ``/proc/uptime``); now, where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernel library builds into its package's
    ``_build/``); libraries that could load JAX by themselves are told not
    to; one host thread for the CPU math libraries (the timed paths do
    their work on the card, and idle pool threads spinning beside the
    dispatching thread take host time from it). Call before importing
    torch or numpy."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    end_to_end: list  # BENCHMARK.json's entries that this cell reports
    per_layer: list

    @property
    def entry(self) -> str:
        return self.spec["entry"]


def load_cell(root: Path, name: str) -> Cell:
    """A cell by name, from ``BENCHMARK.json`` and the files beside the
    harness."""
    bench = load_json(root / "BENCHMARK.json")
    row = next((w for w in bench["workloads"] if w["name"] == name), None)
    if row is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{row['config']}.json")
    return Cell(name, spec, config,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + re.sub(r"\W", "_", name))


def entry_module(name: str):
    return load_module(HERE / "entries" / f"{name}.py", f"portbench_entry_{name}")


# --------------------------------------------------------------------------
# spans and the trainers' epoch clock
# --------------------------------------------------------------------------

class Spans:
    """The benchmark's own spans around its calls into the program, kept in
    memory (host clock, ``time.perf_counter``): ``(name, start, end)``."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end))

    def of(self, name: str) -> list:
        """``(start, end)`` of every span named ``name``, in the order taken."""
        return [(s, e) for n, s, e in self.items if n == name]

    def seconds(self) -> dict:
        """Each name's spans' total seconds."""
        out: dict = {}
        for n, s, e in self.items:
            out[n] = out.get(n, 0.0) + (e - s)
        return out


class EpochClock(io.TextIOBase):
    """Stands in for ``sys.stdout`` while a trainer runs: each line goes on
    to standard error, and each line that ends one of the trainer's epochs
    (``<desc> (<e>/<E>)...``, printed after its saves) is timed as it is
    written. ``on_epoch(count, t)`` runs at each."""

    def __init__(self, desc: str, on_epoch=None):
        self._pattern = re.compile(re.escape(desc) + r" \((\d+)/(\d+)\)")
        self._buf = ""
        self.times: list[float] = []
        self.on_epoch = on_epoch

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        t = time.perf_counter()
        sys.stderr.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if self._pattern.search(line):
                self.times.append(t)
                if self.on_epoch is not None:
                    self.on_epoch(len(self.times), t)
        return len(s)

    def flush(self) -> None:
        sys.stderr.flush()

    @contextlib.contextmanager
    def installed(self):
        old = sys.stdout
        sys.stdout = self
        try:
            yield self
        finally:
            sys.stdout = old


# --------------------------------------------------------------------------
# the profiler's trace
# --------------------------------------------------------------------------

@dataclass
class Trace:
    """A traced stretch: device operations ``(name, start_us, end_us,
    correlation)``, the main thread's host operations ``(name, start_us,
    end_us)``, the launch calls ``(start_us, correlation, thread)``, the
    ``autograd.Function`` ranges of every thread ``(name, start_us, end_us,
    thread)`` (backwards run on the autograd engine's thread), and the
    stretch's bounds on the profiler's clock and its wall length."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    ranges: list = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0
    window_s: float = 0.0

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        total, end = 0.0, float("-inf")
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total * 1e-6

    def named(self, names) -> list:
        """The device operations whose name contains one of ``names``."""
        return [d for d in self.device if any(n in d[0] for n in names)]

    def gaps(self) -> list:
        """Idle intervals ``(start_us, end_us)`` of the device inside the
        stretch."""
        out, end = [], self.t0
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def in_ranges(self, host_name: str) -> list | None:
        """For each host operation named ``host_name`` (an
        ``autograd.Function``'s forward or ``<Name>Backward``), the device
        seconds of every operation launched while it ran: the launches
        inside its interval, matched to device operations by the
        profiler's correlation. None when the trace has no such range."""
        ranges = sorted((s, e, t) for n, s, e, t in self.ranges if n == host_name)
        if not ranges:
            return None
        by_corr: dict = {}
        for _, s, e, c in self.device:
            by_corr[c] = by_corr.get(c, 0.0) + (e - s) * 1e-6
        by_thread: dict = {}
        for start, corr, tid in sorted(self.launches):
            by_thread.setdefault(tid, []).append((start, corr))
        starts = {tid: [x[0] for x in v] for tid, v in by_thread.items()}
        out = []
        for s, e, tid in ranges:
            at = starts.get(tid, [])
            lo, hi = bisect.bisect_left(at, s), bisect.bisect_right(at, e)
            out.append(sum(by_corr.get(c, 0.0) for _, c in by_thread.get(tid, [])[lo:hi]))
        return out


class Tracer:
    """``torch.profiler`` over one stretch, started and stopped by the
    entry, reduced to a :class:`Trace` once stopped."""

    def __init__(self):
        self.prof = None
        self.trace: Trace | None = None
        self._wall0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._wall0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._wall0
        self.prof.stop()
        self.trace = reduce_profile(self.prof, wall)
        self.prof = None


def reduce_profile(prof, wall_s: float) -> Trace:
    """The device operations, the main thread's host operations and the
    launch calls of a finished ``torch.profiler.profile``, from its raw
    kineto events."""
    import torch
    events = prof.profiler.kineto_results.events()
    device, host, launches, ranges = [], [], [], []
    tids: dict = {}
    for e in events:
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((name, start, end, e.correlation_id()))
        elif name.startswith(("cuda", "cu")) and "Launch" in name or name.startswith(
                ("cudaMemcpy", "cudaMemset")):
            launches.append((start, e.correlation_id(), e.start_thread_id()))
        else:
            tid = e.start_thread_id()
            if name.startswith("_") and "Kernel" in name:
                ranges.append((name, start, end, tid))
            tids[tid] = tids.get(tid, 0) + 1
            host.append((name, start, end, tid))
    # a host range annotated with record_function also shows on the device
    # as a range from its first kernel to its last (Adam's step): not an
    # operation
    host_names = {h[0] for h in host}
    device = [d for d in device if d[0] not in host_names]
    main = max(tids, key=tids.get) if tids else None
    host = [(n, s, e) for n, s, e, t in host if t == main]
    t0 = min([s for _, s, _ in host] + [d[1] for d in device], default=0.0)
    t1 = max([e for _, _, e in host] + [d[2] for d in device], default=0.0)
    return Trace(device, host, launches, ranges, t0, t1, wall_s)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing: the outermost host operation
    running at the gap's middle, else the last one that ended before it
    (the host then ran Python of its own)."""
    by_name: dict = {}
    for name, s, e, _ in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(trace.host, key=lambda h: h[1])
    ends = sorted((h[2], h[0]) for h in host)
    end_times = [x[0] for x in ends]
    gaps = []
    for s, e in sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        covering = [h for h in host if h[1] <= mid <= h[2]]
        if covering:
            name = min(covering, key=lambda h: h[1])[0]
        else:
            i = bisect.bisect_right(end_times, mid)
            name = f"host Python after {ends[i - 1][1]}" if i else "host Python"
        gaps.append([name[:200], (e - s) * 1e-6])
    return {"device_ops": [[n[:200], v] for n, v in ops], "idle_gaps": gaps}


def device_names(trace: Trace, top: int = 60) -> list:
    """``[name, count, seconds]`` of the traced device operations, most
    time first (for the run's notes)."""
    agg: dict = {}
    for name, s, e, _ in trace.device:
        c, t = agg.get(name, (0, 0.0))
        agg[name] = (c + 1, t + (e - s) * 1e-6)
    return [[n, c, t] for n, (c, t) in sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]]


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no card"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {type(e).__name__}"


def written_bytes() -> int | None:
    """Bytes this process has passed to ``write`` calls (``wchar``: files
    on a RAM-backed ``TMPDIR`` never reach ``write_bytes``)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def loadavg() -> str:
    try:
        with open("/proc/loadavg") as f:
            return f.read().strip()
    except OSError:
        return ""

