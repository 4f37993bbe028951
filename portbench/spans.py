"""The program's own spans read against the device's idle time.

The program names its host phases on the profiler's timeline (its
``utils/profiling.annotate``: ``caption.*``, ``train.*``). The reduced
trace keeps the main thread's host ranges, spans among them, so an idle
stretch of the device (:meth:`harness.Trace.gaps`) is attributed to the
spans that cover it. A program without such spans has none of these
ranges, and the readers that use this module then report nothing.
"""

from __future__ import annotations


def present(trace, names) -> bool:
    """Whether the main thread ran a span named one of ``names``."""
    names = set(names)
    return any(n in names for n, _, _ in trace.host)


def union(trace, names) -> list:
    """The union of the main thread's host ranges named one of ``names``:
    disjoint ``(start_us, end_us)``, in order."""
    names = set(names)
    merged: list = []
    for s, e in sorted((s, e) for n, s, e in trace.host if n in names):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def traced_epochs(ctx, out) -> int:
    """The epochs a training run traced: its ``epoch`` spans (one a
    trainer's epoch line) after the set-up's ``warmup_epochs`` and the
    window's epochs, for the profiler runs from the window's last epoch
    line to a later one (``portbench.trainrun.timed_epochs``)."""
    return (len(ctx.spans.of("epoch")) - int(ctx.traffic["warmup_epochs"])
            - int(out["notes"]["epochs"]))


def idle_s(trace) -> float:
    """The device's idle seconds over the traced stretch: the sum of its
    gaps."""
    return sum(e - s for s, e in trace.gaps()) * 1e-6


def idle_inside(trace, names) -> float:
    """The device-idle seconds of ``trace.gaps()`` that lie inside the
    union of the main thread's host ranges named one of ``names``; a
    stretch that two such ranges cover counts once."""
    gaps, spans = trace.gaps(), union(trace, names)
    total, i, j = 0.0, 0, 0
    while i < len(gaps) and j < len(spans):
        lo, hi = max(gaps[i][0], spans[j][0]), min(gaps[i][1], spans[j][1])
        if hi > lo:
            total += hi - lo
        if gaps[i][1] < spans[j][1]:
            i += 1
        else:
            j += 1
    return total * 1e-6


def unattributed_share(trace, names) -> float | None:
    """The share, in %, of the device's idle time that lies inside no span
    named one of ``names``; None when the trace has none of them or no idle
    time."""
    if not present(trace, names):
        return None
    idle = idle_s(trace)
    if idle <= 0:
        return None
    return 100.0 * max(0.0, idle - idle_inside(trace, names)) / idle
