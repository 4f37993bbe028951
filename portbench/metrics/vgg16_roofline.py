"""VGG16's share of its roofline, in %: the bound of the traced stacks
(``portbench.counts_vgg.bound_s`` at the padded batch, the projection
included, once for each of the program's ``extract.stack`` spans: one a
batch) over the device time of every operation those spans launched: the
launches of the main thread (the one that launches in this cell) inside
each span, matched to device operations by the profiler's correlation
ids. A program without the spans reports nothing."""

import bisect
from collections import Counter

from portbench import counts_vgg, spans

SPAN = "extract.stack"


def stack_seconds(trace) -> float:
    """The device seconds of the operations launched inside the spans."""
    main = Counter(t for _, _, t in trace.launches).most_common(1)[0][0]
    launches = sorted((s, c) for s, c, t in trace.launches if t == main)
    at = [s for s, _ in launches]
    by_corr: dict = {}
    for _, s, e, c in trace.device:
        by_corr[c] = by_corr.get(c, 0.0) + (e - s) * 1e-6
    return sum(by_corr.get(c, 0.0) for s, e in spans.union(trace, [SPAN])
               for _, c in launches[bisect.bisect_left(at, s):bisect.bisect_right(at, e)])


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None or not trace.launches or not spans.present(trace, [SPAN]):
        return None
    seconds = stack_seconds(trace)
    if seconds <= 0:
        return None
    info = out["trace_info"]
    stacks = len(spans.union(trace, [SPAN]))
    return 100.0 * stacks * counts_vgg.bound_s(info["extract_batch"], info["pca_dim"]) / seconds
