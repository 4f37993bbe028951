"""The CLIP tower's share of its roofline, in %: the bound of the traced
stacks (``portbench.counts_vit.bound_s`` at the padded batch, the
projection included, once for each of the program's ``extract.stack``
spans: one a batch) over the device time of every operation those spans
launched (``vgg16_roofline``'s matching of launches to device operations).
A program without the spans, or without a CLIP cell's ``tower`` in the
run's ``trace_info``, reports nothing."""

from portbench import counts_vit, harness, spans

SPAN = "extract.stack"


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    info = out["trace_info"]
    if (trace is None or not trace.launches or "tower" not in info
            or not spans.present(trace, [SPAN])):
        return None
    seconds = harness.metric_reader("vgg16_roofline").stack_seconds(trace)
    if seconds <= 0:
        return None
    stacks = len(spans.union(trace, [SPAN]))
    return 100.0 * stacks * counts_vit.bound_s(info["extract_batch"], info["pca_dim"],
                                               info["tower"]) / seconds
