"""The attention core's share of its roofline, in %: each of the program's
``vit.attention`` spans (one a block of a batch: the head split, the
attention call and the head merge) is bound by
``portbench.counts_vit.attention`` at the padded batch (the larger of its
q, k, v and output bytes at the peak bandwidth and its ``4 n heads T^2 d``
products at the bf16 peak), over the device time of every operation those
spans launched. A program without the spans reports nothing."""

from portbench import counts_vit, span_launches


def read(ctx, out):
    info = out["trace_info"]
    if ctx.tracer is None or "tower" not in info:
        return None
    bound = counts_vit.attention(info["extract_batch"], info["tower"]).bound_s()
    return span_launches.share(ctx.tracer.trace, "vit.attention", bound)
