"""The MLP's share of its roofline, in %: each of the program's ``vit.mlp``
spans (one a block of a batch: ``c_fc``, the activation and ``c_proj``) is
bound by ``portbench.counts_vit.mlp`` at the padded batch (the activation
taken in ``c_fc``'s pass, the least traffic), over the device time of
every operation those spans launched. A program without the spans reports
nothing."""

from portbench import counts_vit, span_launches


def read(ctx, out):
    info = out["trace_info"]
    if ctx.tracer is None or "tower" not in info:
        return None
    bound = sum(w.bound_s() for _, w in counts_vit.mlp(info["extract_batch"], info["tower"]))
    return span_launches.share(ctx.tracer.trace, "vit.mlp", bound)
