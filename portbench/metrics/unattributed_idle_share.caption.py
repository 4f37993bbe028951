"""The share, in %, of the traced stretch's device-idle time that lies
inside none of the Captioner's program spans: what the spans leave
unexplained."""

from portbench import spans

SPANS = ("caption.features_in", "caption.search", "caption.tokens_out", "caption.strings")


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None:
        return None
    return spans.unattributed_share(trace, SPANS)
