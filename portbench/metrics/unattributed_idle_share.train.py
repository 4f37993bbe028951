"""The share, in %, of the traced epoch's device-idle time that lies inside
none of the trainer's program spans: what the spans leave unexplained."""

from portbench import spans

SPANS = ("train.permute", "train.gather", "train.dispatch", "train.losses",
         "train.save_best", "train.snapshot", "train.capture")


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None:
        return None
    return spans.unattributed_share(trace, SPANS)
