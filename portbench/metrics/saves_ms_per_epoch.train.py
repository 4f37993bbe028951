"""Device-idle time inside the trainer's saves, in ms an epoch: the idle
stretches of the traced epochs (from one end-of-epoch line to a later
one) that lie inside the program's ``train.save_best`` (the best-loss
checkpoint) and ``train.snapshot`` (the epoch's ``.trainstate``) spans,
over the traced epochs."""

from portbench import spans

SPANS = ("train.save_best", "train.snapshot")


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None or not spans.present(trace, SPANS):
        return None
    return spans.idle_inside(trace, SPANS) * 1e3 / spans.traced_epochs(ctx, out)
