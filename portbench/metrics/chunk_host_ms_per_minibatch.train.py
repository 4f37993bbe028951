"""Device-idle time inside the trainer's walk over its chunks, in ms a
minibatch: the idle stretches of the traced epochs that lie inside the
program's ``train.permute``, ``train.gather``, ``train.dispatch`` and
``train.losses`` spans, over the traced epochs' minibatches."""

from portbench import spans

SPANS = ("train.permute", "train.gather", "train.dispatch", "train.losses")


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None or not spans.present(trace, SPANS):
        return None
    minibatches = spans.traced_epochs(ctx, out) * len(out["trace_info"]["minibatches"])
    return spans.idle_inside(trace, SPANS) * 1e3 / minibatches
