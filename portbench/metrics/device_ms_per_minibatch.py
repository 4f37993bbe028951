"""Device busy time a minibatch: the union of the device operations'
intervals in the traced epoch over the minibatches it held."""


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None or not trace.device:
        return None
    return trace.busy_s() * 1e3 / len(out["trace_info"]["minibatches"])
