"""Device operations (kernels, copies, fills) a minibatch in the traced
epoch: CUDA-graph replays counted kernel by kernel, as the device ran
them."""


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None or not trace.device:
        return None
    return len(trace.device) / len(out["trace_info"]["minibatches"])
