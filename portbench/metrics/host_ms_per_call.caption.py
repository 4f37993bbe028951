"""Host time a ``Captioner.caption`` call: the benchmark's ``traced_call``
spans around the traced calls, less the device's busy time, over the
calls. The calls run back to back and each ends with its tokens on the
host, so the device work of each lies inside its span."""


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    calls = ctx.spans.of("traced_call")
    if trace is None or not trace.device or not calls:
        return None
    spans = sum(e - s for s, e in calls)
    return max(0.0, spans - trace.busy_s()) * 1e3 / len(calls)
