"""The device's idle share of the traced stretch, in %: one less the union
of the device operations' intervals over the stretch's wall time."""


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s() / trace.window_s)
