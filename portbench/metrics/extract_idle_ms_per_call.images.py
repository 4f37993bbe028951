"""Device-idle time inside the visual front end, in ms a call: the idle
stretches of the traced stretch that lie inside the program's
``extract.pixels_in``, ``extract.stack`` and ``extract.features_out``
spans (``models/vgg.iter_features``), over the traced calls (the
benchmark's ``traced_call`` spans)."""

from portbench import spans

SPANS = ("extract.pixels_in", "extract.stack", "extract.features_out")


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    calls = len(ctx.spans.of("traced_call"))
    if trace is None or not calls or not spans.present(trace, SPANS):
        return None
    return spans.idle_inside(trace, SPANS) * 1e3 / calls
