"""The beam search's share of its roofline, in %: the bound of the traced
calls (``portbench.counts.beam`` at the group's rows and the beam width)
over the device time of the kernels a ``fused_beam_search`` call
launches, found by name; the traced calls are the benchmark's
``traced_call`` spans."""

from portbench import counts

KERNELS = ("beam_kernel", "beam_start_check_kernel")


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    calls = len(ctx.spans.of("traced_call"))
    if trace is None or not calls:
        return None
    seconds = sum(e - s for _, s, e, _ in trace.named(KERNELS)) * 1e-6
    if seconds <= 0:
        return None
    info = out["trace_info"]
    bound = calls * counts.beam(info["group"], *info["shape"]).bound_s()
    return 100.0 * bound / seconds
