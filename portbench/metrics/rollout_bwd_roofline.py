"""The rollout backward's share of its roofline, in %: the bound of the
calls the traced epoch made (``portbench.counts.rollout_bwd`` at each
minibatch's rows and steps) over the device time of every operation the
calls launched, found by the host range of the rollout's
``autograd.Function``'s backward (``_RolloutKernelBackward``)."""

from portbench import counts

RANGE = "_RolloutKernelBackward"
WORK = counts.rollout_bwd


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None:
        return None
    per_call = trace.in_ranges(RANGE)
    info = out["trace_info"]
    if not per_call or len(per_call) != len(info["minibatches"]) or sum(per_call) <= 0:
        return None
    bound = sum(WORK(n, info["steps"], *info["shape"]).bound_s() for n in info["minibatches"])
    return 100.0 * bound / sum(per_call)
