"""The LSTM chain forward's share of its roofline, in %: the bound of the
traced epoch's chain forwards (``portbench.counts.chain_fwd`` at each
minibatch's rows, 16 steps and the kernels' table width) over the device
time of the kernels a chain forward launches, found by name (the chunks
replay as CUDA graphs, so no host range holds them)."""

from portbench import counts

# the chain's x-gate table (one product of the table and wi) and its
# recurrence
KERNELS = ("lstm_fwd_kernel",
           "wgmma_gemm_kernel<false, true, icrl::(anonymous namespace)::DenseRows, "
           "icrl::(anonymous namespace)::DenseRows, 1>")
WORK = counts.chain_fwd


def read(ctx, out):
    trace = ctx.tracer.trace if ctx.tracer else None
    if trace is None:
        return None
    ops = trace.named(KERNELS)
    info = out["trace_info"]
    seconds = sum(e - s for _, s, e, _ in ops) * 1e-6
    if seconds <= 0:
        return None
    v, e, h, _ = info["shape"]
    bound = sum(WORK("lstm", n, info["steps"], v, e, h).bound_s() for n in info["minibatches"])
    return 100.0 * bound / seconds
