"""The whole window's share of the card's bf16 peak, in %: the products of
the calls it completed (the stack at the padded batches and the projection,
``portbench.counts_vgg``; the beam at the group, ``portbench.counts``)
over its wall time."""

from portbench import counts


def read(ctx, out):
    info = out["trace_info"]
    if ctx.device == "cpu" or info["window_s"] <= 0:
        return None
    return 100.0 * info["window_flops"] / info["window_s"] / counts.PEAK_BF16
