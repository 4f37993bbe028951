"""What the training entries share: one trainer call whose first epochs are
set-up and whose next epochs are the window, timed by the trainer's own
end-of-epoch lines (printed after each epoch's saves), with the traced
stretch one more epoch after the window; and the result's ``device``."""

from __future__ import annotations

import time

from . import harness


def device_info(ctx) -> dict:
    import torch
    if ctx.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(ctx.memory_peak)}


def read_peak(ctx) -> None:
    import torch
    if ctx.device != "cpu":
        torch.cuda.synchronize()
        ctx.memory_peak = torch.cuda.max_memory_allocated()


def timed_epochs(ctx, desc: str, call, warm: int, epochs: int) -> dict:
    """Run ``call()`` (one trainer call of ``warm + epochs`` epochs, one more
    when traced), keep an ``epoch`` span for each epoch line, and return the
    window's bounds from those spans: the end of epoch ``warm`` to the end
    of epoch ``warm + epochs``. A traced run's profiler runs from the
    window's end through the next epoch."""
    tracer = ctx.tracer

    def on_epoch(count, t):
        if tracer is not None and count == warm + epochs:
            tracer.start()
        elif tracer is not None and count == warm + epochs + 1:
            tracer.stop()

    clock = harness.EpochClock(desc, on_epoch)
    t0 = time.perf_counter()
    with clock.installed():
        call()
    need = warm + epochs + (1 if tracer is not None else 0)
    if len(clock.times) != need:
        raise RuntimeError(f"the trainer printed {len(clock.times)} epoch lines, {need} expected")
    for s, e in zip([t0] + clock.times[:-1], clock.times):
        ctx.spans.add("epoch", s, e)
    ep = ctx.spans.of("epoch")
    return {"start": ep[warm - 1][1], "end": ep[warm + epochs - 1][1]}
