"""The device time of what the program launched inside its own spans: the
launches of the main thread (the one that launches in the image cells)
inside the union of the spans named, matched to device operations by the
profiler's correlation ids (as ``metrics/vgg16_roofline.py`` matches those
of ``extract.stack``)."""

from __future__ import annotations

import bisect
from collections import Counter

from portbench import spans


def device_seconds(trace, names) -> float:
    """The device seconds of the operations launched inside the spans
    named one of ``names``."""
    main = Counter(t for _, _, t in trace.launches).most_common(1)[0][0]
    launches = sorted((s, c) for s, c, t in trace.launches if t == main)
    at = [s for s, _ in launches]
    by_corr: dict = {}
    for _, s, e, c in trace.device:
        by_corr[c] = by_corr.get(c, 0.0) + (e - s) * 1e-6
    return sum(by_corr.get(c, 0.0) for s, e in spans.union(trace, names)
               for _, c in launches[bisect.bisect_left(at, s):bisect.bisect_right(at, e)])


def share(trace, name: str, bound_s: float) -> float | None:
    """``100 x (the spans named name) x bound_s`` over the device time
    launched inside them: a bound a span over the time it took, in %. None
    without a launch, a span or device time."""
    if trace is None or not trace.launches or not spans.present(trace, [name]):
        return None
    seconds = device_seconds(trace, [name])
    if seconds <= 0:
        return None
    return 100.0 * len(spans.union(trace, [name])) * bound_s / seconds
