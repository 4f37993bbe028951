"""The numbers a training cell's check compares: gaps between norms, leaf
by leaf, each against the reference's norm of that leaf or of the median
leaf, whichever is larger (some gradients are all but zero)."""

from __future__ import annotations

import torch


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tree.items()}


def counted(ref_grad: dict) -> list:
    """The leaves a check counts: those whose reference gradient is at
    least a thousandth of the median leaf's (a leaf whose gradient is nought
    to rounding moves under Adam by round-off alone)."""
    n = norms(ref_grad)
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= 1e-3 * med]


def worst_leaf_gap(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    """``max over leaves | |prog_l| - |ref_l| | / max(|ref_l|, median |ref|)``
    and the leaf that gives it."""
    np_, nr = norms({k: prog[k] for k in leaves}), norms({k: ref[k] for k in leaves})
    med = sorted(nr.values())[len(nr) // 2]
    worst, at = -1.0, ""
    for k in leaves:
        gap = abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, "/".join(k)
    return worst, at
