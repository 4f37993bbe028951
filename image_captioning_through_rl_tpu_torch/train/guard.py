"""Failure detection: the non-finite-loss training guard (counterpart of
the JAX ``train/guard.py``).

Every trainer reads each minibatch loss back to the host anyway (best-loss
bookkeeping and the metric log), so the guard costs nothing on the device:
the first non-finite loss raises :class:`TrainingDiverged`, after the
implicated weights are dumped next to the trainer's checkpoint.
``ICRL_NO_NAN_GUARD=1`` restores the reference's keep-going behaviour.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

_ENV_DISABLE = "ICRL_NO_NAN_GUARD"


class TrainingDiverged(RuntimeError):
    """Raised when a trainer produces a non-finite loss."""


def guard_enabled() -> bool:
    # only an affirmative value disables it: ICRL_NO_NAN_GUARD=0 keeps it
    return os.environ.get(_ENV_DISABLE, "0").lower() in ("", "0", "false", "no")


def check_finite(loss: float, what: str, where: str,
                 dump: Optional[Callable[[str], None]] = None,
                 dump_path: Optional[str] = None) -> None:
    """Raise :class:`TrainingDiverged` if ``loss`` (a host float) is NaN or
    infinite. ``dump(dump_path)``, when both are given, saves the
    implicated weights first."""
    if math.isfinite(loss) or not guard_enabled():
        return
    msg = (f"{what} loss became {loss} at {where} — training halted "
           f"(the reference would keep going: a non-finite loss poisons "
           f"the Adam moments and every later update)")
    if dump is not None and dump_path:
        try:
            dump(dump_path)
            msg += f"; implicated weights dumped to {dump_path}"
        except OSError as e:  # the dump must never mask the diagnosis
            msg += f"; weight dump to {dump_path} failed ({e!r})"
    msg += (". Resume from the last saved checkpoint, or set "
            f"{_ENV_DISABLE}=1 to disable this guard.")
    raise TrainingDiverged(msg)
