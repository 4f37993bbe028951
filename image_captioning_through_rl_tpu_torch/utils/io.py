"""File IO and counters matching the reference conventions."""

from __future__ import annotations

import contextlib
import os
import tempfile

# the process umask, read once at import (os.umask can only be read by
# setting it), restored on the files that mkstemp creates 0600
UMASK = os.umask(0)
os.umask(UMASK)


@contextlib.contextmanager
def atomic_write(path: str):
    """Yield a binary file handle that publishes to ``path`` atomically: a
    unique temp file in the target directory, the umask's mode, then
    ``os.replace``. On error the temp file is removed and nothing is
    published."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            yield f
        os.chmod(tmp, 0o666 & ~UMASK)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def append_results(results_path: str, text: str, header: str = "results") -> None:
    """Append a banner-delimited block to the results file (reference
    trainers.py:394-397, utilities.py:354-358)."""
    os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
    with open(results_path, "a") as f:
        f.write("\n" + "-" * 10 + f" {header} " + "-" * 10 + "\n")
        f.write(text)
        f.write("\n" + "-" * 10 + f" {header} " + "-" * 10 + "\n")


def global_minibatch_number(epoch: int, batch_id: int, batch_size: int) -> int:
    """The metric-log x-axis, the reference's ``epoch * batch_size +
    batch_id`` (quirk Q10: it scales by the batch size, not by the batches
    per epoch)."""
    return epoch * batch_size + batch_id
