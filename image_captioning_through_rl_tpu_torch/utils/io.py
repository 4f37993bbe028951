"""File IO and counters matching the reference conventions."""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

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


@contextlib.contextmanager
def atomic_path(path: str):
    """Like :func:`atomic_write`, but yields the temp file's *path*, for
    writers that take a file name; the same contract: a unique temp file in
    the target directory, the umask's mode, ``os.replace``, nothing
    published on error."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    os.close(fd)
    try:
        yield tmp
        os.chmod(tmp, 0o666 & ~UMASK)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def resolve_checkpoint(directory: str, fname: str) -> str:
    """A network file in ``directory``: the native ``.ckpt`` name when it
    exists, else the reference ``.pt`` of the same stem when that exists,
    else the ``.ckpt`` name (so a path can point straight at a reference
    ``models_pretrained/`` directory)."""
    path = os.path.join(directory or ".", fname)
    if not os.path.exists(path):
        pt = os.path.splitext(path)[0] + ".pt"
        if os.path.exists(pt):
            return pt
    return path


def get_filename(base_name: str, bidirectional: bool, curriculum: Optional[bool] = None) -> str:
    """Checkpoint and result names: ``_bidirectional`` and/or
    ``_curriculum`` before the extension (reference utilities.py:326-338),
    e.g. ``a2cNetwork.ckpt`` -> ``a2cNetwork_bidirectional_curriculum.ckpt``."""
    name, ext = os.path.splitext(base_name)
    if bidirectional:
        name += "_bidirectional"
    if curriculum:
        name += "_curriculum"
    return name + ext


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
