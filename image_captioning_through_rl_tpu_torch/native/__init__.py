"""Native (C++) host code: ``fastmetrics``, the n-gram scorers of the
evaluation path (corpus BLEU statistics, CIDEr, ROUGE-L and METEOR's
exact + stem aligner), built on demand with the system ``g++`` and loaded
through ctypes. It is host code, not a CUDA kernel. Everything here is
optional: without the toolchain the callers score in pure Python, with
the same numbers.
"""

from .build import load_fastmetrics, native_available

__all__ = ["load_fastmetrics", "native_available"]
