"""Caption decoding: greedy and per-sample value-guided beam search."""

from .beam import beam_search
from .greedy import greedy_decode, greedy_decode_full_prefix

__all__ = ["beam_search", "greedy_decode", "greedy_decode_full_prefix"]
