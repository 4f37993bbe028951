"""Caption decoding: greedy, per-sample value-guided beam search and
stochastic sampling."""

from .beam import beam_search
from .greedy import greedy_decode, greedy_decode_full_prefix
from .sample import filter_logits, sample_decode, sample_decode_full_prefix, sample_decode_n

__all__ = ["beam_search", "filter_logits", "greedy_decode", "greedy_decode_full_prefix",
           "sample_decode", "sample_decode_full_prefix", "sample_decode_n"]
