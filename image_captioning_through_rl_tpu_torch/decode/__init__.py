"""Caption decoding: greedy, per-sample value-guided beam search and
stochastic sampling, each with its full-prefix oracle."""

from .beam import beam_search, beam_search_full_prefix
from .greedy import greedy_decode, greedy_decode_full_prefix
from .sample import filter_logits, sample_decode, sample_decode_full_prefix, sample_decode_n

__all__ = ["beam_search", "beam_search_full_prefix", "filter_logits", "greedy_decode",
           "greedy_decode_full_prefix", "sample_decode", "sample_decode_full_prefix",
           "sample_decode_n"]
