"""Caption decoding: greedy, value-guided beam search (per sample or
faithful to quirk Q2) and stochastic sampling, each with its full-prefix
oracle, and the Q1-stateful faithful beam of :mod:`.beam_compat`."""

from .beam import beam_search, beam_search_full_prefix
from .beam_compat import beam_search_compat
from .greedy import greedy_decode, greedy_decode_full_prefix
from .sample import filter_logits, sample_decode, sample_decode_full_prefix, sample_decode_n

__all__ = ["beam_search", "beam_search_compat", "beam_search_full_prefix", "filter_logits",
           "greedy_decode", "greedy_decode_full_prefix", "sample_decode",
           "sample_decode_full_prefix", "sample_decode_n"]
