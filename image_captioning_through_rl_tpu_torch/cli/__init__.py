"""Command-line drivers of the port: the pipeline (:mod:`.main`), scoring
(:mod:`.score`), export to the reference ``.pt`` layout (:mod:`.export`),
the dataset builder (:mod:`.build_data`) and reference-checkpoint parity
(:mod:`.verify_reference`)."""

from .main import build_arg_parser, main, setup

__all__ = ["build_arg_parser", "main", "setup"]
