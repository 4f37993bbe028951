"""Command-line drivers of the port: the pipeline (:mod:`.main`), scoring
(:mod:`.score`), export to the reference ``.pt`` layout (:mod:`.export`)
and the dataset builder (:mod:`.build_data`)."""

from .main import build_arg_parser, main, setup

__all__ = ["build_arg_parser", "main", "setup"]
