"""Data layer of the port: the COCO bundle's loader (on the port's own
HDF5 reader), batching, text decoding and the synthetic bundle."""

from .coco import (
    CocoData,
    decode_captions,
    get_coco_batch,
    get_coco_minibatches,
    get_coco_validation_data,
    load_data,
)
from .synthetic import make_synthetic_coco

__all__ = [
    "CocoData",
    "load_data",
    "decode_captions",
    "get_coco_batch",
    "get_coco_minibatches",
    "get_coco_validation_data",
    "make_synthetic_coco",
]
