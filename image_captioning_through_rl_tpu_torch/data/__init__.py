"""Data helpers of the port: the COCO vocabulary and caption decoding."""
