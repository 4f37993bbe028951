"""Status printing, metric logs and file IO of the port (counterparts of
the JAX package's ``utils/logging.py`` and ``utils/io.py``)."""
