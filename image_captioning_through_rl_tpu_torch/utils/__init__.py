"""Status printing, metric logs, file IO, the msgpack subset of native
checkpoints and tracing of the port (counterparts of the JAX package's
``utils/logging.py``, ``utils/io.py`` and ``utils/profiling.py``)."""
