"""Runnable demos of the port's serving path (ports of
`examples/continuous_batching.py` and `examples/approx_serving.py`)."""
