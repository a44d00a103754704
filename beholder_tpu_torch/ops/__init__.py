"""Tensor ops of the port: quantizers, attention, the paged decode and
chunk kernels."""

#: telemetry status count (copied from the reference's ``ops/aggregate.py``;
#: the port imports nothing from the JAX package)
NUM_STATUSES = 6

__all__ = ["NUM_STATUSES"]
