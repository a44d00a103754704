"""Tensor ops of the port: quantizers, attention, the paged decode and
chunk kernels, flash attention, and telemetry aggregation."""

#: the telemetry status enum in value order (proto ``api.TelemetryStatusEntry``,
#: QUEUED = 0 .. ERRORED = 5; copied: the port imports nothing from the JAX
#: package)
STATUS_NAMES = ("QUEUED", "DOWNLOADING", "CONVERTING", "UPLOADING", "DEPLOYED", "ERRORED")
#: telemetry status count
NUM_STATUSES = len(STATUS_NAMES)

from .aggregate import (  # noqa: E402  (needs the names above)
    aggregate_telemetry,
    aggregate_telemetry_reference,
    ewma,
    status_counts,
)
from .fused_aggregate import aggregate_telemetry_fused  # noqa: E402

__all__ = [
    "NUM_STATUSES",
    "STATUS_NAMES",
    "aggregate_telemetry",
    "aggregate_telemetry_fused",
    "aggregate_telemetry_reference",
    "ewma",
    "status_counts",
]
