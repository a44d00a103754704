"""Serving observability: the flight recorder and roofline attribution.

:mod:`.recorder` keeps a bounded ring of the batcher's phase events;
:mod:`.roofline` measures the device's ceilings and tags each dispatch with
its achieved fraction of them. Both are off unless a
``ContinuousBatcher(flight_recorder=...)`` is built with one.
:mod:`.timeline` folds the recorder's events into per-request timelines
and :mod:`.slo` keeps streaming latency digests and error-budget burn
(:class:`SLOTracker`, a recorder listener the control plane reads).
:func:`register_build_info` labels a registry with the build: the artifact
schema version (:mod:`beholder_tpu_torch.artifact`), the package version
and the torch version (the reference's label is ``jax_version``).

Not ported: the reference's sentinel, retention vault and flight plane,
and ``flight_recorder_from_config``.
"""

from .recorder import (
    DEFAULT_RING_SIZE,
    WORKER_TID_BASE,
    FlightRecorder,
    chrome_trace,
    parse_cursor,
)
from .roofline import (
    PHASE_FAMILIES,
    RooflineAttributor,
    attribution_summary,
    model_flops_per_token,
)
from .slo import (
    LatencyDigest,
    P2Quantile,
    SLOConfig,
    SLOTracker,
    slo_from_config,
)
from .timeline import (
    RequestTimeline,
    TimelineReport,
    build_timelines,
    phase_walls,
)

__all__ = [
    "DEFAULT_RING_SIZE",
    "FlightRecorder",
    "LatencyDigest",
    "P2Quantile",
    "PHASE_FAMILIES",
    "RequestTimeline",
    "RooflineAttributor",
    "SLOConfig",
    "SLOTracker",
    "TimelineReport",
    "WORKER_TID_BASE",
    "attribution_summary",
    "build_timelines",
    "chrome_trace",
    "model_flops_per_token",
    "parse_cursor",
    "phase_walls",
    "register_build_info",
    "slo_from_config",
]


def register_build_info(registry):
    """Register the ``beholder_build_info`` gauge (value 1.0, labels:
    artifact schema version, package version, torch version), so merged
    traces and artifacts are attributable to a build. Version probes are
    best-effort and import-light (``importlib.metadata``, never ``import
    torch``)."""
    from importlib import metadata

    from beholder_tpu_torch.artifact import SCHEMA_VERSION
    from beholder_tpu_torch.metrics import get_or_create

    def probe(dist: str) -> str:
        try:
            return metadata.version(dist)
        except Exception:  # noqa: BLE001 - a missing dist is a label, not a crash
            return "unknown"

    gauge = get_or_create(
        registry, "gauge", "beholder_build_info",
        "Build identity (value is always 1; the labels carry it)",
        labelnames=["schema_version", "package_version", "torch_version"],
    )
    gauge.set(
        1.0,
        schema_version=str(SCHEMA_VERSION),
        package_version=probe("beholder-tpu"),
        torch_version=probe("torch"),
    )
    return gauge
