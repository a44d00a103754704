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

:func:`flight_recorder_from_config` builds the service's recorder from
``instance.observability.flight_recorder.*``.

Not ported: the reference's sentinel, retention vault and flight plane.
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
    "flight_recorder_from_config",
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


def flight_recorder_from_config(config, device=None) -> FlightRecorder | None:
    """Build the flight recorder from ``instance.observability.
    flight_recorder.*`` config, or None when disabled (the default).

    Keys: ``enabled`` (bool), ``ring_size`` (int, default 4096 — the
    bounded event memory), ``export_path`` (str; the service dumps the
    ring there on shutdown), ``ceiling_interval_s`` (float, default 300 —
    how often the roofline attributor re-measures the device's ceilings;
    <= 0 disables attribution entirely). ``device`` is where the
    attributor measures (None: the card, raising where there is none).
    """
    node = config.get("instance.observability.flight_recorder")
    if node is None or not node.get("enabled"):
        return None
    interval = float(node.get("ceiling_interval_s", 300.0))
    attributor = (
        RooflineAttributor(interval_s=interval, device=device) if interval > 0 else None
    )
    return FlightRecorder(
        ring_size=int(node.get("ring_size", DEFAULT_RING_SIZE)),
        attributor=attributor,
        export_path=node.get("export_path"),
    )
