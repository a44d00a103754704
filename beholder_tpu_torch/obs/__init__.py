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

:mod:`.flightplane` merges per-worker rings into one cluster timeline
(:class:`FlightPlane`, :func:`merge`), :mod:`.retention` keeps traces by
how their requests ended (:class:`TraceVault`) and :mod:`.sentinel` flags
phase regressions online and opens incidents on the vault
(:class:`Sentinel`). :func:`chrome_trace` is
:mod:`beholder_tpu_torch.tools.trace_export`'s, re-exported here.

:func:`flight_recorder_from_config`, :func:`flight_plane_from_config`,
:func:`retention_from_config` and :func:`sentinel_from_config` build the
service's pieces from ``instance.observability.*``; each is None when off.
"""

from beholder_tpu_torch.tools.trace_export import WORKER_TID_BASE, chrome_trace

from .flightplane import (
    FlightPlane,
    MergedTimeline,
    Ring,
    flight_plane_from_config,
    load_rings,
    merge,
    split_rings,
)
from .recorder import DEFAULT_RING_SIZE, FlightRecorder, parse_cursor
from .retention import RetentionConfig, TraceVault
from .roofline import (
    PHASE_FAMILIES,
    RooflineAttributor,
    attribution_summary,
    model_flops_per_token,
)
from .sentinel import Sentinel, SentinelConfig
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
    "FlightPlane",
    "FlightRecorder",
    "LatencyDigest",
    "MergedTimeline",
    "P2Quantile",
    "PHASE_FAMILIES",
    "RequestTimeline",
    "RetentionConfig",
    "Ring",
    "RooflineAttributor",
    "SLOConfig",
    "SLOTracker",
    "Sentinel",
    "SentinelConfig",
    "TimelineReport",
    "TraceVault",
    "WORKER_TID_BASE",
    "attribution_summary",
    "build_timelines",
    "chrome_trace",
    "flight_plane_from_config",
    "flight_recorder_from_config",
    "load_rings",
    "merge",
    "model_flops_per_token",
    "parse_cursor",
    "phase_walls",
    "register_build_info",
    "retention_from_config",
    "sentinel_from_config",
    "slo_from_config",
    "split_rings",
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


def retention_from_config(config, slo=None, registry=None) -> TraceVault | None:
    """Build the tail-based trace vault from ``instance.observability.
    retention.*``, or None when disabled (the default: serving output and
    the /metrics exposition are unchanged, the ``/debug/traces`` routes
    404).

    Keys: ``enabled`` (bool), ``max_traces`` / ``max_bytes`` (the vault's
    bounds), ``head_sample_every`` (0 disables head sampling),
    ``tail_quantile``, ``incident_budget``, ``export_path`` (the shutdown
    dump, rotated shift-style), ``rotate_keep``. ``slo`` is the live
    :class:`SLOTracker` (arms the slo_bad and p99_tail predicates);
    ``registry`` arms the ``beholder_retention_*`` series."""
    node = config.get("instance.observability.retention")
    if node is None or not node.get("enabled"):
        return None
    cfg = RetentionConfig(
        max_traces=int(node.get("max_traces", RetentionConfig.max_traces)),
        max_bytes=int(node.get("max_bytes", RetentionConfig.max_bytes)),
        head_sample_every=int(node.get("head_sample_every", 0)),
        tail_quantile=float(node.get("tail_quantile", RetentionConfig.tail_quantile)),
        incident_budget=int(node.get("incident_budget", RetentionConfig.incident_budget)),
        export_path=node.get("export_path"),
        rotate_keep=int(node.get("rotate_keep", RetentionConfig.rotate_keep)),
    )
    return TraceVault(cfg, slo=slo, registry=registry)


def sentinel_from_config(config, slo=None, vault=None, registry=None) -> Sentinel | None:
    """Build the online regression sentinel from ``instance.observability.
    sentinel.*``, or None when disabled (the default: the exposition is
    unchanged and ``/debug/sentinel`` 404s).

    Keys: ``enabled`` (bool), ``bucket_s``, ``fast_buckets``,
    ``baseline_buckets``, ``growth_threshold``, ``min_rate``,
    ``open_after`` / ``close_after`` (verdict hysteresis), ``check_every``.
    ``slo`` arms the fast-burn incident trigger; ``vault`` receives
    incident open and close calls; ``registry`` arms the
    ``beholder_sentinel_*`` series."""
    node = config.get("instance.observability.sentinel")
    if node is None or not node.get("enabled"):
        return None
    cfg = SentinelConfig(
        bucket_s=float(node.get("bucket_s", SentinelConfig.bucket_s)),
        fast_buckets=int(node.get("fast_buckets", SentinelConfig.fast_buckets)),
        baseline_buckets=int(node.get("baseline_buckets", SentinelConfig.baseline_buckets)),
        growth_threshold=float(node.get("growth_threshold", SentinelConfig.growth_threshold)),
        min_rate=float(node.get("min_rate", SentinelConfig.min_rate)),
        open_after=int(node.get("open_after", SentinelConfig.open_after)),
        close_after=int(node.get("close_after", SentinelConfig.close_after)),
        check_every=int(node.get("check_every", SentinelConfig.check_every)),
    )
    return Sentinel(cfg, slo=slo, vault=vault, registry=registry)
