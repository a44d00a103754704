"""Tail-based trace retention: decide what to keep after the outcome.

The port's own copy of the reference's ``obs/retention.py`` (host-side
Python, no device work). The flight recorder's ring evicts fastest exactly
when traffic is heaviest, so the slow request is the one whose trace fell
off; head sampling cannot fix that, since the interesting requests are
defined by how they end. :class:`TraceVault` buffers every request's events
while it is in flight and decides keep or drop at retirement, when the
outcome, latency and recovery history are known.

Keep predicates (each kept trace records which fired):

- ``slo_bad``: the request broke a latency objective of the linked
  :class:`~beholder_tpu_torch.obs.slo.SLOTracker`'s config;
- ``outcome:*``: ``Dropped``, ``Preempted``, ``deadline_exceeded`` and
  ``dropped`` retirements;
- ``recovery``: the request was recovered across a failover leg;
- ``p99_tail``: its TTFT reached its worker's live p99, probed read-only
  from the SLO tracker's P² digests;
- ``head_sample``: every Nth evaluated request, a healthy baseline;
- ``incident``: an open incident keeps everything, up to its budget.

Kept traces land in a byte- and count-bounded vault (oldest evicted),
served at ``GET /debug/traces`` (index) and ``GET /debug/traces/<id>``
(one request as Perfetto JSON through :mod:`beholder_tpu_torch.tools.
trace_export`), and dumped at shutdown with shift rotation
(``vault.jsonl`` -> ``vault.jsonl.1`` -> ...).

:meth:`TraceVault.open_incident` (called by the regression sentinel on a
verdict, or on a fast burn) boosts retention to keep-everything, bounded by
``incident_budget``; traces kept meanwhile carry the incident id, and the
incident record carries the sentinel's ranked explanation. With a flight
plane linked (:meth:`TraceVault.link_flight_plane`), incident-kept traces
are assembled from the merged plane timeline (every worker's ring on one
clock) instead of the local buffer and carry ``federated: true``; any merge
problem falls back to the local assembly.

Off by default (``instance.observability.retention.*``,
:func:`beholder_tpu_torch.obs.retention_from_config`): serving output and
the /metrics exposition are unchanged and the debug routes 404.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable

from .slo import CLUSTER_SCOPE
from .timeline import _key_of, build_timelines

#: retirements that keep a trace regardless of latency — the request
#: did not complete (``req.retire`` outcomes plus the ``req.dropped``
#: instant's implicit ``dropped``)
BAD_OUTCOMES = frozenset(
    {"Dropped", "Preempted", "dropped", "deadline_exceeded"}
)

#: digest observations a worker scope needs before its p99 is a
#: meaningful tail bound (five P² markers plus headroom)
MIN_TAIL_COUNT = 10

DEFAULT_MAX_TRACES = 256
DEFAULT_MAX_BYTES = 8 * 1024 * 1024
DEFAULT_ROTATE_KEEP = 3


def _key_repr(key: Any) -> str | int | float:
    """The vault's request-key normalization — IDENTICAL to the SLO
    tracker's ``worst_request["key"]`` rendering, so ``trace_ref``
    lookups join on the same string."""
    return key if isinstance(key, (str, int, float)) else repr(key)


def _rotate_vault_locked(path: str, keep: int) -> None:
    """Shift-style rotation: ``path`` → ``path.1`` → ... → ``path.keep``
    (oldest dropped) — the obs-jsonl log's discipline
    (:func:`beholder_tpu_torch.metrics._rotate_observation_log_locked`), so
    consecutive SIGTERM dumps keep bounded history instead of
    overwriting the one vault an incident needed."""
    oldest = f"{path}.{keep}"
    if os.path.exists(oldest):
        os.remove(oldest)
    for i in range(keep - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i + 1}")
    if os.path.exists(path):
        os.replace(path, f"{path}.1")


@dataclass
class RetentionConfig:
    """Declarative retention policy (``instance.observability.
    retention.*``).

    - ``max_traces`` / ``max_bytes``: the vault's count and byte
      bounds (oldest-evicted);
    - ``head_sample_every``: keep every Nth evaluated request as
      healthy baseline (0 disables head sampling);
    - ``tail_quantile``: the per-worker digest quantile a TTFT must
      reach to be tail-kept;
    - ``incident_budget``: traces one incident may force-keep;
    - ``export_path`` / ``rotate_keep``: the SIGTERM dump location and
      how many rotated generations to keep;
    - ``max_open`` / ``max_events_per_trace``: bounded-memory caps on
      the in-flight buffers (a claim whose retire never comes must not
      leak, and one pathological request must not eat the vault).
    """

    max_traces: int = DEFAULT_MAX_TRACES
    max_bytes: int = DEFAULT_MAX_BYTES
    head_sample_every: int = 0
    tail_quantile: float = 0.99
    incident_budget: int = 64
    export_path: str | None = None
    rotate_keep: int = DEFAULT_ROTATE_KEEP
    max_open: int = 4096
    max_events_per_trace: int = 2048

    def __post_init__(self):
        if self.max_traces < 1:
            raise ValueError(
                f"max_traces must be >= 1, got {self.max_traces}"
            )
        if self.max_bytes < 1:
            raise ValueError(
                f"max_bytes must be >= 1, got {self.max_bytes}"
            )
        if not 0.0 < self.tail_quantile < 1.0:
            raise ValueError(
                f"tail_quantile must be in (0, 1), got {self.tail_quantile}"
            )


class TraceVault:
    """The tail-based retention engine: a flight-recorder listener
    that buffers per-request events while requests are in flight and
    runs the keep/drop decision at retirement.

    ``slo`` (a :class:`~beholder_tpu_torch.obs.slo.SLOTracker`, optional)
    arms the ``slo_bad`` and ``p99_tail`` predicates — probed
    READ-ONLY (the vault never creates digest scopes). ``registry``
    arms the ``beholder_retention_*`` catalog, registered only when a
    vault exists — the default exposition stays byte-identical.
    ``clock`` is injectable for deterministic tests.
    """

    #: event names that close a request's lifecycle and trigger the
    #: keep/drop decision
    TERMINAL = frozenset({"req.retire", "req.dropped"})

    def __init__(
        self,
        config: RetentionConfig | None = None,
        slo=None,
        registry=None,
        clock: Callable[[], float] = time.time,
    ):
        self.config = config or RetentionConfig()
        self.slo = slo
        self._clock = clock
        self._lock = threading.RLock()
        #: recent-event buffer the per-request assembly selects from:
        #: sized to the worst trace times a small in-flight factor,
        #: bounded like the recorder ring
        self._buffer: deque[dict[str, Any]] = deque(
            maxlen=self.config.max_events_per_trace * 4
        )
        #: open request key -> {"trace_ids": set, "worker": str|None}
        self._open: "OrderedDict[Any, dict[str, Any]]" = OrderedDict()
        #: kept traces: id -> {"summary": dict, "events": list,
        #: "bytes": int}, oldest first (the eviction order)
        self._vault: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        self._by_key: dict[Any, str] = {}
        self._by_trace: dict[str, str] = {}
        self.evaluated = 0
        self.kept = 0
        self.evicted = 0
        self.bytes = 0
        self._id_seq = 0
        #: incident state: the ACTIVE incident dict (or None) plus a
        #: bounded history of closed ones
        self.incident: dict[str, Any] | None = None
        #: cluster flight plane (see :meth:`link_flight_plane`) —
        #: None keeps every assembly local, byte-identically
        self._flight_plane = None
        self.federated = 0
        self.incidents_opened = 0
        self._incident_seq = 0
        self._incident_history: deque[dict[str, Any]] = deque(maxlen=8)
        self._metrics = None
        if registry is not None:
            from beholder_tpu_torch.metrics import get_or_create

            registry = getattr(registry, "registry", registry)
            self._metrics = {
                "evaluated": get_or_create(
                    registry, "counter",
                    "beholder_retention_evaluated_total",
                    "Retired requests evaluated against the tail-based "
                    "keep predicates",
                ),
                "kept": get_or_create(
                    registry, "counter",
                    "beholder_retention_kept_total",
                    "Traces kept by the tail-based retention vault, by "
                    "the first predicate that fired",
                    labelnames=["reason"],
                ),
                "traces": get_or_create(
                    registry, "gauge",
                    "beholder_retention_vault_traces",
                    "Traces currently resident in the bounded vault",
                ),
                "bytes": get_or_create(
                    registry, "gauge",
                    "beholder_retention_vault_bytes",
                    "Serialized bytes currently resident in the bounded "
                    "vault",
                ),
                "incidents": get_or_create(
                    registry, "counter",
                    "beholder_retention_incidents_total",
                    "Incidents opened on the vault (sentinel verdicts "
                    "and fast-burn breaches)",
                ),
            }

    def link_flight_plane(self, flight_plane) -> None:
        """Arm cross-worker federation: incident-kept traces assemble
        from the MERGED cluster flight plane
        (:func:`~beholder_tpu_torch.obs.flightplane.merge`) instead of the
        local buffer, so the vault's evidence spans every worker a
        recovered request touched. No-op retention change outside an
        incident — the ordinary keep path stays byte-identical."""
        with self._lock:
            self._flight_plane = flight_plane

    # -- the streaming fold (flight-recorder listener) -------------------

    def on_event(self, event: dict[str, Any]) -> None:
        """Fold one flight-recorder event. Must never raise into the
        serving path — the recorder swallows listener errors, but the
        vault still guards its own state under a lock."""
        with self._lock:
            self._on_event(event)

    def _on_event(self, event: dict[str, Any]) -> None:
        name = event.get("name")
        self._buffer.append(event)
        if name == "req.claim":
            key = _key_of(event)
            entry = self._open.get(key)
            if entry is None:
                while len(self._open) >= self.config.max_open:
                    self._open.popitem(last=False)
                entry = self._open[key] = {
                    "trace_ids": set(),
                    "worker": None,
                }
            if event.get("trace_id") is not None:
                entry["trace_ids"].add(event["trace_id"])
            worker = event.get("args", {}).get("worker")
            if worker is not None:
                entry["worker"] = worker
        elif name == "req.recovered":
            entry = self._open.get(_key_of(event))
            if entry is not None:
                worker = event.get("args", {}).get("worker")
                if worker is not None:
                    entry["worker"] = worker
        elif name in self.TERMINAL:
            self._retire(event)

    # -- the keep/drop decision ------------------------------------------

    def _retire(self, event: dict[str, Any]) -> None:
        key = _key_of(event)
        entry = self._open.pop(key, None)
        trace_ids = entry["trace_ids"] if entry else set()
        if event.get("trace_id") is not None:
            trace_ids.add(event["trace_id"])
        self.evaluated += 1
        events = self._assemble(key, trace_ids)
        timeline = build_timelines(events).by_key().get(key)
        outcome = (
            "dropped"
            if event.get("name") == "req.dropped"
            else event.get("args", {}).get("outcome", "ok")
        )
        worker = (
            event.get("args", {}).get("worker")
            or (entry["worker"] if entry else None)
        )
        reasons = self._reasons(timeline, outcome, worker)
        if self._metrics is not None:
            self._metrics["evaluated"].inc()
        if not reasons:
            return
        self._keep(key, trace_ids, events, timeline, outcome, reasons)

    def _assemble(self, key, trace_ids: set) -> list[dict[str, Any]]:
        """Select the retiring request's events out of the recent
        buffer: its own ``req.*`` instants plus every round slice on
        one of its legs' traces (the even-split attribution unit the
        timeline fold charges it from), capped to the per-trace
        bound."""
        out = []
        for e in self._buffer:
            if e.get("trace_id") in trace_ids or _key_of(e) == key:
                out.append(e)
        cap = self.config.max_events_per_trace
        return out[-cap:] if len(out) > cap else out

    def _reasons(
        self, timeline, outcome: str, worker: str | None
    ) -> list[str]:
        reasons: list[str] = []
        if (
            self.incident is not None
            and self.incident["kept"] < self.config.incident_budget
        ):
            reasons.append("incident")
        if outcome in BAD_OUTCOMES or (
            outcome != "ok" and outcome not in ("", None)
        ):
            reasons.append(f"outcome:{outcome}")
        ttft_s = timeline.ttft_s if timeline is not None else None
        tpot_s = timeline.tpot_s if timeline is not None else None
        if timeline is not None and (
            timeline.recovered
            or timeline.recovery_s > 0.0
            or any(h.get("type") == "recovery" for h in timeline.hops)
        ):
            reasons.append("recovery")
        if self.slo is not None:
            cfg = self.slo.config
            if (
                ttft_s is not None and ttft_s * 1e3 > cfg.ttft_ms
            ) or (tpot_s is not None and tpot_s * 1e3 > cfg.tpot_ms):
                reasons.append("slo_bad")
            if ttft_s is not None and self._tail_hit(ttft_s, worker):
                reasons.append("p99_tail")
        if (
            self.config.head_sample_every > 0
            and self.evaluated % self.config.head_sample_every == 0
        ):
            reasons.append("head_sample")
        return reasons

    def _tail_hit(self, ttft_s: float, worker: str | None) -> bool:
        """Probe the live P² digests READ-ONLY: does this TTFT reach
        its worker's (or the cluster's) tail quantile? A scope that
        has not digested :data:`MIN_TAIL_COUNT` requests abstains —
        five samples do not define a p99."""
        digests = getattr(self.slo, "_digests", None)
        if not digests:
            return False
        scope = digests.get(worker) if worker else None
        if scope is None:
            scope = digests.get(CLUSTER_SCOPE)
        if scope is None:
            return False
        ttft = scope["ttft"]
        if ttft.count < MIN_TAIL_COUNT:
            return False
        # the digests track a fixed quantile set — snap the configured
        # tail to the nearest tracked estimator rather than raising
        # into the serving path
        tracked = getattr(ttft, "_quantiles", None)
        q = self.config.tail_quantile
        if tracked and q not in tracked:
            q = min(tracked, key=lambda t: abs(t - q))
        return ttft_s >= ttft.quantile(q)

    def _federate(self, key, trace_ids) -> list | None:
        """Assemble this request's events out of the MERGED cluster
        flight plane: every worker's plane ring skew-aligned onto the
        cluster clock, then the same trace/key selection the local
        buffer uses. Returns None (caller falls back to the local
        assembly) when the plane holds fewer than two rings or
        anything about the merge fails — federation must never raise
        into the serving path."""
        try:
            from .flightplane import merge

            rings = self._flight_plane.rings()
            if len(rings) < 2:
                return None
            merged = merge(rings)
            out = [
                e for e in merged.events
                if e.get("trace_id") in trace_ids or _key_of(e) == key
            ]
            if not out:
                return None
            cap = self.config.max_events_per_trace
            return out[-cap:] if len(out) > cap else out
        except Exception:  # pragma: no cover - defensive
            return None

    def _keep(
        self, key, trace_ids, events, timeline, outcome, reasons
    ) -> None:
        self._id_seq += 1
        federated = None
        if self._flight_plane is not None and "incident" in reasons:
            federated = self._federate(key, trace_ids)
            if federated is not None:
                events = federated
                self.federated += 1
        primary_trace = next(
            (t for t in sorted(trace_ids, key=str) if t), None
        )
        trace_id = primary_trace or f"req-{self._id_seq}"
        vault_id = f"{trace_id}-{self._id_seq}"
        payload = "".join(
            json.dumps(e, default=str) + "\n" for e in events
        ).encode()
        summary: dict[str, Any] = {
            "id": vault_id,
            "key": _key_repr(key),
            "trace_id": primary_trace,
            "kept_unix_s": round(self._clock(), 3),
            "reasons": reasons,
            "outcome": outcome,
            "events": len(events),
            "bytes": len(payload),
        }
        if federated is not None:
            summary["federated"] = True
        if timeline is not None:
            summary["timeline"] = timeline.to_dict()
        if self.incident is not None and "incident" in reasons:
            summary["incident"] = self.incident["id"]
            self.incident["kept"] += 1
            self.incident["trace_ids"].append(vault_id)
        self._vault[vault_id] = {
            "summary": summary,
            "events": list(events),
            "bytes": len(payload),
        }
        self._by_key[summary["key"]] = vault_id
        if primary_trace:
            self._by_trace[primary_trace] = vault_id
        self.kept += 1
        self.bytes += len(payload)
        # count+byte bounds: evict oldest until both hold (the vault's
        # bounded-memory contract — same shape as the recorder ring)
        while self._vault and (
            len(self._vault) > self.config.max_traces
            or self.bytes > self.config.max_bytes
        ):
            if len(self._vault) == 1:
                # an empty vault serves no one: the newest trace stays
                # resident even when it alone exceeds the byte budget
                break
            evicted_id, evicted = self._vault.popitem(last=False)
            self.bytes -= evicted["bytes"]
            self.evicted += 1
            summary_e = evicted["summary"]
            if self._by_key.get(summary_e["key"]) == evicted_id:
                del self._by_key[summary_e["key"]]
            t = summary_e.get("trace_id")
            if t and self._by_trace.get(t) == evicted_id:
                del self._by_trace[t]
        if self._metrics is not None:
            self._metrics["kept"].inc(reason=reasons[0])
            self._metrics["traces"].set(float(len(self._vault)))
            self._metrics["bytes"].set(float(self.bytes))

    # -- incident-scoped capture ------------------------------------------

    def open_incident(
        self,
        reason: str,
        explanation: dict[str, Any] | None = None,
    ) -> dict[str, Any]:
        """Open (or return the already-open) incident: retention
        boosts to keep-everything until ``incident_budget`` traces are
        stamped or :meth:`close_incident` runs. ``explanation`` is the
        sentinel's ranked verdict, carried on the incident record so
        ``GET /debug/traces`` serves the WHY next to the evidence."""
        with self._lock:
            if self.incident is not None:
                return self.incident
            self._incident_seq += 1
            self.incidents_opened += 1
            self.incident = {
                "id": f"inc-{self._incident_seq}",
                "opened_unix_s": round(self._clock(), 3),
                "reason": reason,
                "explanation": explanation,
                "budget": self.config.incident_budget,
                "kept": 0,
                "trace_ids": [],
            }
            if self._metrics is not None:
                self._metrics["incidents"].inc()
            return self.incident

    def close_incident(self) -> dict[str, Any] | None:
        """Close the active incident (no-op when none): the record —
        with its kept-trace ids — moves to the bounded history served
        by the index route."""
        with self._lock:
            incident = self.incident
            if incident is None:
                return None
            incident["closed_unix_s"] = round(self._clock(), 3)
            self._incident_history.append(incident)
            self.incident = None
            return incident

    # -- lookups (the trace_ref joins) ------------------------------------

    def trace_ref(self, key_or_trace_id: Any) -> str | None:
        """Vault id for a request key (the SLO ``worst_request`` join)
        or a trace id (the histogram-exemplar join); None when the
        vault does not hold it — callers leave ``trace_ref`` absent,
        keeping the off-shape pinned."""
        if key_or_trace_id is None:
            return None
        with self._lock:
            ref = self._by_trace.get(key_or_trace_id)
            if ref is not None:
                return ref
            return self._by_key.get(_key_repr(key_or_trace_id))

    def get(self, vault_id: str) -> dict[str, Any] | None:
        with self._lock:
            entry = self._vault.get(vault_id)
            if entry is None:
                return None
            return {
                "summary": dict(entry["summary"]),
                "events": list(entry["events"]),
            }

    def index(self) -> dict[str, Any]:
        """The ``GET /debug/traces`` body: counters, the active
        incident + history, and every resident trace's summary
        (newest last — the eviction order)."""
        with self._lock:
            return {
                "schema": "beholder-trace-vault",
                "kept": self.kept,
                "evaluated": self.evaluated,
                "evicted": self.evicted,
                "resident": len(self._vault),
                "bytes": self.bytes,
                "max_traces": self.config.max_traces,
                "max_bytes": self.config.max_bytes,
                "incident": (
                    dict(self.incident) if self.incident else None
                ),
                "incidents": [
                    dict(i) for i in self._incident_history
                ],
                "traces": [
                    dict(entry["summary"])
                    for entry in self._vault.values()
                ],
            }

    def artifact_summary(self) -> dict[str, Any]:
        """The bench artifact's schema-v13 ``retention`` block, minus
        ``overhead_ratio`` (a bench-level interleaved measurement the
        scenario adds)."""
        with self._lock:
            return {
                "kept": float(self.kept),
                "evaluated": float(self.evaluated),
                "keep_rate": (
                    round(self.kept / self.evaluated, 6)
                    if self.evaluated
                    else 0.0
                ),
                "incidents": float(self.incidents_opened),
            }

    # -- routes -----------------------------------------------------------

    def index_route(self):
        """httpd Route for ``GET /debug/traces``."""

        def traces_index_route():
            return (
                200,
                "application/json",
                json.dumps(self.index()).encode(),
            )

        return traces_index_route

    def trace_route(self):
        """httpd PREFIX Route for ``GET /debug/traces/<id>``: one kept
        trace rendered as Chrome trace-event JSON (Perfetto /
        chrome://tracing), 404 for an id the vault no longer holds."""

        def trace_detail_route(subpath: str):
            entry = self.get(subpath)
            if entry is None:
                return (
                    404,
                    "application/json",
                    json.dumps({"error": f"no trace {subpath!r}"}).encode(),
                )
            from beholder_tpu_torch.tools.trace_export import chrome_trace

            doc = chrome_trace(entry["events"])
            doc["vault"] = entry["summary"]
            if entry["summary"].get("federated"):
                # the events came from the merged cluster flight
                # plane, not this worker's local buffer
                doc["federated"] = True
            return 200, "application/json", json.dumps(doc).encode()

        trace_detail_route.wants_path = True
        return trace_detail_route

    # -- export -----------------------------------------------------------

    def dump(self, path: str | None = None) -> str:
        """Write the vault as JSON lines (a ``trace.vault`` header then
        one line per kept trace: summary + events), rotating any
        existing file shift-style first — the service's SIGTERM hook,
        landing next to the flight-recorder ring."""
        path = path or self.config.export_path
        if not path:
            raise ValueError("no path given and no export_path configured")
        with self._lock:
            _rotate_vault_locked(path, self.config.rotate_keep)
            with open(path, "w") as f:
                f.write(
                    json.dumps(
                        {
                            "name": "trace.vault",
                            "ph": "M",
                            "kept": self.kept,
                            "evaluated": self.evaluated,
                            "evicted": self.evicted,
                            "resident": len(self._vault),
                            "incidents": [
                                dict(i) for i in self._incident_history
                            ] + (
                                [dict(self.incident)]
                                if self.incident
                                else []
                            ),
                        },
                        default=str,
                    ) + "\n"
                )
                for entry in self._vault.values():
                    f.write(
                        json.dumps(
                            {
                                "summary": entry["summary"],
                                "events": entry["events"],
                            },
                            default=str,
                        ) + "\n"
                    )
        return path
