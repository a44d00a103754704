"""The request-level SLO engine: streaming digests and error-budget burn.

The port's own copy of the reference's ``obs/slo.py`` (host-side Python).
It speaks the unit an operator pages on, per-request TTFT and TPOT against
declared objectives, and derives every number from the events the serving
path already emits (the flight recorder's round slices and the ``req.*``
lifecycle instants; see :mod:`beholder_tpu_torch.obs.timeline`), never
from a device read.

- :class:`P2Quantile` / :class:`LatencyDigest`: streaming quantiles by the
  P² algorithm (Jain & Chlamtac 1985), five markers a quantile, O(1) per
  observation.
- :class:`SLOTracker`: declarative objectives with multi-window
  error-budget burn rates (a fast window that pages, a slow one that
  confirms), per-scope digests (the cluster and each worker) and
  per-tenant digests and burn, which the control plane
  (:mod:`beholder_tpu_torch.control.policy`) reads. The ``beholder_slo_*``
  catalog registers only when a registry is given, and :meth:`SLOTracker.
  route` renders :meth:`SLOTracker.snapshot` as a ``(status, content
  type, body)`` triple for an HTTP server to serve.
- the listener bridge: :meth:`SLOTracker.on_event` is a
  :class:`~beholder_tpu_torch.obs.recorder.FlightRecorder` listener that
  folds lifecycle events as they are recorded (the streaming twin of
  :func:`~beholder_tpu_torch.obs.timeline.build_timelines`).

A request is good when it completed (no deadline or drop outcome) inside
both latency objectives; the error budget is ``1 - target``; the burn
rate over a window is ``bad_fraction / error_budget``.

On the card the TTFT it folds is host time: an ``admit`` round's event
ends when the host has enqueued the round (see the timeline module).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from .timeline import _key_of

#: the cluster-wide digest scope (per-worker scopes ride worker names)
CLUSTER_SCOPE = "cluster"

#: quantiles every digest tracks (the exposition's ``quantile`` label)
DIGEST_QUANTILES = (0.5, 0.95, 0.99)


class P2Quantile:
    """Streaming quantile via the P² algorithm: five markers whose
    heights chase the desired quantile positions — O(1) memory and
    O(1) per observation, no sample list ever. Until five samples
    arrive the estimate is exact over what was seen."""

    __slots__ = ("q", "_first", "_heights", "_pos", "_want", "_inc")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._first: list[float] = []
        self._heights: list[float] | None = None
        self._pos: list[float] = []
        self._want: list[float] = []
        self._inc: list[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        if self._heights is None:
            self._first.append(x)
            if len(self._first) == 5:
                self._first.sort()
                self._heights = list(self._first)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._want = [
                    1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0,
                ]
                self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
            return
        h, pos = self._heights, self._pos
        if x < h[0]:
            h[0] = x
            cell = 0
        elif x >= h[4]:
            h[4] = x
            cell = 3
        else:
            cell = 0
            for i in range(1, 5):
                if x < h[i]:
                    cell = i - 1
                    break
        for i in range(cell + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._inc[i]
        for i in range(1, 4):
            delta = self._want[i] - pos[i]
            if (delta >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                delta <= -1.0 and pos[i - 1] - pos[i] < -1.0
            ):
                step = 1.0 if delta >= 0.0 else -1.0
                candidate = self._parabolic(i, step)
                if h[i - 1] < candidate < h[i + 1]:
                    h[i] = candidate
                else:  # parabola left the bracket: linear fallback
                    j = i + int(step)
                    h[i] = h[i] + step * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += step

    def _parabolic(self, i: int, step: float) -> float:
        h, pos = self._heights, self._pos
        return h[i] + step / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + step)
            * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - step)
            * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1])
        )

    def value(self) -> float:
        if self._heights is not None:
            return self._heights[2]
        if not self._first:
            return 0.0
        ordered = sorted(self._first)
        idx = min(
            len(ordered) - 1, int(round(self.q * (len(ordered) - 1)))
        )
        return ordered[idx]


class LatencyDigest:
    """Constant-memory latency summary: count/sum/min/max plus one
    :class:`P2Quantile` per tracked quantile."""

    __slots__ = ("count", "total", "min", "max", "_quantiles")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._quantiles = {q: P2Quantile(q) for q in DIGEST_QUANTILES}

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        for estimator in self._quantiles.values():
            estimator.observe(value)

    def quantile(self, q: float) -> float:
        return self._quantiles[q].value()

    def to_dict(self, unit_scale: float = 1.0) -> dict[str, float]:
        out = {
            f"p{int(q * 100)}": round(self.quantile(q) * unit_scale, 4)
            for q in DIGEST_QUANTILES
        }
        out["count"] = self.count
        out["mean"] = round(
            (self.total / self.count) * unit_scale if self.count else 0.0, 4
        )
        out["max"] = round((self.max or 0.0) * unit_scale, 4)
        return out


class _Window:
    """Good/bad counts over a sliding window, coarse-bucketed so memory
    is a fixed ~30 buckets regardless of request rate or uptime."""

    __slots__ = ("window_s", "bucket_s", "_buckets")

    def __init__(self, window_s: float, buckets: int = 30):
        self.window_s = float(window_s)
        self.bucket_s = max(self.window_s / buckets, 1e-9)
        self._buckets: list[list[float]] = []  # [idx, good, bad]

    def _prune(self, now: float) -> None:
        floor = (now - self.window_s) / self.bucket_s
        while self._buckets and self._buckets[0][0] < floor:
            self._buckets.pop(0)

    def add(self, now: float, good: bool) -> None:
        idx = now // self.bucket_s
        self._prune(now)
        if not self._buckets or self._buckets[-1][0] != idx:
            self._buckets.append([idx, 0.0, 0.0])
        self._buckets[-1][1 if good else 2] += 1.0

    def totals(self, now: float) -> tuple[float, float]:
        self._prune(now)
        return (
            sum(b[1] for b in self._buckets),
            sum(b[2] for b in self._buckets),
        )


@dataclass
class SLOConfig:
    """Declarative serving objectives (``instance.slo.*``).

    A request is good when TTFT <= ``ttft_ms``, its mean per-token
    latency <= ``tpot_ms`` (only checked when the request decoded more
    than one token), and it completed (deadline/drop outcomes are bad
    by definition). ``target`` is the attainment objective; the error
    budget is ``1 - target``. :meth:`SLOTracker.health` reports
    unhealthy while the fast-window burn exceeds
    ``fast_burn_threshold``."""

    ttft_ms: float = 1000.0
    tpot_ms: float = 250.0
    target: float = 0.99
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn_threshold: float = 14.4

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}"
            )
        if self.ttft_ms <= 0 or self.tpot_ms <= 0:
            raise ValueError("latency objectives must be positive")


class SLOTracker:
    """Live SLO state for one serving process.

    Feed it either way: attach :meth:`on_event` as a flight-recorder
    listener (the engine's ``req.*`` instants drive it — the daemon
    path), or call :meth:`observe` directly with per-request latencies
    (the library/bench path). ``clock`` is injectable so window math is
    deterministically testable.

    ``registry`` arms the ``beholder_slo_*`` catalog (requests by
    verdict, TTFT/TPOT quantile gauges per scope, burn-rate and
    attainment/budget gauges), registered in the constructor, so a
    process that never builds a tracker exposes not one extra series."""

    #: open-request table bound: a claim whose retire never arrives
    #: (ring drop, crash) must not leak forever
    MAX_OPEN = 4096

    def __init__(
        self,
        config: SLOConfig | None = None,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        # monotonic by default (same reasoning as the intake queue's
        # wait stamps): the windows only ever use clock DIFFERENCES,
        # and an NTP step must not zero a live burn mid-incident or
        # interleave out-of-order buckets
        self.config = config or SLOConfig()
        self._clock = clock
        #: readers may probe from their own threads while the serving
        #: thread observes: every public entry point takes this
        #: (re-entrant: observe() reads burn_rate() internally)
        self._lock = threading.RLock()
        #: the tail-based retention vault (:meth:`link_vault`): linked,
        #: rendered worst_request blocks carry a ``trace_ref``
        self._vault = None
        self.good = 0
        self.bad = 0
        self.dropped_open = 0
        self.worst_request: dict[str, Any] = {}
        self._digests: dict[str, dict[str, LatencyDigest]] = {}
        self._queue_wait = LatencyDigest()
        self._windows = {
            "fast": _Window(self.config.fast_window_s),
            "slow": _Window(self.config.slow_window_s),
        }
        #: per-tenant state (control subsystem): TTFT digests + a
        #: fast-window good/bad count per tenant id, built lazily on
        #: the first tenanted observation — an untenanted fleet holds
        #: not one extra byte here. The control plane's tenant-fair
        #: admission and the /slo "tenants" block read these.
        self._tenants: dict[str, dict[str, Any]] = {}
        #: streaming fold state: open request key -> lifecycle scratch
        self._open: dict[Any, dict[str, Any]] = {}
        self._metrics = None
        if registry is not None:
            from beholder_tpu_torch.metrics import get_or_create

            registry = getattr(registry, "registry", registry)
            self._metrics = {
                "requests": get_or_create(
                    registry, "counter",
                    "beholder_slo_requests_total",
                    "Requests classified against the serving SLOs, by "
                    "verdict (good = inside every latency objective)",
                    labelnames=["verdict"],
                ),
                "ttft": get_or_create(
                    registry, "gauge",
                    "beholder_slo_ttft_seconds",
                    "Streaming TTFT quantiles (P2 digest), by quantile "
                    "and scope (cluster-wide plus per worker)",
                    labelnames=["quantile", "scope"],
                ),
                "tpot": get_or_create(
                    registry, "gauge",
                    "beholder_slo_tpot_seconds",
                    "Streaming per-token-latency quantiles (P2 digest), "
                    "by quantile and scope",
                    labelnames=["quantile", "scope"],
                ),
                "burn": get_or_create(
                    registry, "gauge",
                    "beholder_slo_burn_rate",
                    "Error-budget burn rate per alerting window (1.0 "
                    "spends the budget exactly at the objective's pace)",
                    labelnames=["window"],
                ),
                "attainment": get_or_create(
                    registry, "gauge",
                    "beholder_slo_attainment",
                    "Fraction of classified requests inside every "
                    "objective (lifetime)",
                ),
                "budget": get_or_create(
                    registry, "gauge",
                    "beholder_slo_error_budget_remaining",
                    "1 - slow-window burn rate: the error budget left "
                    "at the current pace (negative = overspent)",
                ),
            }

    # -- the streaming fold (flight-recorder listener) -------------------

    def on_event(self, event: dict[str, Any]) -> None:
        """Fold one flight-recorder event. Must never raise into the
        serving path — unknown events are ignored. One known streaming
        limitation (the offline fold in :mod:`.timeline` reconciles
        it): a request that retires ON a shard whose batch then fails
        wholesale observes once for the voided leg and once for the
        recovered one — the stream can't retract an observation it
        already classified."""
        with self._lock:
            self._on_event(event)

    def _on_event(self, event: dict[str, Any]) -> None:
        name = event.get("name")
        args = event.get("args", {})
        if name == "req.claim":
            key = _key_of(event)
            existing = self._open.get(key)
            if existing is not None:
                # a recovery re-claim: TTFT keeps running from the
                # ORIGINAL claim; the new leg only resets first-token
                existing["trace"] = event.get("trace_id")
                existing["first_us"] = None
                existing["worker"] = args.get(
                    "worker", existing["worker"]
                )
                existing["slot"] = args.get("slot", existing["slot"])
                return
            if len(self._open) >= self.MAX_OPEN:
                self._open.pop(next(iter(self._open)))
                self.dropped_open += 1
            self._open[key] = {
                "claim_us": int(event.get("ts_us", 0)),
                "trace": event.get("trace_id"),
                "queue_wait_s": float(args.get("queue_wait_s") or 0.0),
                "first_us": None,
                "worker": args.get("worker"),
                "slot": args.get("slot"),
                "tenant": args.get("tenant"),
            }
        elif name == "req.recovered":
            entry = self._open.get(_key_of(event))
            if entry is not None:
                # the next admit on the surviving worker is the real
                # first token; TTFT keeps running from the ORIGINAL claim
                entry["first_us"] = None
                entry["worker"] = args.get("worker", entry["worker"])
        elif name == "req.retire":
            entry = self._open.pop(_key_of(event), None)
            if entry is None:
                return
            ts = int(event.get("ts_us", 0))
            first = entry["first_us"] if entry["first_us"] is not None else ts
            ttft_s = max(0.0, (first - entry["claim_us"]) / 1e6)
            tokens = int(args.get("tokens", 0))
            tpot_s = (
                max(0.0, (ts - first) / 1e6) / (tokens - 1)
                if tokens > 1
                else None
            )
            self.observe(
                ttft_s,
                tpot_s=tpot_s,
                worker=args.get("worker", entry["worker"]),
                key=_key_of(event),
                queue_wait_s=entry["queue_wait_s"],
                outcome=args.get("outcome", "ok"),
                tenant=entry.get("tenant"),
            )
        elif name == "req.dropped":
            # the failover layer lost this request (recovery_limit /
            # shard_down): a bad outcome — attainment and burn must
            # see it even though no req.retire will ever come
            entry = self._open.pop(_key_of(event), None)
            ts = int(event.get("ts_us", 0))
            self.observe(
                (
                    max(0.0, (ts - entry["claim_us"]) / 1e6)
                    if entry is not None
                    else 0.0
                ),
                worker=entry["worker"] if entry else None,
                key=_key_of(event),
                queue_wait_s=(
                    entry["queue_wait_s"] if entry else 0.0
                ),
                outcome="dropped",
                # never-claimed drops (queued preemptions) have no open
                # entry — the instant itself carries the tenant
                tenant=args.get("tenant") or (
                    entry.get("tenant") if entry else None
                ),
            )
        elif name == "deadline_exceeded" and args.get("stage") == "claim":
            # expired while QUEUED (the recovery-storm overload mode):
            # no req.claim/req.retire ever comes, but the request IS a
            # bad outcome — the burn-rate page exists exactly for this
            entry = self._open.pop(_key_of(event), None)
            ts = int(event.get("ts_us", 0))
            ttft_s = (
                max(0.0, (ts - entry["claim_us"]) / 1e6)
                if entry is not None
                else 0.0
            )
            self.observe(
                ttft_s,
                worker=args.get(
                    "worker", entry["worker"] if entry else None
                ),
                key=_key_of(event),
                queue_wait_s=float(args.get("queue_wait_s") or 0.0),
                outcome="deadline_exceeded",
                tenant=entry.get("tenant") if entry else None,
            )
        elif name in ("admit", "wave") and event.get("ph") == "X":
            end = int(event.get("ts_us", 0)) + int(event.get("dur_us", 0))
            trace = event.get("trace_id")
            slot = args.get("slot")
            for entry in self._open.values():
                if (
                    entry["first_us"] is None
                    and entry["trace"] == trace
                    and entry["claim_us"] <= end
                    # a slot-tagged admit (the disagg lane's
                    # per-request rounds) is first-token for THAT
                    # slot's request only — same pin the offline fold
                    # applies; untagged batched admits stamp every
                    # claimant (one program prefilled them all)
                    and (
                        slot is None
                        or entry["slot"] is None
                        or entry["slot"] == slot
                    )
                ):
                    entry["first_us"] = end

    # -- direct observation ----------------------------------------------

    def _digest(self, scope: str) -> dict[str, LatencyDigest]:
        digest = self._digests.get(scope)
        if digest is None:
            digest = self._digests[scope] = {
                "ttft": LatencyDigest(),
                "tpot": LatencyDigest(),
            }
        return digest

    def observe(
        self,
        ttft_s: float,
        tpot_s: float | None = None,
        worker: str | None = None,
        key: Any = None,
        queue_wait_s: float = 0.0,
        outcome: str = "ok",
        tenant: str | None = None,
    ) -> bool:
        """Classify one completed request against the objectives and
        fold its latencies into the digests/windows (plus the tenant's
        own digest/window when a ``tenant`` id is attached). Returns
        the good/bad verdict."""
        with self._lock:
            return self._observe(
                ttft_s, tpot_s, worker, key, queue_wait_s, outcome,
                tenant,
            )

    def _observe(
        self, ttft_s, tpot_s, worker, key, queue_wait_s, outcome,
        tenant=None,
    ) -> bool:
        cfg = self.config
        good = (
            outcome == "ok"
            and ttft_s * 1e3 <= cfg.ttft_ms
            and (tpot_s is None or tpot_s * 1e3 <= cfg.tpot_ms)
        )
        now = self._clock()
        if good:
            self.good += 1
        else:
            self.bad += 1
        for window in self._windows.values():
            window.add(now, good)
        scopes = [CLUSTER_SCOPE] + ([worker] if worker else [])
        for scope in scopes:
            digest = self._digest(scope)
            digest["ttft"].observe(ttft_s)
            if tpot_s is not None:
                digest["tpot"].observe(tpot_s)
        if tenant is not None:
            entry = self._tenants.get(tenant)
            if entry is None:
                entry = self._tenants[tenant] = {
                    "ttft": LatencyDigest(),
                    "good": 0,
                    "bad": 0,
                    "window": _Window(self.config.fast_window_s),
                }
            entry["ttft"].observe(ttft_s)
            entry["good" if good else "bad"] += 1
            entry["window"].add(now, good)
        self._queue_wait.observe(queue_wait_s)
        if (
            not self.worst_request
            or ttft_s * 1e3 > self.worst_request["ttft_ms"]
        ):
            self.worst_request = {
                "key": (
                    key if isinstance(key, (str, int, float))
                    else repr(key)
                ),
                "ttft_ms": round(ttft_s * 1e3, 3),
                "outcome": outcome,
            }
        if self._metrics is not None:
            self._metrics["requests"].inc(
                verdict="good" if good else "bad"
            )
            for scope in scopes:
                digest = self._digest(scope)
                for q in DIGEST_QUANTILES:
                    self._metrics["ttft"].set(
                        digest["ttft"].quantile(q),
                        quantile=f"{q:g}", scope=scope,
                    )
                    if digest["tpot"].count:
                        self._metrics["tpot"].set(
                            digest["tpot"].quantile(q),
                            quantile=f"{q:g}", scope=scope,
                        )
            for name in ("fast", "slow"):
                self._metrics["burn"].set(
                    self.burn_rate(name), window=name
                )
            self._metrics["attainment"].set(self.attainment())
            self._metrics["budget"].set(self.budget_remaining())
        return good

    # -- derived state -----------------------------------------------------

    def attainment(self) -> float:
        with self._lock:
            total = self.good + self.bad
            return self.good / total if total else 1.0

    def burn_rate(self, window: str = "fast") -> float:
        with self._lock:
            good, bad = self._windows[window].totals(self._clock())
            total = good + bad
            if not total:
                return 0.0
            return (bad / total) / (1.0 - self.config.target)

    def budget_remaining(self) -> float:
        """1 - slow-window burn: the budget left at the current pace
        (negative means the window already overspent it)."""
        return 1.0 - self.burn_rate("slow")

    # -- control-plane accessors (the acting half reads these) -----------

    def scope_tail_ratio(self, scope: str = CLUSTER_SCOPE) -> float:
        """p95/p50 TTFT of one digest scope — the tail-inflation signal
        the control plane's routing policy avoids shards on (a worker
        whose tail detaches from its median is struggling even when its
        pool shows free pages). 0.0 until the scope has digested a
        request with a nonzero median."""
        with self._lock:
            digest = self._digests.get(scope)
            if digest is None:
                return 0.0
            p50 = digest["ttft"].quantile(0.5)
            if p50 <= 0.0:
                return 0.0
            return digest["ttft"].quantile(0.95) / p50

    def tenant_burn(self, tenant: str) -> float:
        """Fast-window error-budget burn for ONE tenant (0.0 for a
        tenant never observed) — the per-tenant page the fair-admission
        layer prioritizes under pressure."""
        with self._lock:
            entry = self._tenants.get(tenant)
            if entry is None:
                return 0.0
            good, bad = entry["window"].totals(self._clock())
            total = good + bad
            if not total:
                return 0.0
            return (bad / total) / (1.0 - self.config.target)

    def tenant_stats(self) -> dict[str, dict[str, Any]]:
        """Per-tenant snapshot: request verdicts, streaming TTFT
        quantiles (ms), and the fast-window burn — the /slo and
        /control ``tenants`` block, and the replay harness's fairness
        evidence."""
        with self._lock:
            return self._tenants_snapshot()

    def health(self) -> tuple[bool, Any]:
        """The health contract: unhealthy while the fast-window burn
        rate exceeds its threshold (the page-now signal of the
        multi-window pattern); otherwise the burn/attainment detail."""
        with self._lock:
            return self._health()

    def _health(self) -> tuple[bool, Any]:
        burn_fast = self.burn_rate("fast")
        if burn_fast > self.config.fast_burn_threshold:
            return False, (
                f"slo fast-window burn rate {burn_fast:.2f}x exceeds "
                f"threshold {self.config.fast_burn_threshold:g} "
                f"(attainment {self.attainment():.4f})"
            )
        return True, {
            "burn_fast": round(burn_fast, 4),
            "burn_slow": round(self.burn_rate("slow"), 4),
            "attainment": round(self.attainment(), 6),
        }

    def snapshot(self) -> dict[str, Any]:
        """The ``/slo`` body: objectives, attainment, budget, burn per
        window, and the per-scope latency digests."""
        with self._lock:
            return self._snapshot()

    def _snapshot(self) -> dict[str, Any]:
        cfg = self.config
        return {
            "objectives": {
                "ttft_ms": cfg.ttft_ms,
                "tpot_ms": cfg.tpot_ms,
                "target": cfg.target,
            },
            "windows": {
                "fast_s": cfg.fast_window_s,
                "slow_s": cfg.slow_window_s,
            },
            "requests": {"good": self.good, "bad": self.bad},
            "attainment": round(self.attainment(), 6),
            "burn_rate": {
                "fast": round(self.burn_rate("fast"), 4),
                "slow": round(self.burn_rate("slow"), 4),
            },
            "budget_remaining": round(self.budget_remaining(), 4),
            "fast_burn_threshold": cfg.fast_burn_threshold,
            "healthy": self._health()[0],
            "worst_request": self._worst_request_block(),
            "queue_wait_ms": self._queue_wait.to_dict(unit_scale=1e3),
            "scopes": {
                scope: {
                    "ttft_ms": digest["ttft"].to_dict(unit_scale=1e3),
                    "tpot_ms": digest["tpot"].to_dict(unit_scale=1e3),
                }
                for scope, digest in sorted(self._digests.items())
            },
            "open_requests": len(self._open),
            "dropped_open": self.dropped_open,
            # per-tenant digests/burn (control subsystem): empty for an
            # untenanted fleet — the key is additive, never renamed
            "tenants": self._tenants_snapshot(),
        }

    def _tenants_snapshot(self) -> dict[str, Any]:
        now = self._clock()
        out: dict[str, Any] = {}
        for tenant, entry in sorted(self._tenants.items()):
            good, bad = entry["window"].totals(now)
            total = good + bad
            out[tenant] = {
                "good": entry["good"],
                "bad": entry["bad"],
                "ttft_ms": entry["ttft"].to_dict(unit_scale=1e3),
                "burn_fast": round(
                    (bad / total) / (1.0 - self.config.target)
                    if total
                    else 0.0,
                    4,
                ),
            }
        return out

    def artifact_summary(self) -> dict[str, Any]:
        """The bench artifact's ``slo`` block
        (:data:`beholder_tpu_torch.artifact.EMPTY_SLO`)."""
        with self._lock:
            return self._artifact_summary()

    def _artifact_summary(self) -> dict[str, Any]:
        digest = self._digest(CLUSTER_SCOPE)
        return {
            "ttft_p50_ms": round(digest["ttft"].quantile(0.5) * 1e3, 4),
            "ttft_p95_ms": round(digest["ttft"].quantile(0.95) * 1e3, 4),
            "tpot_p50_ms": round(digest["tpot"].quantile(0.5) * 1e3, 4),
            "attainment": round(self.attainment(), 6),
            "worst_request": self._worst_request_block(),
        }

    def link_vault(self, vault) -> None:
        """Link a tail-based retention vault (:class:`~beholder_tpu_torch.
        obs.retention.TraceVault`): rendered ``worst_request`` blocks gain a
        ``trace_ref`` naming the kept trace when the vault holds one. It is
        resolved at render time: the vault is a later recorder listener
        than the tracker, so the retirement that set worst_request has not
        reached the vault when ``_observe`` runs. With no vault linked the
        block's shape is unchanged."""
        self._vault = vault

    def _worst_request_block(self) -> dict[str, Any]:
        worst = dict(self.worst_request)
        if self._vault is not None and worst:
            ref = self._vault.trace_ref(worst.get("key"))
            if ref is not None:
                worst["trace_ref"] = ref
        return worst

    def route(self):
        """A route rendering :meth:`snapshot` as JSON: a callable
        returning ``(200, "application/json", body)``; the service serves
        it at ``GET /slo`` on the metrics server."""

        def slo_route():
            return (
                200,
                "application/json",
                json.dumps(self.snapshot()).encode(),
            )

        return slo_route


def slo_from_config(config, registry=None) -> SLOTracker | None:
    """Build the SLO tracker from ``instance.slo.*``, or None when
    disabled (the default: serving and the exposition stay
    byte-identical).

    ``config`` is any object with the reference ``ConfigNode``'s dotted
    ``get`` (a node's ``get`` reads below it). Keys: ``enabled``;
    ``objectives.{ttft_ms, tpot_ms, target}``; ``windows.{fast_s,
    slow_s}``; ``burn.fast_threshold``. Attach
    :meth:`SLOTracker.on_event` to a flight recorder to feed it."""
    node = config.get("instance.slo")
    if node is None or not node.get("enabled"):
        return None
    cfg = SLOConfig(
        ttft_ms=float(node.get("objectives.ttft_ms", 1000.0)),
        tpot_ms=float(node.get("objectives.tpot_ms", 250.0)),
        target=float(node.get("objectives.target", 0.99)),
        fast_window_s=float(node.get("windows.fast_s", 300.0)),
        slow_window_s=float(node.get("windows.slow_s", 3600.0)),
        fast_burn_threshold=float(node.get("burn.fast_threshold", 14.4)),
    )
    return SLOTracker(cfg, registry=registry)
