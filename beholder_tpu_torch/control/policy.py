"""The control plane's policy engine: burn in, actuation out (the port's
own copy of the reference's ``control/policy.py``).

:class:`ControlPlane` reads the SLO tracker
(:class:`~beholder_tpu_torch.obs.slo.SLOTracker`: burn rates, per-worker
tail ratios, per-tenant stats) and drives four actuators:

- :meth:`ControlPlane.intake` builds the tenant-fair admission queue
  (:class:`~beholder_tpu_torch.control.admission.TenantFairQueue`): the
  cluster router swaps it in per shard, a single batcher takes it as its
  ``intake``;
- :meth:`ControlPlane.spec_k_cap` / :meth:`ControlPlane.on_k_shed` cap the
  adaptive-k controller's draft length while the fast-window burn exceeds
  the spec threshold (:meth:`ControlPlane.attach_spec` wires a batcher);
- :meth:`ControlPlane.route_shard` is the router's control-aware placement
  (tail avoidance and deadline slack over plain pool pressure);
- :meth:`ControlPlane.evaluate_scaling` is the autoscaler: sustained burn
  and pool pressure spawn a decode shard, sustained calm drains one through
  the failover engine's lossless migration.

Every read is host-side; every decision lands on the ``beholder_control_*``
catalog and, with a flight recorder, as recorder-only ``control.*``
instants. The plane holds no device state: dropping it mid-run loses the
policy, never correctness.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable

from . import DEFAULT_TENANT, ControlConfig
from .admission import TenantFairQueue


class ControlPlane:
    """One serving process's policy engine (see module docstring).

    ``tracker`` is the :class:`~beholder_tpu_torch.obs.slo.SLOTracker` whose
    burn/digest stream the plane acts on — without one the spec,
    routing-tail and autoscale actuators stay passive (fair admission
    still works: DRR needs no latency signal). ``registry`` arms the
    ``beholder_control_*`` catalog; ``clock`` is injectable so the
    autoscaler's sustain/cooldown windows are deterministically
    testable."""

    def __init__(
        self,
        config: ControlConfig,
        tracker=None,
        registry=None,
        flight_recorder=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config
        self.tracker = tracker
        self.flight_recorder = flight_recorder
        self._clock = clock
        self.instruments = None
        if registry is not None:
            from .instruments import ControlMetrics

            self.instruments = ControlMetrics(registry)
            self.instruments.export_policy(config)
        #: k-shed evidence (the bench/replay harness reads these)
        self.k_shed_events = 0
        self._k_capped = False
        #: autoscaler state: when the up/down conditions FIRST held
        #: (None = not currently holding), and the last actuation time
        self._up_since: float | None = None
        self._down_since: float | None = None
        self._last_scale: float | None = None
        #: actuation log (bounded): the /control route's recent history
        self.scale_log: list[dict[str, Any]] = []

    # -- tenant-fair admission (actuator a) ------------------------------

    def intake(self, max_depth: int, **kwargs) -> TenantFairQueue:
        """Build a policy-configured
        :class:`~beholder_tpu_torch.control.admission.TenantFairQueue` — the
        drop-in intake for a batcher or a router shard. Keyword args
        pass through to the queue (``max_cost``/``cost_fn``/
        ``metrics``/``name``/``on_preempt``...)."""
        return TenantFairQueue(
            max_depth,
            self.config,
            control_metrics=self.instruments,
            **kwargs,
        )

    # -- SLO-aware speculation (actuator b) ------------------------------

    def spec_k_cap(self) -> int | None:
        """The draft-length cap to apply RIGHT NOW: ``shed_to`` while
        the tracker's fast-window burn exceeds the spec threshold,
        None (uncapped) otherwise. Called by the adaptive-k controller
        once per slot per verify round — O(window buckets), host-only."""
        cfg = self.config.spec
        if cfg is None or self.tracker is None:
            return None
        capped = self.tracker.burn_rate("fast") > cfg.burn_threshold
        if capped != self._k_capped:
            self._k_capped = capped
            if self.instruments is not None:
                self.instruments.k_cap.set(cfg.shed_to if capped else -1)
            if self.flight_recorder is not None:
                self.flight_recorder.instant(
                    "control.k_cap",
                    cap=cfg.shed_to if capped else -1,
                )
        return cfg.shed_to if capped else None

    def on_k_shed(self, slot: int, wanted: int, cap: int) -> None:
        """Controller callback: one draft choice was actually capped
        (``wanted`` > ``cap``) — the k-shed EVENT the catalog counts."""
        self.k_shed_events += 1
        if self.instruments is not None:
            self.instruments.k_shed_total.inc()

    def attach_spec(self, batcher) -> None:
        """Wire a batcher's (current or future) adaptive-k controller
        to this plane: the controller consults :meth:`spec_k_cap`
        every draft choice and reports sheds via :meth:`on_k_shed`.
        Safe before the controller exists — ``run_spec`` re-reads the
        batcher attributes each call."""
        batcher._spec_k_cap_fn = self.spec_k_cap
        batcher._spec_k_shed_cb = self.on_k_shed
        controller = getattr(batcher, "_spec_controller", None)
        if controller is not None:
            controller.k_cap_fn = self.spec_k_cap
            controller.on_k_shed = self.on_k_shed

    # -- deadline- & burn-aware routing (actuator c) ---------------------

    def route_shard(self, candidates: list, need: int, request=None):
        """Pick a shard for one request among routable ``candidates``
        (the router's ``_Shard`` objects). Returns ``(shard, reason)``
        — reason is ``pressure`` when the decision matches the plain
        policy, ``tail_avoid``/``deadline`` when control overrode it —
        or None when routing control is off (caller falls back to its
        own policy).

        Tail avoidance: shards whose per-worker TTFT tail ratio
        (p95/p50 from the tracker's digests) exceeds the threshold are
        excluded while at least one un-inflated candidate remains — a
        struggling shard can show plenty of free pages. Deadline
        slack: a request inside its slack window routes to the
        SHALLOWEST intake (queue depth is TTFT; free pages are
        throughput). Ties break to the lowest shard id, exactly the
        pressure policy's determinism contract."""
        cfg = self.config.routing
        if cfg is None or not candidates:
            return None
        pool = candidates
        avoided = False
        if self.tracker is not None and len(candidates) > 1:
            # one tracker-locked quantile read per candidate (this is
            # the submit hot path); 0.0 = no digest yet, never inflated
            ratios = {
                s.pool.shard_id: self.tracker.scope_tail_ratio(
                    s.pool.name
                )
                for s in candidates
            }
            calm = [
                s for s in candidates
                if ratios[s.pool.shard_id] <= cfg.tail_threshold
            ]
            if calm and len(calm) < len(candidates):
                pool = calm
                avoided = True
        deadline = getattr(request, "deadline", None) if request else None
        urgent = (
            deadline is not None
            and deadline.remaining() < cfg.deadline_slack_s
        )
        if urgent:
            shard = min(
                pool,
                key=lambda s: (
                    s.intake.depth, -s.pool.free, s.pool.shard_id
                ),
            )
            reason = "deadline"
        else:
            shard = max(
                pool, key=lambda s: (s.pool.free, -s.pool.shard_id)
            )
            reason = "tail_avoid" if avoided else "pressure"
        if reason != "pressure" and self.instruments is not None:
            self.instruments.route_overrides_total.inc(reason=reason)
        return shard, reason

    # -- the autoscaler actuator (actuator d) ----------------------------

    def evaluate_scaling(self, scheduler) -> dict[str, Any] | None:
        """One autoscaler decision point (the router calls this at
        ``run_pending`` boundaries; the replay harness between bursts).
        Scale UP when fast burn AND pool pressure sit above their high
        watermarks for ``sustain_s``; scale DOWN (graceful
        byte-identical drain through the failover migration) when both sit below
        the low watermarks that long. Honors [min, max] shard bounds
        and ``cooldown_s`` between actuations. Returns the actuation
        record (also appended to :attr:`scale_log`) or None."""
        cfg = self.config.autoscale
        if cfg is None or self.tracker is None:
            return None
        now = self._clock()
        burn = self.tracker.burn_rate("fast")
        total = scheduler.pool_view.total_pages
        pressure = (
            1.0 - scheduler.pool_view.total_free / total if total else 0.0
        )
        active = self._active_shards(scheduler)
        in_cooldown = (
            self._last_scale is not None
            and now - self._last_scale < cfg.cooldown_s
        )
        event = None
        if burn > cfg.up_burn and pressure > cfg.up_pressure:
            self._down_since = None
            if self._up_since is None:
                self._up_since = now
            elif (
                now - self._up_since >= cfg.sustain_s
                and not in_cooldown
                and len(active) < cfg.max_shards
            ):
                shard = scheduler.scale_up()
                event = self._record_scale(
                    "up", now, burn, pressure,
                    worker=shard.pool.name,
                )
        elif burn < cfg.down_burn and pressure < cfg.down_pressure:
            self._up_since = None
            if self._down_since is None:
                self._down_since = now
            elif (
                now - self._down_since >= cfg.sustain_s
                and not in_cooldown
                and len(active) > cfg.min_shards
                # scale-down IS a graceful drain — without the failover
                # migration machinery there is no lossless path, so the
                # actuator stays passive rather than raising mid-drain
                and scheduler.failover is not None
            ):
                victim = self._drain_target(active)
                report = scheduler.drain(victim.pool.shard_id)
                event = self._record_scale(
                    "down", now, burn, pressure,
                    worker=victim.pool.name,
                    migrated_pages=report["migrated_pages"],
                    requeued=report["requeued"],
                    target=report["target"],
                )
        else:
            self._up_since = self._down_since = None
        return event

    @staticmethod
    def _active_shards(scheduler) -> list:
        fo = scheduler.failover
        if fo is None:
            return list(scheduler.shards)
        from beholder_tpu_torch.cluster.failover import WORKER_UP

        return [
            s for s in scheduler.shards
            if fo.state(s.pool.name) == WORKER_UP
        ]

    @staticmethod
    def _drain_target(active: list):
        """The scale-down victim: the UP shard with the fewest
        committed pages (cheapest migration), ties to the HIGHEST
        shard id (newest capacity leaves first — deterministic)."""
        return min(
            active, key=lambda s: (s.pool.committed, -s.pool.shard_id)
        )

    def _record_scale(
        self, direction: str, now: float, burn: float, pressure: float,
        **extra,
    ) -> dict[str, Any]:
        self._last_scale = now
        self._up_since = self._down_since = None
        event = {
            "direction": direction,
            "burn_fast": round(burn, 4),
            "pool_pressure": round(pressure, 4),
            **extra,
        }
        self.scale_log.append(event)
        del self.scale_log[:-32]  # bounded history
        if self.instruments is not None:
            self.instruments.scale_events_total.inc(direction=direction)
        if self.flight_recorder is not None:
            self.flight_recorder.instant("control.scale", **event)
        return event

    # -- the /control surface --------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """The ``/control`` body: declared policy, per-tenant
        live stats, actuator state, and the recent actuation log."""
        cfg = self.config
        tenants = {
            tenant: {"weight": p.weight, "quota": p.quota}
            for tenant, p in sorted(cfg.tenants.items())
        }
        tenants.setdefault(DEFAULT_TENANT, {
            "weight": cfg.default_weight, "quota": cfg.default_quota,
        })
        out: dict[str, Any] = {
            "policy": {
                "tenants": tenants,
                "spec": (
                    {
                        "burn_threshold": cfg.spec.burn_threshold,
                        "shed_to": cfg.spec.shed_to,
                    }
                    if cfg.spec is not None
                    else None
                ),
                "routing": (
                    {
                        "tail_threshold": cfg.routing.tail_threshold,
                        "deadline_slack_s": cfg.routing.deadline_slack_s,
                    }
                    if cfg.routing is not None
                    else None
                ),
                "autoscale": (
                    {
                        "min_shards": cfg.autoscale.min_shards,
                        "max_shards": cfg.autoscale.max_shards,
                        "up_burn": cfg.autoscale.up_burn,
                        "up_pressure": cfg.autoscale.up_pressure,
                        "down_burn": cfg.autoscale.down_burn,
                        "down_pressure": cfg.autoscale.down_pressure,
                        "sustain_s": cfg.autoscale.sustain_s,
                        "cooldown_s": cfg.autoscale.cooldown_s,
                    }
                    if cfg.autoscale is not None
                    else None
                ),
            },
            "k_capped": self._k_capped,
            "k_shed_events": self.k_shed_events,
            "scale_log": list(self.scale_log),
        }
        if self.tracker is not None:
            out["burn_rate"] = {
                "fast": round(self.tracker.burn_rate("fast"), 4),
                "slow": round(self.tracker.burn_rate("slow"), 4),
            }
            out["tenants"] = self.tracker.tenant_stats()
        return out

    def http_route(self):
        """A route rendering :meth:`snapshot` as JSON: a callable
        returning ``(200, "application/json", body)``; the service serves
        it at ``GET /control`` on the metrics server."""

        def control_route():
            return (
                200,
                "application/json",
                json.dumps(self.snapshot()).encode(),
            )

        return control_route
