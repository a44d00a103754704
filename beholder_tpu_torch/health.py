"""Failure detection and elastic recovery: health probes + a supervisor.

The port's own copy of the reference's ``health.py``, with every check the
reference registers: broker, db, the circuit breaker, the cluster, the SLO
burn and the regression sentinel. The upstream service has neither (SURVEY.md §5: a crash in
init() kills the process and restart is delegated to the container
orchestrator). This module is
the in-process equivalent of that orchestrator plus the liveness/readiness
endpoints it would probe:

- :class:`HealthServer` — ``/healthz`` (liveness: every registered check
  passes → 200, else 503) and ``/readyz`` (readiness: the service finished
  booting), JSON bodies with per-check detail. Kubernetes-style contract.
- :class:`Supervisor` — builds and runs the service via a factory,
  restarts it on crash with exponential backoff + cap, and (optionally)
  recycles it when a liveness check stays false for too long — the
  "restart is delegated to the orchestrator" behavior, in-process.

Both are extensions gated off by default; the default main() path keeps
the reference's crash-and-die semantics.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable

from beholder_tpu_torch.httpd import serve_routes
from beholder_tpu_torch.log import get_logger


def _json(code: int, body: dict) -> tuple[int, str, bytes]:
    return code, "application/json", json.dumps(body).encode()


class HealthServer:
    """Liveness/readiness endpoints over a set of named checks.

    A check is a callable returning a truthy value when healthy; it may
    also return a string/dict detail (recorded in the JSON body). A check
    that raises counts as failing with the exception text as detail.
    """

    def __init__(self, port: int = 0):
        self._checks: dict[str, Callable[[], Any]] = {}
        self._ready = threading.Event()
        self._started_at = time.time()
        self._requested_port = port
        self._server: ThreadingHTTPServer | None = None
        self.port: int | None = None

    def add_check(self, name: str, check: Callable[[], Any]) -> None:
        self._checks[name] = check

    def set_ready(self, ready: bool = True) -> None:
        if ready:
            self._ready.set()
        else:
            self._ready.clear()

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def snapshot(self) -> tuple[bool, dict[str, Any]]:
        """Run every check; (all_healthy, {name: {ok, detail}})."""
        results: dict[str, Any] = {}
        healthy = True
        for name, check in self._checks.items():
            try:
                value = check()
                ok = bool(value)
                detail = value if not isinstance(value, bool) else None
            except Exception as err:  # noqa: BLE001 - a probe must not crash
                ok, detail = False, repr(err)
            healthy &= ok
            entry: dict[str, Any] = {"ok": ok}
            if detail is not None:
                entry["detail"] = detail
            results[name] = entry
        return healthy, results

    # -- http ---------------------------------------------------------------
    def start(self) -> int:
        def healthz():
            healthy, checks = self.snapshot()
            body = {
                "status": "ok" if healthy else "unhealthy",
                "uptime_s": round(time.time() - self._started_at, 1),
                "checks": checks,
            }
            return _json(200 if healthy else 503, body)

        def readyz():
            ready = self.ready
            return _json(
                200 if ready else 503,
                {"status": "ready" if ready else "starting"},
            )

        self._server = serve_routes(
            {"/healthz": healthz, "/readyz": readyz}, self._requested_port
        )
        self.port = self._server.server_address[1]
        return self.port

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class Supervisor:
    """Crash-restart loop with exponential backoff; the in-process stand-in
    for the container orchestrator the reference relies on.

    ``factory`` builds and starts a service and returns an object with a
    best-effort teardown (``close()``/``stop()``, both optional). A factory
    that raises counts as a crash. ``liveness`` (optional) is polled every
    ``probe_interval_s``; when it stays false for ``liveness_grace_s`` the
    service is recycled (torn down + backoff + rebuilt) — this catches hangs
    that never raise, e.g. a broker that will never come back.
    """

    def __init__(
        self,
        factory: Callable[[], Any],
        liveness: Callable[[Any], bool] | None = None,
        backoff_s: float = 0.5,
        backoff_max_s: float = 30.0,
        max_restarts: int | None = None,
        probe_interval_s: float = 1.0,
        liveness_grace_s: float = 10.0,
        logger=None,
    ):
        self.factory = factory
        self.liveness = liveness
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.max_restarts = max_restarts
        self.probe_interval_s = probe_interval_s
        self.liveness_grace_s = liveness_grace_s
        self.restarts = 0
        self.service: Any = None
        self._log = logger or get_logger("supervisor")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Run the supervision loop on a background thread."""
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._teardown()

    def run(self) -> None:
        """The supervision loop (blocking form)."""
        backoff = self.backoff_s
        while not self._stop.is_set():
            try:
                service = self.factory()
            except Exception as err:  # noqa: BLE001 - crash -> backoff -> retry
                self._log.warning(
                    f"service start failed: {err!r}; restarting in {backoff:.1f}s"
                )
                if not self._bump_and_wait(backoff):
                    return
                backoff = min(backoff * 2, self.backoff_max_s)
                continue
            self.service = service
            if self._stop.is_set():
                # stop() may have timed out waiting for a slow factory and
                # already returned; this late-built service must not leak
                self._teardown()
                return

            backoff = self.backoff_s  # healthy start resets the backoff
            unhealthy_since: float | None = None
            while not self._stop.is_set():
                self._stop.wait(self.probe_interval_s)
                if self._stop.is_set():
                    return
                if self.liveness is None:
                    continue
                try:
                    alive = bool(self.liveness(self.service))
                except Exception:  # noqa: BLE001 - a broken probe = not alive
                    alive = False
                if alive:
                    unhealthy_since = None
                    continue
                now = time.monotonic()
                unhealthy_since = unhealthy_since or now
                if now - unhealthy_since >= self.liveness_grace_s:
                    self._log.warning(
                        f"liveness failed for {self.liveness_grace_s}s; "
                        f"recycling service (backoff {backoff:.1f}s)"
                    )
                    self._teardown()
                    if not self._bump_and_wait(backoff):
                        return
                    backoff = min(backoff * 2, self.backoff_max_s)
                    break  # rebuild via the outer loop

    # -- internals ----------------------------------------------------------
    def _bump_and_wait(self, backoff: float) -> bool:
        self.restarts += 1
        if self.max_restarts is not None and self.restarts > self.max_restarts:
            self._log.warning(
                f"giving up after {self.max_restarts} restarts"
            )
            return False
        self._stop.wait(backoff)
        return not self._stop.is_set()

    def _teardown(self) -> None:
        service, self.service = self.service, None
        if service is None:
            return
        for name in ("close", "stop", "shutdown"):
            fn = getattr(service, name, None)
            if callable(fn):
                try:
                    fn()
                except Exception:  # noqa: BLE001 - best effort on the way down
                    pass
                return


def health_from_config(config, service) -> HealthServer | None:
    """Build the service's health endpoint from ``instance.health.*``
    config (``enabled``, ``port``), or None when disabled (the default).

    Registered checks: ``broker`` (connection liveness), ``db`` (a
    probe read), ``breaker`` when the reliability subsystem is on (an
    OPEN outbound-HTTP circuit breaker means a dependency is sick and
    calls are being fast-failed: the probe reports degraded, while
    half-open probes recover it without a restart), ``slo`` when the SLO
    tracker is armed, ``sentinel`` when the regression sentinel is (an open
    verdict degrades the probe), and — when ``instance.cluster`` is on — ``cluster``
    (per-worker
    up/down/draining + pool pressure; a DOWN decode shard or prefill
    worker degrades the probe, while draining workers report as detail —
    planned decommission is not sickness). ``/readyz`` flips once the
    consumers are registered.
    """
    if not config.get("instance.health.enabled"):
        return None
    server = HealthServer(port=int(config.get("instance.health.port", 0)))
    broker = service.broker
    server.add_check(
        "broker", lambda: getattr(broker, "connected", True)
    )

    def db_check():
        from beholder_tpu_torch.storage.base import MediaNotFound

        try:
            service.db.get_by_id("__health_probe__")
        except MediaNotFound:
            pass  # the query ran; a missing row is a healthy answer
        return True

    server.add_check("db", db_check)

    if getattr(service, "breaker", None) is not None:
        circuit = service.breaker

        def breaker_check():
            state = circuit.state
            if state == "open":
                raise RuntimeError(
                    f"circuit breaker {circuit.name!r} is open "
                    f"(failure rate {circuit.failure_rate():.0%})"
                )
            return state  # "closed"/"half_open" as the check detail

        server.add_check("breaker", breaker_check)

    if getattr(service, "cluster", None) is not None:
        # the scheduler is embedder-owned and usually attached AFTER
        # boot (service.cluster_scheduler starts None), so the check
        # resolves it at PROBE time — registration is one-shot, the
        # lookup is not
        add_cluster_check(
            server, lambda: getattr(service, "cluster_scheduler", None)
        )

    if getattr(service, "slo", None) is not None:
        # SLO-aware degradation: a fast-window burn rate past its
        # threshold means the fleet is spending error budget faster
        # than the page-now alert tolerates — /healthz says so
        add_slo_check(server, lambda: getattr(service, "slo", None))

    if getattr(service, "sentinel", None) is not None:
        # an open sentinel verdict (a phase@worker regressed fast against
        # baseline, hysteresis applied) degrades /healthz beside the burn
        add_sentinel_check(server, lambda: getattr(service, "sentinel", None))

    server.start()
    server.set_ready(True)
    return server


def add_cluster_check(server: HealthServer, scheduler) -> None:
    """Register the ``cluster`` health check for a
    :class:`~beholder_tpu_torch.cluster.router.ClusterScheduler` (or a
    zero-arg callable resolving to one at probe time — None means
    "configured but not attached yet", a healthy answer): the check
    fails (degrading ``/healthz`` to 503) while ANY worker is down, and
    otherwise returns the
    per-worker snapshot (state + pool pressure, draining shards
    included) as detail."""

    def cluster_check():
        target = scheduler() if callable(scheduler) else scheduler
        if target is None:
            return "cluster configured; no scheduler attached"
        snapshot = target.health_snapshot()
        if snapshot["down"]:
            raise RuntimeError(
                "cluster worker(s) down: "
                + ", ".join(snapshot["down"])
            )
        return snapshot

    server.add_check("cluster", cluster_check)


def add_slo_check(server: HealthServer, tracker) -> None:
    """Register the ``slo`` health check for a
    :class:`~beholder_tpu_torch.obs.slo.SLOTracker` (or a zero-arg callable
    resolving to one at probe time — None means "configured but not
    attached yet", a healthy answer): the check fails (degrading
    ``/healthz`` to 503) while the FAST-window error-budget burn rate
    exceeds its threshold — the multi-window pattern's page-now
    signal — and otherwise returns the burn/attainment detail."""

    def slo_check():
        target = tracker() if callable(tracker) else tracker
        if target is None:
            return "slo configured; no tracker attached"
        healthy, detail = target.health()
        if not healthy:
            raise RuntimeError(detail)
        return detail

    server.add_check("slo", slo_check)


def add_sentinel_check(server: HealthServer, sentinel) -> None:
    """Register the ``sentinel`` health check for a
    :class:`~beholder_tpu_torch.obs.sentinel.Sentinel` (or a zero-arg
    callable resolving to one at probe time; None means "configured but not
    attached yet", a healthy answer): the check fails (degrading
    ``/healthz`` to 503) while a regression verdict is open, and otherwise
    returns the check and breach counters as detail."""

    def sentinel_check():
        target = sentinel() if callable(sentinel) else sentinel
        if target is None:
            return "sentinel configured; not attached"
        healthy, detail = target.health()
        if not healthy:
            raise RuntimeError(detail)
        return detail

    server.add_check("sentinel", sentinel_check)
