"""Fault injection: the harness the reliability tests and the card's smoke
script drive (the port's own copy of the reference's
``reliability/chaos.py``).

Chaos here is deterministic and in-process — scripts, not randomness — so
every failure mode the subsystem claims to survive has a check that
injects exactly that failure:

- :class:`FlakyTransport` — scriptable HTTP faults: fail the next N
  requests (exception or 5xx status), add latency, or fail by predicate.
  Wraps any transport; drives the breaker and retry checks.
- :class:`FlakyHandler` — a consumer handler that raises on its first N
  deliveries of each message, then delegates; drives redelivery and
  dead-letter parking.
- :func:`drop_broker_connections` — kills every client connection on an
  :class:`~beholder_tpu_torch.mq.server.AmqpTestServer` mid-flight (the
  reconnect and redelivery leg).
- :func:`trip_allocator` — forces the paged serving state's sticky
  ``alloc_failed`` flag.
- :class:`WorkerFault` + :func:`inject_worker_fault` — the cluster's
  worker faults: ``kill``, ``hang`` and ``transfer_corruption``.

Everything lives behind explicit calls; importing this module injects
nothing.
"""

from __future__ import annotations

import threading
import time

import torch

from beholder_tpu_torch.clients.http import HttpResponse, HttpTransport
from beholder_tpu_torch.log import get_logger


class FlakyTransport(HttpTransport):
    """Deterministic fault-injecting wrapper over any transport."""

    def __init__(self, inner: HttpTransport, logger=None):
        self.inner = inner
        self._lock = threading.Lock()
        self._fail_next = 0
        self._fail_exc: Exception | None = None
        self._fail_status: int | None = None
        self.delay_s = 0.0
        self.fail_predicate = None  # (method, url) -> bool
        self.requests_seen = 0
        self.faults_injected = 0
        self._log = logger or get_logger("reliability.chaos")

    def fail_next(
        self,
        n: int,
        exc: Exception | None = None,
        status: int | None = None,
    ) -> None:
        """Script the next ``n`` requests to fail — with ``exc`` (default
        ``ConnectionError``) or, if ``status`` is given, with a real
        response carrying that status instead of an exception."""
        with self._lock:
            self._fail_next = int(n)
            self._fail_exc = exc
            self._fail_status = status

    def request(self, method, url, *, params=None, json=None, timeout=10.0,
                headers=None):
        if self.delay_s:
            time.sleep(self.delay_s)
        with self._lock:
            self.requests_seen += 1
            inject = self._fail_next > 0
            if inject:
                self._fail_next -= 1
            status = self._fail_status
            exc = self._fail_exc
        if not inject and self.fail_predicate is not None:
            inject = bool(self.fail_predicate(method, url))
        if inject:
            self.faults_injected += 1
            if status is not None:
                return HttpResponse(status=status, body={"chaos": True})
            raise exc if exc is not None else ConnectionError(
                "chaos: injected transport fault"
            )
        # headers forwarded only when set: duck-typed transports
        # predating the headers kwarg keep working headerless
        extra = {"headers": headers} if headers is not None else {}
        return self.inner.request(
            method, url, params=params, json=json, timeout=timeout,
            **extra,
        )


class FlakyHandler:
    """A consumer handler that raises on the first ``fail_times``
    deliveries of EACH distinct body, then delegates to ``inner``.
    Mirrors a handler whose downstream dependency recovers."""

    def __init__(self, inner, fail_times: int, exc: Exception | None = None):
        self.inner = inner
        self.fail_times = int(fail_times)
        self.exc = exc
        self.failures: dict[bytes, int] = {}

    def __call__(self, delivery) -> None:
        seen = self.failures.get(delivery.body, 0)
        if seen < self.fail_times:
            self.failures[delivery.body] = seen + 1
            raise (
                self.exc
                if self.exc is not None
                else RuntimeError("chaos: injected handler fault")
            )
        self.inner(delivery)


def drop_broker_connections(server) -> None:
    """Abort every client connection on an AmqpTestServer — unacked
    deliveries requeue (redelivered=1) and clients must reconnect."""
    server.drop_all_connections()


def trip_allocator(batcher) -> None:
    """Force the paged pool's sticky ``alloc_failed`` flag on a
    :class:`~beholder_tpu_torch.models.serving.ContinuousBatcher`: the next
    checked scheduler call must surface the allocator error instead of
    returning silently wrong results."""
    batcher.state = batcher.state._replace(
        alloc_failed=torch.ones((), dtype=torch.bool, device=batcher.device)
    )


#: cluster worker-fault kinds
WORKER_KILL = "kill"
WORKER_HANG = "hang"
WORKER_TRANSFER_CORRUPTION = "transfer_corruption"


class WorkerFault:
    """A declarative, deterministic cluster worker fault.

    - ``kill``: the worker's dispatch entry point (the decode shard's tick
      chunk, the prefill worker's forward) raises a typed ``WorkerKilled``
      after ``after_dispatches`` successful calls: a death mid-stream;
    - ``hang``: the worker's heartbeats freeze, and the failover monitor's
      next sweep marks it down;
    - ``transfer_corruption``: the next ``transfer_failures`` page
      transfers to the worker fail. Below the retry budget the hop heals;
      at or above it the terminal ``TransferFailed`` drives recovery.
    """

    def __init__(
        self,
        worker: str,
        kind: str = WORKER_KILL,
        after_dispatches: int = 0,
        transfer_failures: int = 3,
    ):
        if kind not in (WORKER_KILL, WORKER_HANG, WORKER_TRANSFER_CORRUPTION):
            raise ValueError(f"unknown worker-fault kind {kind!r}")
        self.worker = worker
        self.kind = kind
        self.after_dispatches = int(after_dispatches)
        self.transfer_failures = int(transfer_failures)


def inject_worker_fault(scheduler, fault: WorkerFault) -> None:
    """Arm ``fault`` on a failover-enabled
    :class:`~beholder_tpu_torch.cluster.router.ClusterScheduler`. Raises
    unless the cluster has failover: without it a faulted cluster just
    dies."""
    engine = getattr(scheduler, "failover", None)
    if engine is None:
        raise RuntimeError(
            "worker faults need a failover-armed cluster — build the "
            "ClusterScheduler with ClusterConfig(failover="
            "FailoverConfig(...))"
        )
    engine.inject_fault(fault)
