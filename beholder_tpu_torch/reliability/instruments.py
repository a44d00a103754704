"""The reliability subsystem's metric catalog (the port's own copy of the
reference's ``reliability/instruments.py``).

Extension surface like the serving/broker instrumentation: nothing is
registered unless a component is handed a registry, so the reference
exposition stays byte-identical by default (the service tests pin
it). Every series uses
:func:`~beholder_tpu_torch.metrics.get_or_create`, so retry policies,
breakers, consumers, and shedders sharing one registry share one set of
series instead of tripping the duplicate guard.

Catalog (all appear only when a reliability component gets a registry):

- ``beholder_retry_attempts_total{op}`` — re-attempts (not first tries)
- ``beholder_retry_give_ups_total{op, reason}`` — retry loops abandoned
  (``attempts`` / ``budget`` / ``deadline``)
- ``beholder_breaker_state{breaker}`` — 0 closed, 1 half-open, 2 open
- ``beholder_breaker_transitions_total{breaker, state}`` — transitions
  INTO each state
- ``beholder_breaker_rejections_total{breaker}`` — fast-failed calls
- ``beholder_dead_lettered_total{queue, reason}`` — messages parked
  (``max-retries`` consumer-side; ``rejected``/``expired`` broker-side)
- ``beholder_dedup_hits_total{topic}`` — redeliveries skipped by the
  idempotency window
"""

from __future__ import annotations

from beholder_tpu_torch.metrics import get_or_create

#: numeric encoding of breaker states for the state gauge
STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class ReliabilityMetrics:
    """One bundle of the catalog above, find-or-registered on a shared
    registry (a :class:`~beholder_tpu_torch.metrics.Registry`, or a
    :class:`~beholder_tpu_torch.metrics.Metrics` whose registry is used)."""

    def __init__(self, registry):
        registry = getattr(registry, "registry", registry)
        self.registry = registry
        self.retry_attempts_total = get_or_create(
            registry, "counter",
            "beholder_retry_attempts_total",
            "Retry re-attempts by operation (first tries not counted)",
            labelnames=["op"],
        )
        self.retry_give_ups_total = get_or_create(
            registry, "counter",
            "beholder_retry_give_ups_total",
            "Retry loops abandoned, by operation and reason "
            "(attempts/budget/deadline)",
            labelnames=["op", "reason"],
        )
        self.breaker_state = get_or_create(
            registry, "gauge",
            "beholder_breaker_state",
            "Circuit breaker state (0 closed, 1 half-open, 2 open)",
            labelnames=["breaker"],
        )
        self.breaker_transitions_total = get_or_create(
            registry, "counter",
            "beholder_breaker_transitions_total",
            "Circuit breaker transitions into each state",
            labelnames=["breaker", "state"],
        )
        self.breaker_rejections_total = get_or_create(
            registry, "counter",
            "beholder_breaker_rejections_total",
            "Calls fast-failed because the breaker was open",
            labelnames=["breaker"],
        )
        self.dead_lettered_total = get_or_create(
            registry, "counter",
            "beholder_dead_lettered_total",
            "Messages parked on a dead-letter queue, by source queue and "
            "reason (max-retries/rejected/expired)",
            labelnames=["queue", "reason"],
        )
        self.dedup_hits_total = get_or_create(
            registry, "counter",
            "beholder_dedup_hits_total",
            "Redeliveries skipped by the idempotency window (already "
            "handled before the broker lost the ack)",
            labelnames=["topic"],
        )
