"""Reliability subsystem: retries, circuit breakers, dead-letter queues,
and load shedding (the port's own copy of the reference's
``reliability/``).

- :mod:`.policy` — :class:`~.policy.Deadline` and its contextvar scope,
  :class:`~.policy.RetryBudget` and :class:`~.policy.RetryPolicy` (the
  outbound HTTP retries and the cluster's page transfers);
- :mod:`.breaker` — a closed/open/half-open :class:`~.breaker.
  CircuitBreaker` and the :class:`~.breaker.ResilientTransport` that puts
  it, with retries and deadlines, in front of every outbound HTTP client;
- :mod:`.dlq` — consumer-side at-least-once delivery
  (:class:`~.dlq.ReliableConsumer`): bounded redelivery, then parking on
  ``<topic>.dlq``, with an idempotency window so redeliveries stay
  effectively-once;
- :mod:`.shed` — the bounded :class:`~.shed.IntakeQueue` behind
  ``ContinuousBatcher.submit`` / ``run_pending`` and the cluster's
  per-shard intakes;
- :mod:`.chaos` — the deterministic fault-injection harness;
- :mod:`.instruments` — the ``beholder_retry_*`` / ``beholder_breaker_*``
  / ``beholder_dead_lettered_total`` / ``beholder_dedup_hits_total``
  catalog, registered only on request.

The service arms the consumer and transport pieces behind
``instance.reliability.enabled`` (see ``service.py``).
"""

from .breaker import (
    BreakerOpenError,
    CircuitBreaker,
    ResilientTransport,
)
from .chaos import (
    WORKER_HANG,
    WORKER_KILL,
    WORKER_TRANSFER_CORRUPTION,
    FlakyHandler,
    FlakyTransport,
    WorkerFault,
    drop_broker_connections,
    inject_worker_fault,
    trip_allocator,
)
from .dlq import ReliableConsumer, default_dlq_topic
from .instruments import ReliabilityMetrics
from .policy import (
    Deadline,
    DeadlineExceeded,
    RetryBudget,
    RetryPolicy,
    current_deadline,
    deadline_scope,
)
from .shed import (
    SHED_COST_BACKLOG,
    SHED_OVERSIZED,
    SHED_QUEUE_FULL,
    SHED_SHARD_DOWN,
    Admission,
    IntakeQueue,
    LoadShedError,
)

__all__ = [
    "Admission",
    "BreakerOpenError",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
    "FlakyHandler",
    "FlakyTransport",
    "IntakeQueue",
    "LoadShedError",
    "ReliabilityMetrics",
    "ReliableConsumer",
    "ResilientTransport",
    "RetryBudget",
    "RetryPolicy",
    "SHED_COST_BACKLOG",
    "SHED_OVERSIZED",
    "SHED_QUEUE_FULL",
    "SHED_SHARD_DOWN",
    "WORKER_HANG",
    "WORKER_KILL",
    "WORKER_TRANSFER_CORRUPTION",
    "WorkerFault",
    "current_deadline",
    "default_dlq_topic",
    "deadline_scope",
    "drop_broker_connections",
    "inject_worker_fault",
    "trip_allocator",
]
