"""Reliability pieces the serving layer uses.

The port's own copies of the reference's jax-free ``reliability/``
modules, trimmed to what the batcher needs:

- :mod:`.policy` — :class:`~.policy.Deadline` and its contextvar scope,
  :class:`~.policy.RetryBudget` and :class:`~.policy.RetryPolicy` (the
  cluster's page transfers retry through one);
- :mod:`.shed` — the bounded :class:`~.shed.IntakeQueue` behind
  ``ContinuousBatcher.submit`` / ``run_pending`` and the cluster's
  per-shard intakes;
- :mod:`.chaos` — :func:`~.chaos.trip_allocator` and the cluster's
  :class:`~.chaos.WorkerFault` / :func:`~.chaos.inject_worker_fault`.

Not ported: the circuit breaker, the dead-letter consumer, the rest of
the chaos harness and the reliability metric catalog.
"""

from .chaos import (
    WORKER_HANG,
    WORKER_KILL,
    WORKER_TRANSFER_CORRUPTION,
    WorkerFault,
    inject_worker_fault,
    trip_allocator,
)
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
    "Deadline",
    "DeadlineExceeded",
    "IntakeQueue",
    "LoadShedError",
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
    "deadline_scope",
    "inject_worker_fault",
    "trip_allocator",
]
