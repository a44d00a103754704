"""Reliability pieces the serving layer uses.

The port's own copies of the reference's jax-free ``reliability/``
modules, trimmed to what the batcher needs:

- :mod:`.policy` — :class:`~.policy.Deadline` and its contextvar scope;
- :mod:`.shed` — the bounded :class:`~.shed.IntakeQueue` behind
  ``ContinuousBatcher.submit`` / ``run_pending``;
- :mod:`.chaos` — :func:`~.chaos.trip_allocator`.

Not ported: ``RetryBudget`` and ``RetryPolicy`` (they serve the HTTP
transport), the circuit breaker, the dead-letter consumer, the rest of
the chaos harness and the reliability metric catalog.
"""

from .chaos import trip_allocator
from .policy import Deadline, DeadlineExceeded, current_deadline, deadline_scope
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
    "SHED_COST_BACKLOG",
    "SHED_OVERSIZED",
    "SHED_QUEUE_FULL",
    "SHED_SHARD_DOWN",
    "current_deadline",
    "deadline_scope",
    "trip_allocator",
]
