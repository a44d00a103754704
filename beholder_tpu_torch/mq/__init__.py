"""Message-queue layer (the port's own copy of the reference's ``mq/``).

- :mod:`.base` — ``Broker`` / ``Delivery`` with explicit acks (the
  reference acks even failed progress messages: at-most-once).
- :mod:`.memory` — a deterministic in-memory broker with real prefetch
  accounting, for tests and benchmarks.
- :mod:`.codec`, :mod:`.amqp` — an AMQP 0-9-1 wire client written from
  the specification.
- :mod:`.ingest` — the batched native ingest path (``instance.ingest.*``):
  one native scan per socket poll with zero-copy payload views, whole-batch
  dispatch, and the lazily-registered ``beholder_ingest_*`` catalog.
  Default OFF. :mod:`._native` builds its C++ scanner at first use.
- :mod:`.server` — ``AmqpTestServer``, a wire-compatible mini broker
  (``python -m beholder_tpu_torch.mq.server``).
"""

from .amqp import AmqpBroker
from .base import Broker, Delivery
from .ingest import BatchFeed, IngestConfig, ingest_from_config
from .memory import InMemoryBroker

__all__ = [
    "Broker",
    "Delivery",
    "InMemoryBroker",
    "AmqpBroker",
    "BatchFeed",
    "IngestConfig",
    "ingest_from_config",
]
