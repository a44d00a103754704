"""Message-queue layer (the port's own copy of the reference's ``mq/``).

- :mod:`.base` — ``Broker`` / ``Delivery`` with explicit acks (the
  reference acks even failed progress messages: at-most-once).
- :mod:`.memory` — a deterministic in-memory broker with real prefetch
  accounting, for tests and benchmarks.
- :mod:`.codec`, :mod:`.amqp` — an AMQP 0-9-1 wire client written from
  the specification (per-message path).
- :mod:`.server` — ``AmqpTestServer``, a wire-compatible mini broker
  (``python -m beholder_tpu_torch.mq.server``).

Not ported: the batched native ingest path (``instance.ingest.*``).
"""

from .amqp import AmqpBroker
from .base import Broker, Delivery
from .memory import InMemoryBroker

__all__ = ["Broker", "Delivery", "InMemoryBroker", "AmqpBroker"]
