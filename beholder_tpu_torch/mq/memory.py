"""Deterministic in-memory broker for tests and benchmarks (the port's own
copy of the reference's ``mq/memory.py``).

Implements the same observable semantics as the AMQP path: per-topic FIFO
queues, a prefetch window bounding unacked deliveries, and
requeue-on-nack redelivery (flagged ``redelivered``, with the
``x-delivery-count`` attempt header stamped on each requeue). Delivery is
synchronous and single-threaded, which makes ack-semantics tests exact.

Dead-letter routing (``set_dead_letter``): a ``nack(requeue=False)`` on
a routed topic republishes the message to its dead-letter topic (with
``x-beholder-death-*`` provenance headers) instead of dropping it —
the in-memory twin of RabbitMQ's ``x-dead-letter-exchange``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from beholder_tpu_torch.log import get_logger

from .base import DELIVERY_COUNT_HEADER, Broker, Delivery, Handler


@dataclass
class _Topic:
    handler: Handler | None = None
    pending: deque = field(default_factory=deque)  # (body, redelivered, headers)


class InMemoryBroker(Broker):
    def __init__(self, prefetch: int = 100):
        self.prefetch = prefetch
        self._topics: dict[str, _Topic] = {}
        #: (topic, entry) pairs that have a handler — the only topics
        #: _dispatch can make progress on; kept separate so the hot loop
        #: never scans consumer-less topics
        self._consumers: list[tuple[str, _Topic]] = []
        self._unacked: dict[int, tuple[str, bytes, dict | None]] = {}
        self._pending_total = 0  # messages across all topic queues
        self._next_tag = 1
        self._connected = False
        self._dispatching = False
        self._dead_letter: dict[str, str] = {}  # topic -> DLQ topic
        #: (topic, reason) -> count; introspection for tests/metrics
        self.dead_lettered: dict[tuple[str, str], int] = {}
        self._log = get_logger("mq.memory")

    @property
    def connected(self) -> bool:
        return self._connected

    # -- Broker ------------------------------------------------------------
    def connect(self) -> None:
        self._connected = True

    def close(self) -> None:
        self._connected = False

    def listen(self, topic: str, handler: Handler) -> None:
        entry = self._topics.setdefault(topic, _Topic())
        if entry.handler is not None:
            raise ValueError(f"topic {topic!r} already has a consumer")
        entry.handler = handler
        self._consumers.append((topic, entry))
        self._dispatch()

    def publish(self, topic: str, body: bytes, headers: dict | None = None) -> None:
        self._topics.setdefault(topic, _Topic()).pending.append(
            (bytes(body), False, headers)
        )
        self._pending_total += 1
        if self._connected:
            self._dispatch()

    def set_dead_letter(self, topic: str, dlq_topic: str) -> None:
        """Route ``nack(requeue=False)`` rejections on ``topic`` to
        ``dlq_topic`` instead of dropping them."""
        if dlq_topic == topic:
            raise ValueError(f"dead-letter loop: {topic!r} -> itself")
        self._dead_letter[topic] = dlq_topic

    # -- introspection for tests -------------------------------------------
    @property
    def in_flight(self) -> int:
        """Unacked deliveries currently held by consumers."""
        return len(self._unacked)

    def queue_depth(self, topic: str) -> int:
        entry = self._topics.get(topic)
        return len(entry.pending) if entry else 0

    # -- internals ---------------------------------------------------------
    def _dispatch(self) -> None:
        """Deliver while prefetch slots and consumable messages remain."""
        if self._dispatching or not self._connected:
            return  # ack() inside a handler re-enters; the outer loop continues
        self._dispatching = True
        unacked = self._unacked
        prefetch = self.prefetch
        try:
            progressed = True
            # _pending_total short-circuits the common publish->consume->ack
            # cycle to ONE consumer scan (no empty second pass)
            while progressed and self._pending_total and len(unacked) < prefetch:
                progressed = False
                # snapshot: a handler may listen() on a brand-new topic,
                # mutating self._consumers mid-iteration
                for topic, entry in tuple(self._consumers):
                    if len(unacked) >= prefetch:
                        break
                    if not entry.pending:
                        continue
                    body, redelivered, headers = entry.pending.popleft()
                    self._pending_total -= 1
                    tag = self._next_tag
                    self._next_tag += 1
                    unacked[tag] = (topic, body, headers)
                    delivery = Delivery(
                        topic,
                        body,
                        tag,
                        self._settle,
                        redelivered=redelivered,
                        headers=headers,
                    )
                    progressed = True
                    try:
                        entry.handler(delivery)
                    except Exception as err:  # noqa: BLE001
                        # a throwing handler leaves its delivery unacked —
                        # same outcome as an unhandled rejection in the
                        # reference's consumer callbacks (SURVEY.md §3b).
                        # (A reliability wrapper may have settled before
                        # re-raising; then there is nothing left in flight.)
                        state = (
                            "already settled" if delivery.settled
                            else f"delivery {tag} left unacked"
                        )
                        self._log.warning(
                            f"handler for {topic!r} raised: {err!r}; {state}"
                        )
        finally:
            self._dispatching = False

    def _settle(self, tag: int, acked: bool, requeue: bool) -> None:
        topic, body, headers = self._unacked.pop(tag)
        if not acked and requeue:
            # stamp the attempt count for the next delivery (quorum-queue
            # x-delivery-count contract); COPY the headers — the dict is
            # shared with the delivery the consumer may still hold
            headers = dict(headers or {})
            headers[DELIVERY_COUNT_HEADER] = (
                int(headers.get(DELIVERY_COUNT_HEADER, 0) or 0) + 1
            )
            self._topics[topic].pending.appendleft((body, True, headers))
            self._pending_total += 1
        elif not acked:
            dlq = self._dead_letter.get(topic)
            if dlq is not None:
                key = (topic, "rejected")
                self.dead_lettered[key] = self.dead_lettered.get(key, 0) + 1
                headers = dict(headers or {})
                headers.setdefault("x-beholder-death-queue", topic)
                headers.setdefault("x-beholder-death-reason", "rejected")
                headers.setdefault("x-beholder-death-unix-s", int(time.time()))
                self.publish(dlq, body, headers=headers)
        # a freed prefetch slot (or a requeue) may unblock pending work;
        # re-entrant calls return immediately and the outer loop continues
        self._dispatch()
