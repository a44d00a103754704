"""Broker and delivery interfaces (the port's own copy of the reference's
``mq/base.py``).

Contract notes, all observable in the reference:

- Handlers receive a delivery object and must explicitly ``ack()``
  (index.js:124,151,154). The reference acks in every path, including error
  paths — i.e. at-most-once processing, never requeue on failure.
- Consumers are registered per topic via ``listen(topic, handler)``
  (index.js:62,127). Topics are queue names ("v1.telemetry.status").
- Prefetch bounds the number of unacked deliveries in flight
  (100 in the reference, index.js:43).

Reliability extensions (opt-in; the defaults keep reference semantics):

- ``Delivery.redelivered`` distinguishes first delivery from redelivery
  on every broker (AMQP wire flag, in-memory requeue flag), and
  ``Delivery.delivery_count`` exposes the broker-stamped attempt count
  (``x-delivery-count``) that bounded-retry/DLQ logic needs.
- Brokers may route ``nack(requeue=False)`` rejections and expired
  messages to a per-queue dead-letter queue instead of dropping them
  (see ``InMemoryBroker.set_dead_letter`` /
  ``AmqpTestServer.set_dead_letter`` + ``set_message_ttl``).
"""

from __future__ import annotations

import abc
from typing import Callable

#: A consumer callback. Must call ``delivery.ack()`` (or ``nack``) itself.
Handler = Callable[["Delivery"], None]

#: Broker-stamped count of PRIOR delivery attempts (the RabbitMQ
#: quorum-queue ``x-delivery-count`` contract): absent/0 on first
#: delivery, incremented each time the message is requeued. Retry
#: counting builds on this — ``redelivered`` alone says "not the first
#: attempt" but not WHICH attempt.
DELIVERY_COUNT_HEADER = "x-delivery-count"


class Delivery:
    """One message handed to a consumer."""

    __slots__ = (
        "topic", "body", "delivery_tag", "redelivered", "headers",
        "prepared", "_settle",
    )

    def __init__(
        self,
        topic: str,
        body: bytes,
        delivery_tag: int,
        settle: Callable[[int, bool, bool], None],
        redelivered: bool = False,
        headers: dict | None = None,
    ):
        self.topic = topic
        self.body = body
        self.delivery_tag = delivery_tag
        self.redelivered = redelivered
        #: AMQP basic-properties headers table (trace context rides here)
        self.headers = headers or {}
        #: batched-ingest scratch: a prepare stage registered via
        #: :meth:`Broker.listen_batch` stashes this delivery's
        #: precomputed work (decoded proto, batched-write outcome) here;
        #: None on the per-message path, and handlers must treat an
        #: absent key as "do the work inline" (the fallback is the
        #: per-message loop's exact semantics)
        self.prepared = None
        #: settle(delivery_tag, acked, requeue) — exactly-once per delivery.
        self._settle = settle

    def ack(self) -> None:
        """Acknowledge; the broker may release a prefetch slot."""
        self._settled_once(acked=True, requeue=False)

    def nack(self, requeue: bool = True) -> None:
        """Reject; optionally requeue for redelivery."""
        self._settled_once(acked=False, requeue=requeue)

    def _settled_once(self, acked: bool, requeue: bool) -> None:
        settle, self._settle = self._settle, None
        if settle is None:
            raise RuntimeError(
                f"delivery {self.delivery_tag} on {self.topic!r} already settled"
            )
        settle(self.delivery_tag, acked, requeue)

    @property
    def settled(self) -> bool:
        return self._settle is None

    @property
    def delivery_count(self) -> int:
        """Prior delivery attempts of this message (0 on first delivery).

        Read from the broker-stamped :data:`DELIVERY_COUNT_HEADER`; both
        in-repo brokers stamp it on every requeue, and the
        ``redelivered`` flag remains the cheap boolean view of the same
        fact (``delivery_count > 0`` implies ``redelivered``). Malformed
        values degrade to 0, never raise — headers are peer input."""
        try:
            return max(int(self.headers.get(DELIVERY_COUNT_HEADER, 0)), 0)
        except (TypeError, ValueError):
            return 0


class Broker(abc.ABC):
    """Minimal broker contract used by the service layer."""

    @abc.abstractmethod
    def connect(self) -> None:
        """Establish the connection (index.js:44)."""

    @abc.abstractmethod
    def listen(self, topic: str, handler: Handler) -> None:
        """Subscribe ``handler`` to ``topic`` (index.js:62,127)."""

    @abc.abstractmethod
    def publish(self, topic: str, body: bytes, headers: dict | None = None) -> None:
        """Publish a message (producer side; used by tests/tools/bench).

        ``headers`` ride the AMQP basic-properties headers table — used for
        trace-context propagation, never required by consumers."""

    def publish_many(self, items, headers: dict | None = None) -> None:
        """Publish a list of ``(topic, body)`` pairs in order. Default:
        the per-message loop; brokers with a batched egress (the AMQP
        client's one-loop-hop coalesced write) override it. Semantics
        are identical either way."""
        for topic, body in items:
            self.publish(topic, body, headers)

    def listen_batch(self, topic: str, handler: Handler, prepare) -> None:
        """Subscribe ``handler`` with a batch PREPARE stage.

        When the broker's batched ingest path drains several deliveries
        for ``topic`` in one dispatch round, ``prepare(deliveries)``
        runs ONCE before ``handler`` is invoked per delivery — the hook
        for folding per-message work (one protobuf decode pass, one
        storage transaction). The per-message handler chain still runs
        for every delivery, so settlement/tracing semantics are
        unchanged; a prepare must only stash results on
        ``delivery.prepared``, never settle or raise for one message
        (per-message failures belong in the handler's own scope).

        Default: plain :meth:`listen` — brokers without a batched path
        ignore ``prepare`` and keep per-message semantics exactly."""
        self.listen(topic, handler)

    def declare(self, topic: str) -> None:
        """Ensure ``topic``'s queue exists WITHOUT consuming from it.

        Publishing to a queue nobody has declared is silently unroutable
        on a real AMQP broker (default-exchange publish, mandatory=0) —
        a dead-letter parking lot must therefore be declared up front or
        parked messages would be dropped, not parked. Default: no-op
        (the in-memory broker materializes queues on first publish)."""

    @abc.abstractmethod
    def close(self) -> None:
        """Tear down the connection."""
