"""Consumer-side at-least-once delivery with a dead-letter parking lot (the
port's own copy of the reference's ``reliability/dlq.py``).

The reference acks even when a handler throws (at-most-once: a transient
DB/Trello outage silently loses the message). :class:`ReliableConsumer`
upgrades a handler to at-least-once-with-a-floor:

- handler succeeds -> normal path (the handler acks, as in the
  reference); the message fingerprint enters the idempotency window.
- handler raises with attempts remaining -> ``nack(requeue=True)``: the
  broker redelivers (flagged ``redelivered``) and the side effects get
  another try.
- handler raises at the attempt cap -> the message is PARKED: published
  to the dead-letter topic (``<topic>.dlq`` by default) with
  ``x-beholder-death`` provenance headers, then acked — poison messages
  stop poisoning the queue but are never silently dropped.
- a REDELIVERY of a message the window has already seen succeed ->
  acked without re-running the handler (``dedup_hits_total``). This is
  what keeps redeliveries effectively-once: a broker connection drop
  between the handler's side effects and the ack's arrival must not
  re-run the side effects. Dedup fires ONLY for deliveries flagged
  ``redelivered`` — two legitimately identical fresh publishes both run.

Attempt counting prefers the broker-stamped ``x-delivery-count`` header
(the quorum-queue contract; both in-repo brokers stamp it on requeue)
and falls back to a bounded local map keyed by message fingerprint for
brokers that do not.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict

from beholder_tpu_torch.log import get_logger
from beholder_tpu_torch.mq.base import Broker, Delivery, Handler

#: provenance headers stamped onto parked messages
DEATH_QUEUE_HEADER = "x-beholder-death-queue"
DEATH_REASON_HEADER = "x-beholder-death-reason"
DEATH_ATTEMPTS_HEADER = "x-beholder-death-attempts"
DEATH_TIME_HEADER = "x-beholder-death-unix-s"


def default_dlq_topic(topic: str) -> str:
    return f"{topic}.dlq"


def fingerprint(topic: str, body: bytes) -> bytes:
    """Stable identity of one message for attempt counting + dedup."""
    digest = hashlib.blake2b(body, digest_size=16)
    digest.update(topic.encode())
    return digest.digest()


class _LruSet:
    """Bounded insertion-ordered map (used as set and as counter map)."""

    def __init__(self, maxlen: int):
        self.maxlen = int(maxlen)
        self._data: OrderedDict = OrderedDict()

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key, default=0):
        return self._data.get(key, default)

    def put(self, key, value=True) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.maxlen:
            self._data.popitem(last=False)

    def pop(self, key) -> None:
        self._data.pop(key, None)


class ReliableConsumer:
    """Wrap ``handler`` for ``topic`` with bounded-retry-then-park.

    Register the WRAPPER with the broker (outermost, so it sees the
    handler's exceptions after tracing/timing wrappers ran). The wrapped
    handler keeps its own ack discipline on success; this wrapper only
    settles deliveries the handler left unsettled on failure.

    ``max_attempts`` counts deliveries of one message, first included.
    """

    def __init__(
        self,
        broker: Broker,
        topic: str,
        handler: Handler,
        max_attempts: int = 3,
        dlq_topic: str | None = None,
        dedup_window: int = 4096,
        metrics=None,
        logger=None,
        clock=time.time,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.broker = broker
        self.topic = topic
        self.handler = handler
        self.max_attempts = int(max_attempts)
        self.dlq_topic = dlq_topic or default_dlq_topic(topic)
        self._metrics = metrics
        self._log = logger or get_logger("reliability.consumer")
        self._clock = clock
        self._lock = threading.Lock()
        self._done = _LruSet(dedup_window)
        self._attempts = _LruSet(dedup_window)
        #: observability for tests/ops: messages parked by this consumer
        self.parked = 0
        # the parking lot must EXIST before the first park: publishing to
        # an undeclared queue is silently unroutable on a real AMQP
        # broker (and nobody listen()s on a DLQ, so nothing else
        # declares it) — an unroutable park followed by the ack would
        # LOSE the message, the one thing this wrapper exists to prevent
        self.broker.declare(self.dlq_topic)

    # -- internals -----------------------------------------------------------
    def _attempt_number(self, fp: bytes, delivery: Delivery) -> int:
        """This delivery's 1-based attempt number: broker-stamped
        delivery count when present, else the local fallback map."""
        with self._lock:
            local = self._attempts.get(fp, 0)
        return 1 + max(delivery.delivery_count, local)

    def _park(self, delivery: Delivery, attempts: int, err: Exception) -> None:
        headers = dict(delivery.headers)
        headers.update(
            {
                DEATH_QUEUE_HEADER: self.topic,
                DEATH_REASON_HEADER: "max-retries",
                DEATH_ATTEMPTS_HEADER: attempts,
                DEATH_TIME_HEADER: int(self._clock()),
            }
        )
        self.broker.publish(self.dlq_topic, delivery.body, headers=headers)
        delivery.ack()
        self.parked += 1
        if self._metrics is not None:
            self._metrics.dead_lettered_total.inc(
                queue=self.topic, reason="max-retries"
            )
        self._log.warning(
            f"parked message from {self.topic!r} on {self.dlq_topic!r} "
            f"after {attempts} attempts: {err!r}"
        )

    # -- the wrapper ---------------------------------------------------------
    def __call__(self, delivery: Delivery) -> None:
        fp = fingerprint(delivery.topic, delivery.body)
        if delivery.redelivered:
            with self._lock:
                done = fp in self._done
            if done:
                # the handler already finished this message once; only
                # the ack was lost. Re-running side effects would double
                # Trello comments / Telegram posts.
                delivery.ack()
                if self._metrics is not None:
                    self._metrics.dedup_hits_total.inc(topic=self.topic)
                return
        try:
            self.handler(delivery)
        except Exception as err:  # noqa: BLE001 - every failure is counted
            attempts = self._attempt_number(fp, delivery)
            with self._lock:
                self._attempts.put(fp, attempts)
            if delivery.settled:
                # the handler settled before failing; nothing to decide
                raise
            if attempts >= self.max_attempts:
                self._park(delivery, attempts, err)
                with self._lock:
                    self._attempts.pop(fp)
            else:
                if self._metrics is not None:
                    self._metrics.retry_attempts_total.inc(
                        op=f"consume.{self.topic}"
                    )
                delivery.nack(requeue=True)
            raise
        else:
            with self._lock:
                self._done.put(fp)
                self._attempts.pop(fp)
