"""A minimal in-process AMQP 0-9-1 broker server (the port's own copy of
the reference's ``mq/server.py``).

Speaks the same wire protocol as RabbitMQ for the subset the beholder path
uses (PLAIN auth, channel 1, queue.declare, basic.qos/consume/publish/
deliver/ack/nack, heartbeats). Exists so the from-scratch client in
:mod:`beholder_tpu_torch.mq.amqp` can be tested end-to-end over a real TCP socket
— handshake bytes, frame splitting, prefetch windows, redelivery on
connection drop — without a RabbitMQ install. Also usable as a tiny dev
broker (``python -m beholder_tpu_torch.mq.server``).

Semantics implemented (matching RabbitMQ's observable behavior):
- per-queue FIFO with round-robin across consumers,
- per-connection prefetch window (basic.qos),
- unacked messages requeued (redelivered=1) when a connection drops,
  with the quorum-queue ``x-delivery-count`` header stamped per requeue,
- basic.nack with requeue,
- per-queue dead-letter routing (``set_dead_letter``): rejected
  (``nack(requeue=False)``) and expired messages are republished to the
  queue's DLQ with ``x-beholder-death-*`` provenance headers — the
  in-process stand-in for ``x-dead-letter-exchange``,
- per-queue message TTL (``set_message_ttl``): head-of-queue expiry on
  every pump, RabbitMQ's per-queue ``x-message-ttl`` behavior — the
  knob that makes expiry->dead-letter paths testable in-process.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque

from beholder_tpu_torch.log import get_logger

from . import codec
from .base import DELIVERY_COUNT_HEADER

#: (class, method) -> spec name, for the per-method frame counter labels
_METHOD_NAMES = {
    codec.CONNECTION_START_OK: "connection.start-ok",
    codec.CONNECTION_TUNE_OK: "connection.tune-ok",
    codec.CONNECTION_OPEN: "connection.open",
    codec.CONNECTION_CLOSE: "connection.close",
    codec.CONNECTION_CLOSE_OK: "connection.close-ok",
    codec.CHANNEL_OPEN: "channel.open",
    codec.BASIC_QOS: "basic.qos",
    codec.QUEUE_DECLARE: "queue.declare",
    codec.BASIC_CONSUME: "basic.consume",
    codec.BASIC_PUBLISH: "basic.publish",
    codec.BASIC_ACK: "basic.ack",
    codec.BASIC_NACK: "basic.nack",
}


class _BrokerMetrics:
    """Prometheus instrumentation for the broker (extension surface:
    registered only when a registry is handed to
    :class:`AmqpTestServer`, so the reference exposition stays
    byte-identical). Per-method frame counters show the wire traffic
    mix; per-queue depth gauges show backlog building behind slow
    consumers."""

    def __init__(self, registry):
        from beholder_tpu_torch.metrics import get_or_create

        self.frames_total = get_or_create(
            registry, "counter",
            "beholder_mq_frames_total",
            "AMQP method frames handled by the broker, by method",
            labelnames=["method"],
        )
        self.queue_depth = get_or_create(
            registry, "gauge",
            "beholder_mq_queue_depth",
            "Messages waiting in a broker queue (excludes unacked "
            "in-flight deliveries)",
            labelnames=["queue"],
        )
        # shares the reliability catalog's name: broker-side routing and
        # consumer-side parking land on one series
        self.dead_lettered_total = get_or_create(
            registry, "counter",
            "beholder_dead_lettered_total",
            "Messages parked on a dead-letter queue, by source queue and "
            "reason (max-retries/rejected/expired)",
            labelnames=["queue", "reason"],
        )
        self._bound: dict = {}  # method cm -> bound counter child

    def count_method(self, cm) -> None:
        bound = self._bound.get(cm)
        if bound is None:
            name = _METHOD_NAMES.get(cm, f"unknown.{cm[0]}-{cm[1]}")
            bound = self._bound[cm] = self.frames_total.labels(method=name)
        bound.inc()

    def set_depths(self, queues: dict[str, deque]) -> None:
        for queue, pending in queues.items():
            self.queue_depth.set(len(pending), queue=queue)


class _Conn(asyncio.Protocol):
    def __init__(self, server: "AmqpTestServer"):
        self.server = server
        self.parser = codec.FrameParser()
        self.transport: asyncio.Transport | None = None
        self.saw_header = False
        self.prefetch = 0  # 0 = unlimited
        #: tag -> (queue, body, headers, enqueued_at); the ORIGINAL
        #: enqueue time rides along so a requeue keeps the message's age
        #: (RabbitMQ measures per-queue TTL from publish, not redelivery
        #: — a freshly-stamped requeue at the head would also hide older
        #: expired messages from the head-of-queue expiry scan)
        self.unacked: dict[int, tuple[str, bytes, dict, float]] = {}
        self.consumes: dict[str, str] = {}  # queue -> consumer tag
        self.next_tag = 1
        # in-flight publish: [routing_key, expected_size, chunks, headers]
        self._pending: list | None = None
        #: pump-once-per-recv: frame handlers that used to pump per ack/
        #: publish set this instead, and data_received pumps ONCE after
        #: the whole poll — a 50-publish poll schedules one delivery
        #: sweep, not 50 (the per-message pump was the broker-side hot
        #: loop's syscall amplifier)
        self._pump_soon = False
        self._hb_task: asyncio.Task | None = None
        self._log = server._log

    # -- asyncio.Protocol ---------------------------------------------------
    def connection_made(self, transport):
        self.transport = transport
        self.server.conns.add(self)

    def connection_lost(self, exc):
        if self._hb_task is not None:
            self._hb_task.cancel()
        self.server.conns.discard(self)
        # requeue unacked at the front, flagged redelivered (RabbitMQ
        # behavior), attempt count stamped (quorum-queue x-delivery-count)
        for _tag, (queue, body, headers, enq) in sorted(
            self.unacked.items(), reverse=True
        ):
            self.server.queues.setdefault(queue, deque()).appendleft(
                (body, True, _bump_delivery_count(headers), enq)
            )
        self.unacked.clear()
        for queue in self.consumes:
            consumers = self.server.consumers.get(queue)
            if consumers and self in consumers:
                consumers.remove(self)
        self.server.pump()

    def data_received(self, data):
        if not self.saw_header:
            if len(data) < 8:
                return  # pathological split; fine for a test server
            header, data = data[:8], data[8:]
            if header != codec.PROTOCOL_HEADER:
                self.transport.close()
                return
            self.saw_header = True
            self._send_start()
        for frame in self.parser.feed(data):
            self._on_frame(frame)
        if self._pump_soon:
            self._pump_soon = False
            # batch across CONNECTIONS: defer to
            # one loop-scheduled sweep instead of pumping inline — when
            # several connections' polls land in the same event-loop
            # iteration (4 producers publishing under load), their
            # queue mutations coalesce into ONE delivery sweep and one
            # socket write per consumer, not one sweep per producer.
            # The wire bytes are identical (same frames, same per-queue
            # FIFO, same round-robin) — only the sweep count drops.
            self.server.schedule_pump()

    # -- helpers ------------------------------------------------------------
    def _send(self, frame: codec.Frame) -> None:
        if self.transport and not self.transport.is_closing():
            self.transport.write(frame.serialize())

    def _send_method(self, channel, cm, args: bytes = b"") -> None:
        self._send(codec.method_frame(channel, cm, args))

    def _send_start(self) -> None:
        args = (
            codec.Writer()
            .octet(0)
            .octet(9)
            .table({"product": "beholder-tpu-testbroker"})
            .longstr(b"PLAIN")
            .longstr(b"en_US")
            .getvalue()
        )
        self._send_method(0, codec.CONNECTION_START, args)

    # -- frame handling -----------------------------------------------------
    def _on_frame(self, frame: codec.Frame) -> None:
        if frame.type == codec.FRAME_HEARTBEAT:
            return
        if frame.type == codec.FRAME_METHOD:
            self._on_method(frame)
        elif frame.type == codec.FRAME_HEADER and self._pending is not None:
            size, headers = codec.parse_basic_header(frame.payload)
            self._pending[1] = size
            self._pending[3] = headers
            self._maybe_complete_publish()
        elif frame.type == codec.FRAME_BODY and self._pending is not None:
            self._pending[2].append(frame.payload)
            self._maybe_complete_publish()

    def _on_method(self, frame: codec.Frame) -> None:
        cm, reader = codec.parse_method(frame)
        if self.server._metrics is not None:
            self.server._metrics.count_method(cm)
        if cm == codec.CONNECTION_START_OK:
            reader.table()  # client properties
            mechanism = reader.shortstr()
            response = reader.longstr()
            if mechanism != "PLAIN":
                self.transport.close()
                return
            parts = response.split(b"\x00")
            user = parts[1].decode() if len(parts) > 1 else ""
            password = parts[2].decode() if len(parts) > 2 else ""
            if (self.server.user, self.server.password) != (user, password):
                self._log.warning(f"auth failed for user {user!r}")
                # connection.close 403 access-refused, as RabbitMQ does
                args = (
                    codec.Writer()
                    .short(403)
                    .shortstr("ACCESS_REFUSED")
                    .short(0)
                    .short(0)
                    .getvalue()
                )
                self._send_method(0, codec.CONNECTION_CLOSE, args)
                return
            tune = (
                codec.Writer()
                .short(2047)
                .long(codec_frame_max())
                .short(self.server.heartbeat)
                .getvalue()
            )
            self._send_method(0, codec.CONNECTION_TUNE, tune)
        elif cm == codec.CONNECTION_TUNE_OK:
            pass
        elif cm == codec.CONNECTION_OPEN:
            self._send_method(0, codec.CONNECTION_OPEN_OK, codec.Writer().shortstr("").getvalue())
            if self.server.send_heartbeats and self.server.heartbeat:
                self._hb_task = asyncio.get_event_loop().create_task(
                    self._heartbeats()
                )
        elif cm == codec.CONNECTION_CLOSE_OK:
            self.transport.close()
        elif cm == codec.CHANNEL_OPEN:
            self._send_method(frame.channel, codec.CHANNEL_OPEN_OK, codec.Writer().longstr(b"").getvalue())
        elif cm == codec.BASIC_QOS:
            reader.long()  # prefetch size
            self.prefetch = reader.short()
            self._send_method(frame.channel, codec.BASIC_QOS_OK)
        elif cm == codec.QUEUE_DECLARE:
            reader.short()
            queue = reader.shortstr()
            self.server.queues.setdefault(queue, deque())
            args = (
                codec.Writer()
                .shortstr(queue)
                .long(len(self.server.queues[queue]))
                .long(len(self.server.consumers.get(queue, [])))
                .getvalue()
            )
            self._send_method(frame.channel, codec.QUEUE_DECLARE_OK, args)
        elif cm == codec.BASIC_CONSUME:
            reader.short()
            queue = reader.shortstr()
            tag = reader.shortstr() or f"ctag-{id(self)}"
            self.consumes[queue] = tag
            self.server.consumers.setdefault(queue, []).append(self)
            self._send_method(
                frame.channel, codec.BASIC_CONSUME_OK, codec.Writer().shortstr(tag).getvalue()
            )
            self._pump_soon = True
        elif cm == codec.BASIC_PUBLISH:
            reader.short()
            reader.shortstr()  # exchange ("" = default)
            routing_key = reader.shortstr()
            self._pending = [routing_key, None, [], {}]
        elif cm == codec.BASIC_ACK:
            tag = reader.longlong()
            multiple = bool(reader.octet() & 1)
            tags = (
                [t for t in self.unacked if t <= tag] if multiple else [tag]
            )
            for t in tags:
                self.unacked.pop(t, None)
            self._pump_soon = True
        elif cm == codec.BASIC_NACK:
            tag = reader.longlong()
            flags = reader.octet()
            requeue = bool(flags & 2)
            entry = self.unacked.pop(tag, None)
            if entry is not None and requeue:
                queue, body, headers, enq = entry
                self.server.queues.setdefault(queue, deque()).appendleft(
                    (body, True, _bump_delivery_count(headers), enq)
                )
            elif entry is not None:
                # rejected outright: dead-letter route when configured
                # (RabbitMQ x-dead-letter-exchange), else drop
                queue, body, headers, _enq = entry
                self.server.dead_letter_route(queue, body, headers, "rejected")
            self._pump_soon = True
        elif cm == codec.CONNECTION_CLOSE:
            self._send_method(0, codec.CONNECTION_CLOSE_OK)
            self.transport.close()

    async def _heartbeats(self) -> None:
        hb = codec.heartbeat_frame()
        try:
            while True:
                await asyncio.sleep(max(0.25, self.server.heartbeat / 2))
                self._send(hb)
        except asyncio.CancelledError:
            pass

    def _maybe_complete_publish(self) -> None:
        pending = self._pending
        if pending is None or pending[1] is None:
            return
        body = b"".join(pending[2])
        if len(body) < pending[1]:
            return
        self._pending = None
        self.server.queues.setdefault(pending[0], deque()).append(
            (body, False, pending[3], time.monotonic())
        )
        self._pump_soon = True

    # -- delivery -----------------------------------------------------------
    def can_take(self) -> bool:
        return self.prefetch == 0 or len(self.unacked) < self.prefetch

    def deliver(
        self,
        queue: str,
        body: bytes,
        redelivered: bool,
        headers: dict,
        enqueued_at: float | None = None,
        *,
        out: bytearray,
    ) -> None:
        tag = self.next_tag
        self.next_tag += 1
        self.unacked[tag] = (
            queue, body, headers,
            time.monotonic() if enqueued_at is None else enqueued_at,
        )
        args = (
            codec.Writer()
            .shortstr(self.consumes[queue])
            .longlong(tag)
            .bits(redelivered)
            .shortstr("")  # exchange
            .shortstr(queue)  # routing key
            .getvalue()
        )
        # frames coalesce into pump()'s per-connection buffer: one send
        # syscall per pump sweep, not per delivery — this path is the
        # broker's hot loop
        out += codec.method_frame(1, codec.BASIC_DELIVER, args).serialize()
        out += codec.header_frame(
            1, codec.CLASS_BASIC, len(body), headers=headers
        ).serialize()
        for bf in codec.body_frames(1, body, codec_frame_max()):
            out += bf.serialize()


def codec_frame_max() -> int:
    return 131072


def _bump_delivery_count(headers: dict | None) -> dict:
    """Copy ``headers`` with the x-delivery-count attempt header
    incremented (copied: the original dict may still be referenced by a
    delivery a consumer holds)."""
    out = dict(headers or {})
    try:
        prior = int(out.get(DELIVERY_COUNT_HEADER, 0) or 0)
    except (TypeError, ValueError):
        prior = 0
    out[DELIVERY_COUNT_HEADER] = prior + 1
    return out


class AmqpTestServer:
    """In-process AMQP broker bound to 127.0.0.1 on an ephemeral port."""

    def __init__(
        self,
        user: str = "guest",
        password: str = "guest",
        port: int = 0,
        heartbeat: int = 30,
        send_heartbeats: bool = True,
        metrics=None,
    ):
        self.user = user
        self.password = password
        self.heartbeat = heartbeat
        #: set False to simulate a silently-dead broker (watchdog tests)
        self.send_heartbeats = send_heartbeats
        #: optional Registry (or Metrics) for frame/queue-depth series
        self._metrics = (
            _BrokerMetrics(getattr(metrics, "registry", metrics))
            if metrics is not None
            else None
        )
        self._requested_port = port
        self.queues: dict[str, deque] = {}
        self._dead_letter: dict[str, str] = {}  # queue -> DLQ queue
        self._message_ttl: dict[str, float] = {}  # queue -> TTL seconds
        self.consumers: dict[str, list[_Conn]] = {}
        self.conns: set[_Conn] = set()
        self.port: int | None = None
        self._log = get_logger("mq.server")
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._rr: dict[str, int] = {}
        #: cross-connection pump coalescing: True while a sweep is
        #: already scheduled on the loop (further schedule_pump calls
        #: from OTHER connections' polls in the same iteration fold
        #: into it)
        self._pump_scheduled = False
        #: delivery sweeps actually run — the batching evidence the
        #: tests pin (N connections' same-iteration polls must cost
        #: ~1 sweep, not N)
        self.pump_sweeps = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        started = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(started,), daemon=True)
        self._thread.start()
        if not started.wait(5):
            raise RuntimeError("test broker failed to start")
        assert self.port is not None
        return self.port

    def _run(self, started: threading.Event) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def _serve():
            self._server = await self._loop.create_server(
                lambda: _Conn(self), "127.0.0.1", self._requested_port
            )
            self.port = self._server.sockets[0].getsockname()[1]
            started.set()

        self._loop.run_until_complete(_serve())
        self._loop.run_forever()

    def stop(self) -> None:
        if self._loop is None:
            return
        loop = self._loop

        def _shutdown():
            for conn in list(self.conns):
                if conn.transport:
                    conn.transport.close()
            if self._server is not None:
                self._server.close()
            loop.call_soon(loop.stop)

        loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5)

    def drop_all_connections(self) -> None:
        """Kill every client connection (for reconnect tests)."""
        assert self._loop is not None
        done = threading.Event()

        def _drop():
            for conn in list(self.conns):
                if conn.transport:
                    conn.transport.abort()
            done.set()

        self._loop.call_soon_threadsafe(_drop)
        done.wait(5)

    def queue_depth(self, queue: str) -> int:
        return len(self.queues.get(queue, ()))

    # -- reliability knobs --------------------------------------------------
    def set_dead_letter(self, queue: str, dlq: str) -> None:
        """Route ``queue``'s rejected and expired messages to ``dlq``
        (the x-dead-letter-exchange behavior, as a direct knob)."""
        if dlq == queue:
            raise ValueError(f"dead-letter loop: {queue!r} -> itself")
        self._dead_letter[queue] = dlq

    def set_message_ttl(self, queue: str, ttl_s: float) -> None:
        """Per-queue message TTL (x-message-ttl): messages older than
        ``ttl_s`` expire at the head of the queue on the next pump —
        dead-lettered when a DLQ is routed, dropped otherwise."""
        if ttl_s < 0:
            raise ValueError(f"ttl must be >= 0, got {ttl_s}")
        self._message_ttl[queue] = float(ttl_s)

    def dead_letter_route(
        self, queue: str, body: bytes, headers: dict, reason: str
    ) -> None:
        """Move one dead message to ``queue``'s DLQ (drop when none is
        configured), stamping death-provenance headers and the
        dead-letter counter either way."""
        if self._metrics is not None:
            self._metrics.dead_lettered_total.inc(queue=queue, reason=reason)
        dlq = self._dead_letter.get(queue)
        if dlq is None:
            return
        headers = dict(headers or {})
        headers.setdefault("x-beholder-death-queue", queue)
        headers.setdefault("x-beholder-death-reason", reason)
        headers.setdefault("x-beholder-death-unix-s", int(time.time()))
        self.queues.setdefault(dlq, deque()).append(
            (body, False, headers, time.monotonic())
        )

    def _expire(self, now: float) -> bool:
        """Head-of-queue TTL expiry across every routed queue; True when
        anything moved (so pump's delivery pass sees fresh DLQ work)."""
        moved = False
        for queue, ttl in self._message_ttl.items():
            pending = self.queues.get(queue)
            while pending:
                entry = pending[0]
                enqueued_at = entry[3] if len(entry) > 3 else now
                if now - enqueued_at < ttl:
                    # ages are non-decreasing front->back: publishes
                    # append FRESH at the back, requeues appendleft with
                    # their ORIGINAL (older) stamp — a young head really
                    # does mean nothing behind it is expired
                    break
                pending.popleft()
                self.dead_letter_route(queue, entry[0], entry[2], "expired")
                moved = True
        return moved

    # -- scheduling ---------------------------------------------------------
    def schedule_pump(self) -> None:
        """Coalesce pump requests across connections: the FIRST caller
        in an event-loop iteration schedules one sweep via
        ``call_soon``; every further request before it runs folds into
        it. With N producer connections' polls arriving in the same
        iteration the broker runs ONE delivery sweep over all their
        publishes (one write per consumer) instead of N sweeps —
        the cross-connection twin of ``_pump_soon``'s
        pump-once-per-recv. Wire bytes are unchanged: the deferred
        sweep walks the same queues in the same order over the same
        FIFO contents. Callable from any thread (falls back to a
        threadsafe call when invoked off-loop; a direct ``pump()``
        remains available for loop-less unit use)."""
        if self._pump_scheduled or self._loop is None:
            return
        self._pump_scheduled = True
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop:
            self._loop.call_soon(self._scheduled_pump)
        else:
            self._loop.call_soon_threadsafe(self._scheduled_pump)

    def _scheduled_pump(self) -> None:
        self._pump_scheduled = False
        self.pump()

    def pump(self) -> None:
        """Deliver queued messages to consumers with free prefetch slots
        (after expiring TTL-overdue heads into their DLQs). Each sweep
        coalesces one connection's deliveries into ONE socket write —
        a 30-message drain used to cost 30 send syscalls and wake the
        consumer 30 times; now it is one segment. Cross-connection
        coalescing lives in :meth:`schedule_pump`."""
        self.pump_sweeps += 1
        if self._message_ttl:
            self._expire(time.monotonic())
        writes: dict[_Conn, bytearray] = {}
        for queue, pending in list(self.queues.items()):
            consumers = [
                c for c in self.consumers.get(queue, []) if c.can_take()
            ]
            while pending and consumers:
                body, redelivered, headers, *rest = pending.popleft()
                idx = self._rr.get(queue, 0) % len(consumers)
                self._rr[queue] = idx + 1
                conn = consumers[idx]
                out = writes.get(conn)
                if out is None:
                    out = writes[conn] = bytearray()
                conn.deliver(
                    queue, body, redelivered, headers,
                    enqueued_at=rest[0] if rest else None,
                    out=out,
                )
                consumers = [c for c in consumers if c.can_take()]
        for conn, out in writes.items():
            if conn.transport and not conn.transport.is_closing():
                conn.transport.write(out)
        # pump() runs after every queue mutation (publish, ack, nack,
        # consume, connection loss), so refreshing the gauges here keeps
        # them current without a second bookkeeping path
        if self._metrics is not None:
            self._metrics.set_depths(self.queues)


def main() -> None:  # pragma: no cover - dev tool
    import os
    import time

    server = AmqpTestServer(port=int(os.environ.get("AMQP_PORT", "0")))
    port = server.start()
    print(f"amqp test broker listening on 127.0.0.1:{port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
