"""AMQP 0-9-1 client and the sync ``AmqpBroker`` facade.

The port's own copy of the reference's ``mq/amqp.py``. A from-scratch
implementation of the transport the reference gets from triton-core's AMQP
wrapper (amqplib + amqp-connection-manager, index.js:18,43-44): PLAIN
auth, one channel, per-queue consumers with explicit acks, a prefetch
window (100 in the reference), heartbeats, and automatic reconnect with
consumer re-registration (the amqp-connection-manager behavior noted in
SURVEY.md §5).

Architecture: an asyncio protocol runs on a dedicated event-loop thread
(socket IO + heartbeats only); consumer callbacks execute on a separate
dispatch thread so blocking handler work (HTTP, DB — the reference's
handlers are IO-bound too) can never starve the heartbeat, mirroring how
the reference's single JS event loop interleaves IO. Acks hop back to the
loop thread via ``call_soon_threadsafe``.

With ``instance.ingest.*`` armed (:meth:`AmqpBroker.configure_ingest`,
before ``connect``) each socket poll goes through one native scan
(:class:`~beholder_tpu_torch.mq.ingest.BatchFeed`), the poll's completed
deliveries reach the dispatch thread as one batch, each same-topic run
goes through its prepare stage (:meth:`AmqpBroker.listen_batch`) before
the per-message handlers, and settles coalesce into one loop callback and
one socket write per flush, never overtaking a publish scheduled before
them.
"""

from __future__ import annotations

import asyncio
import queue as queue_mod
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from urllib.parse import unquote, urlparse

from beholder_tpu_torch.log import get_logger

from . import codec
from .base import Broker, Delivery, Handler
from .ingest import BatchFeed, IngestConfig, IngestInstruments

DEFAULT_PORT = 5672
FRAME_MAX = 131072
HEARTBEAT = 30
RECONNECT_DELAY_S = 1.0
#: backoff ceiling for the reconnect loop (base = reconnect_delay, full
#: jitter between base and the doubling cap)
RECONNECT_MAX_DELAY_S = 30.0


@dataclass
class AmqpUrl:
    host: str
    port: int
    user: str
    password: str
    vhost: str

    @classmethod
    def parse(cls, url: str) -> "AmqpUrl":
        parsed = urlparse(url)
        if parsed.scheme not in ("amqp", ""):
            raise ValueError(f"unsupported scheme {parsed.scheme!r} in {url!r}")
        vhost = unquote(parsed.path[1:]) if len(parsed.path) > 1 else "/"
        return cls(
            host=parsed.hostname or "127.0.0.1",
            port=parsed.port or DEFAULT_PORT,
            user=unquote(parsed.username) if parsed.username else "guest",
            password=unquote(parsed.password) if parsed.password else "guest",
            vhost=vhost,
        )


class _Protocol(asyncio.Protocol):
    """One AMQP connection: handshake, channel 1, consume/publish/ack."""

    def __init__(self, client: "AmqpBroker"):
        self.client = client
        self.parser = codec.FrameParser()
        #: batched ingest (instance.ingest.*): one native scan per
        #: socket poll, zero-copy payload views, whole-poll delivery
        #: batches. None (the default) keeps the per-message path and
        #: its behavior byte-identical.
        self._batch_feed = (
            BatchFeed(zero_copy=client._ingest.zero_copy)
            if client._ingest is not None
            else None
        )
        self.transport: asyncio.Transport | None = None
        self.ready = asyncio.get_event_loop().create_future()
        self.frame_max = FRAME_MAX
        self.heartbeat = client.heartbeat
        self._hb_task: asyncio.Task | None = None
        self._last_rx = asyncio.get_event_loop().time()
        # in-progress delivery: (consumer_tag, delivery_tag, redelivered,
        # routing_key, expected_size, chunks, headers)
        self._pending: list | None = None
        #: batched-ingest ack coalescing: settles queue here (any
        #: thread) and drain on the loop in ONE callback + ONE socket
        #: write per flush — the per-message path's one
        #: call_soon_threadsafe per ack is the dominant loop-thread
        #: cost once deliveries batch
        self._settle_pending: list | None = [] if self._batch_feed is not None else None
        #: epoch of publish scheduling: bumped (under the settle lock)
        #: each time the broker schedules a publish callback. Settles
        #: queued AFTER a publish must flush in a callback scheduled
        #: AFTER that publish's, or a coalesced ack could hit the wire
        #: before the DLQ park it follows on the dispatch thread —
        #: inverting the park-before-ack order at-least-once relies on.
        self._publish_epoch = 0
        #: cutoff epochs of scheduled-but-not-yet-run flush callbacks
        #: (monotone nondecreasing; each flush drains the pending
        #: prefix at or below its own cutoff)
        self._settle_cutoffs: deque[int] = deque()
        self._settle_lock = threading.Lock()
        self._log = client._log

    # -- asyncio.Protocol ---------------------------------------------------
    def connection_made(self, transport):
        self.transport = transport
        transport.write(codec.PROTOCOL_HEADER)

    def data_received(self, data):
        self._last_rx = asyncio.get_event_loop().time()
        if self._batch_feed is not None:
            self._data_received_batched(data)
            return
        try:
            for frame in self.parser.feed(data):
                self._on_frame(frame)
        except codec.ProtocolError as err:
            self._log.warning(f"protocol error: {err}; dropping connection")
            if self.transport:
                self.transport.close()

    def _data_received_batched(self, data):
        """The batched ingest poll: ONE native scan over this poll's
        bytes, frames folded into completed deliveries, and the whole
        poll's deliveries handed to dispatch as ONE batch (one queue
        hop per poll instead of per message)."""
        recorder = self.client._ingest_recorder
        t0 = time.perf_counter() if recorder is not None else 0.0
        batch: list[Delivery] = []
        n_frames = 0
        try:
            frames = self._batch_feed.feed(data)
            n_frames = len(frames)
            for frame in frames:
                self._on_frame_batched(frame, batch)
        except codec.ProtocolError as err:
            self._log.warning(f"protocol error: {err}; dropping connection")
            if self.transport:
                self.transport.close()
            return
        finally:
            if batch:
                self.client._on_deliver_batch(batch)
        if recorder is not None:
            dur = time.perf_counter() - t0
            recorder.record(
                "ingest.poll",
                time.time() - dur,
                dur,
                frames=n_frames,
                bytes=len(data),
                msgs=len(batch),
            )

    def _on_frame_batched(self, frame: codec.Frame, batch: list) -> None:
        ftype = frame.type
        if ftype == codec.FRAME_BODY:
            if self._pending is not None:
                self._pending[5].append(frame.payload)
                self._maybe_complete_batched(batch)
        elif ftype == codec.FRAME_METHOD:
            # control frames are rare and small; the shared method
            # handler's Reader wants bytes, so detach the view here
            if not isinstance(frame.payload, bytes):
                frame = frame._replace(payload=bytes(frame.payload))
            self._on_method(frame)
        elif ftype == codec.FRAME_HEADER:
            if self._pending is not None:
                size, headers = codec.parse_basic_header(bytes(frame.payload))
                self._pending[4] = size
                self._pending[6] = headers
                self._maybe_complete_batched(batch)

    def _maybe_complete_batched(self, batch: list) -> None:
        """Batch-path twin of :meth:`_maybe_complete`: a single-frame
        body stays the zero-copy view (the overwhelmingly common case);
        multi-frame bodies join into bytes exactly once."""
        pending = self._pending
        if pending is None or pending[4] is None:
            return
        chunks = pending[5]
        if sum(len(c) for c in chunks) < pending[4]:
            return
        self._pending = None
        body = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        _tag, delivery_tag, redelivered, routing_key, _size, _chunks, headers = pending
        batch.append(
            self.client._build_delivery(
                routing_key, body, delivery_tag, redelivered, headers
            )
        )

    def connection_lost(self, exc):
        if self._hb_task:
            self._hb_task.cancel()
        if not self.ready.done():
            self.ready.set_exception(exc or ConnectionError("connection closed"))
        self.client._on_connection_lost(exc)

    # -- frame handling -----------------------------------------------------
    def _send_method(self, channel: int, cm, args: bytes = b"") -> None:
        assert self.transport is not None
        self.transport.write(codec.method_frame(channel, cm, args).serialize())

    def _on_frame(self, frame: codec.Frame) -> None:
        if frame.type == codec.FRAME_HEARTBEAT:
            return
        if frame.type == codec.FRAME_METHOD:
            self._on_method(frame)
        elif frame.type == codec.FRAME_HEADER:
            if self._pending is not None:
                size, headers = codec.parse_basic_header(frame.payload)
                self._pending[4] = size
                self._pending[6] = headers
                self._maybe_complete()
        elif frame.type == codec.FRAME_BODY:
            if self._pending is not None:
                self._pending[5].append(frame.payload)
                self._maybe_complete()

    def _on_method(self, frame: codec.Frame) -> None:
        cm, reader = codec.parse_method(frame)

        if cm == codec.CONNECTION_START:
            creds = AmqpUrl.parse(self.client.url)
            response = b"\x00" + creds.user.encode() + b"\x00" + creds.password.encode()
            args = (
                codec.Writer()
                .table({"product": "beholder-tpu", "version": "0.1.0"})
                .shortstr("PLAIN")
                .longstr(response)
                .shortstr("en_US")
                .getvalue()
            )
            self._send_method(0, codec.CONNECTION_START_OK, args)
        elif cm == codec.CONNECTION_TUNE:
            channel_max = reader.short()
            frame_max = reader.long()
            heartbeat = reader.short()
            self.frame_max = min(frame_max or FRAME_MAX, FRAME_MAX)
            self.heartbeat = min(heartbeat or self.client.heartbeat, self.client.heartbeat)
            args = (
                codec.Writer()
                .short(channel_max)
                .long(self.frame_max)
                .short(self.heartbeat)
                .getvalue()
            )
            self._send_method(0, codec.CONNECTION_TUNE_OK, args)
            creds = AmqpUrl.parse(self.client.url)
            open_args = (
                codec.Writer().shortstr(creds.vhost).shortstr("").bits(False).getvalue()
            )
            self._send_method(0, codec.CONNECTION_OPEN, open_args)
        elif cm == codec.CONNECTION_OPEN_OK:
            self._send_method(1, codec.CHANNEL_OPEN, codec.Writer().shortstr("").getvalue())
        elif cm == codec.CHANNEL_OPEN_OK:
            qos = (
                codec.Writer()
                .long(0)
                .short(self.client.prefetch)
                .bits(False)
                .getvalue()
            )
            self._send_method(1, codec.BASIC_QOS, qos)
        elif cm == codec.BASIC_QOS_OK:
            if self.heartbeat:
                self._hb_task = asyncio.get_event_loop().create_task(self._heartbeats())
            if not self.ready.done():
                self.ready.set_result(None)
        elif cm == codec.QUEUE_DECLARE_OK:
            pass
        elif cm == codec.BASIC_CONSUME_OK:
            pass
        elif cm == codec.BASIC_DELIVER:
            consumer_tag = reader.shortstr()
            delivery_tag = reader.longlong()
            redelivered = bool(reader.octet() & 1)
            reader.shortstr()  # exchange
            routing_key = reader.shortstr()
            self._pending = [consumer_tag, delivery_tag, redelivered, routing_key, None, [], {}]
        elif cm == codec.CONNECTION_CLOSE:
            code = reader.short()
            text = reader.shortstr()
            self._log.warning(f"server closed connection: {code} {text}")
            self._send_method(0, codec.CONNECTION_CLOSE_OK)
            if self.transport:
                self.transport.close()
        elif cm == codec.CHANNEL_CLOSE:
            code = reader.short()
            text = reader.shortstr()
            self._log.warning(f"server closed channel: {code} {text}")
            self._send_method(1, codec.CHANNEL_CLOSE_OK)
            if self.transport:
                self.transport.close()
        else:
            self._log.warning(f"unhandled method {cm}")

    def _maybe_complete(self) -> None:
        pending = self._pending
        if pending is None or pending[4] is None:
            return
        body = b"".join(pending[5])
        if len(body) < pending[4]:
            return
        self._pending = None
        _tag, delivery_tag, redelivered, routing_key, _size, _chunks, headers = pending
        self.client._on_deliver(routing_key, body, delivery_tag, redelivered, headers)

    async def _heartbeats(self) -> None:
        """Send heartbeats at interval/2; drop the connection if the peer
        goes silent for 2 intervals (silent-partition watchdog — a dead
        broker host never sends FIN, so connection_lost alone is not enough
        for the reconnect story)."""
        interval = max(0.25, self.heartbeat / 2)
        hb = codec.heartbeat_frame().serialize()
        loop = asyncio.get_event_loop()
        try:
            while True:
                await asyncio.sleep(interval)
                if self.transport is None or self.transport.is_closing():
                    continue
                if loop.time() - self._last_rx > 2 * self.heartbeat:
                    self._log.warning(
                        f"no traffic from broker for >{2 * self.heartbeat}s; "
                        "dropping connection"
                    )
                    self.transport.abort()
                    return
                self.transport.write(hb)
        except asyncio.CancelledError:
            pass

    # -- outgoing operations (called from the loop thread) ------------------
    def declare(self, queue: str) -> None:
        args = (
            codec.Writer()
            .short(0)
            .shortstr(queue)
            .bits(False, True, False, False, False)  # durable=True
            .table({})
            .getvalue()
        )
        self._send_method(1, codec.QUEUE_DECLARE, args)

    def declare_and_consume(self, queue: str) -> None:
        self.declare(queue)
        consume = (
            codec.Writer()
            .short(0)
            .shortstr(queue)
            .shortstr(f"beholder.{queue}")
            .bits(False, False, False, False)  # explicit acks
            .table({})
            .getvalue()
        )
        self._send_method(1, codec.BASIC_CONSUME, consume)

    def _encode_publish(
        self, out: bytearray, routing_key: str, body: bytes, headers: dict | None
    ) -> None:
        """Serialize one publish (method + header + body frames) into
        ``out`` — the single encoder both egress paths share, so the
        per-message and batched wire bytes can never diverge."""
        args = (
            codec.Writer()
            .short(0)
            .shortstr("")
            .shortstr(routing_key)
            .bits(False, False)
            .getvalue()
        )
        out += codec.method_frame(1, codec.BASIC_PUBLISH, args).serialize()
        out += codec.header_frame(
            1,
            codec.CLASS_BASIC,
            len(body),
            delivery_mode=codec.DELIVERY_PERSISTENT,
            headers=headers,
        ).serialize()
        for bf in codec.body_frames(1, body, self.frame_max):
            out += bf.serialize()

    def publish(
        self, routing_key: str, body: bytes, headers: dict | None = None
    ) -> None:
        assert self.transport is not None
        out = bytearray()
        self._encode_publish(out, routing_key, body, headers)
        self.transport.write(bytes(out))

    def publish_many(
        self, items: list[tuple[str, bytes]], headers: dict | None = None
    ) -> None:
        """One coalesced socket write for a list of (routing_key, body)
        publishes — the egress twin of the batched ingest path (a
        per-message publish pays a transport.write syscall each)."""
        assert self.transport is not None
        out = bytearray()
        for routing_key, body in items:
            self._encode_publish(out, routing_key, body, headers)
        self.transport.write(bytes(out))

    @staticmethod
    def _encode_settle(
        out: bytearray, delivery_tag: int, acked: bool, requeue: bool
    ) -> None:
        """Serialize one BASIC_ACK/BASIC_NACK into ``out`` — the single
        encoder both settle paths share (the egress twin of
        :meth:`_encode_publish`), so the per-message and coalesced
        wire bytes can never diverge."""
        if acked:
            args = codec.Writer().longlong(delivery_tag).bits(False).getvalue()
            cm = codec.BASIC_ACK
        else:
            args = (
                codec.Writer().longlong(delivery_tag).bits(False, requeue).getvalue()
            )
            cm = codec.BASIC_NACK
        out += codec.method_frame(1, cm, args).serialize()

    def settle(self, delivery_tag: int, acked: bool, requeue: bool) -> None:
        if self.transport is None or self.transport.is_closing():
            return  # connection died; broker will redeliver unacked anyway
        out = bytearray()
        self._encode_settle(out, delivery_tag, acked, requeue)
        self.transport.write(bytes(out))

    def note_publish_scheduled(self) -> None:
        """Called by the broker (any thread) right before it schedules a
        publish callback: settles queued from here on must ride a flush
        scheduled AFTER that publish, never an earlier one — preserving
        the per-message path's publish-before-ack wire order (the DLQ
        parks a message and THEN acks it; writing the ack first opens a
        message-loss window if the connection dies between the two)."""
        if self._settle_pending is None:
            return
        with self._settle_lock:
            self._publish_epoch += 1

    def queue_settle(
        self, loop, delivery_tag: int, acked: bool, requeue: bool
    ) -> None:
        """Batched-ingest settle path (any thread): queue the settle
        and schedule ONE loop callback for however many pile up before
        it runs. Order among settles is preserved, and a settle queued
        after a publish was scheduled flushes in a LATER callback than
        that publish's (epoch cutoffs), so the wire order of publishes
        vs acks matches the per-message path."""
        with self._settle_lock:
            epoch = self._publish_epoch
            self._settle_pending.append((epoch, delivery_tag, acked, requeue))
            if self._settle_cutoffs and self._settle_cutoffs[-1] == epoch:
                return  # an outstanding flush at this epoch covers us
            self._settle_cutoffs.append(epoch)
        loop.call_soon_threadsafe(self._flush_settles)

    def _flush_settles(self) -> None:
        with self._settle_lock:
            if not self._settle_cutoffs:
                return
            cutoff = self._settle_cutoffs.popleft()
            # pending is sorted by epoch (epochs only grow); this flush
            # owns the prefix at or below its cutoff — entries queued
            # after a later publish wait for their own, later, callback
            pending = self._settle_pending
            i = 0
            while i < len(pending) and pending[i][0] <= cutoff:
                i += 1
            pending, self._settle_pending = pending[:i], pending[i:]
        if not pending:
            return
        if self.transport is None or self.transport.is_closing():
            return  # connection died; broker will redeliver unacked anyway
        out = bytearray()
        for _epoch, delivery_tag, acked, requeue in pending:
            self._encode_settle(out, delivery_tag, acked, requeue)
        self.transport.write(bytes(out))


class AmqpBroker(Broker):
    """Sync facade implementing the service's ``Broker`` contract over the
    asyncio protocol. Reconnects with backoff and re-registers consumers,
    like the reference's amqp-connection-manager."""

    #: publishes buffered while disconnected (amqp-connection-manager
    #: behavior); bounded so a long outage cannot eat unbounded memory
    MAX_BUFFERED_PUBLISHES = 10_000

    def __init__(
        self,
        url: str,
        prefetch: int = 100,
        reconnect_delay: float = RECONNECT_DELAY_S,
        heartbeat: int = HEARTBEAT,
        ingest: IngestConfig | None = None,
    ):
        self.url = url
        self.prefetch = prefetch
        self.reconnect_delay = reconnect_delay
        self.heartbeat = heartbeat
        self._log = get_logger("mq.amqp")
        #: batched native ingest (instance.ingest.*; None = the
        #: per-message path, byte-identical to previous releases).
        #: configure_ingest() may arm it later, before connect().
        self._ingest = ingest
        self._ingest_registry = None
        self._ingest_recorder = None
        self._ingest_instruments: IngestInstruments | None = None
        self._batch_prepares: dict[str, object] = {}
        self._handlers: dict[str, Handler] = {}
        self._declared: set[str] = set()  # consumer-less queues (e.g. DLQs)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._protocol: _Protocol | None = None
        self._dispatch_q: queue_mod.Queue = queue_mod.Queue()
        self._dispatch_thread: threading.Thread | None = None
        self._closing = False
        self._connected = threading.Event()
        self._connecting = False  # loop-thread-only: one reconnect loop owner
        self._publish_buffer: list[tuple[str, bytes]] = []

    @property
    def connected(self) -> bool:
        """Liveness probe: is the AMQP connection currently up?"""
        return self._connected.is_set()

    # -- Broker -------------------------------------------------------------
    def connect(self, timeout: float = 10.0) -> None:
        if self._loop_thread is not None:
            # idempotent: the service's start() calls connect() too
            # (index.js:44), after the operator may already have connected
            if not self._connected.wait(timeout):
                raise TimeoutError(f"not connected to {self.url} within {timeout}s")
            return
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="amqp-io", daemon=True
        )
        self._loop_thread.start()
        self._dispatch_thread = threading.Thread(
            target=self._run_dispatch, name="amqp-dispatch", daemon=True
        )
        self._dispatch_thread.start()
        asyncio.run_coroutine_threadsafe(self._connect_loop(), self._loop)
        if not self._connected.wait(timeout):
            raise TimeoutError(f"could not connect to {self.url} within {timeout}s")

    def configure_ingest(
        self, config: IngestConfig, registry=None, flight_recorder=None
    ) -> None:
        """Arm the batched ingest path: call BEFORE ``connect()`` (the
        per-connection batch feed is built at handshake time).
        ``registry`` hosts the lazily-registered ``beholder_ingest_*``
        series (zero new series until a batch flows); ``flight_recorder``
        receives ``ingest.poll``/``ingest.batch`` phase events."""
        self._ingest = config
        self._ingest_registry = registry
        self._ingest_recorder = flight_recorder

    def listen(self, topic: str, handler: Handler) -> None:
        if topic in self._handlers:
            raise ValueError(f"topic {topic!r} already has a consumer")
        self._handlers[topic] = handler
        self._call_on_loop(lambda p: p.declare_and_consume(topic))

    def listen_batch(self, topic: str, handler: Handler, prepare) -> None:
        """:meth:`Broker.listen_batch`: the prepare stage runs once per
        drained same-topic run on the dispatch thread, before the
        per-message handler chain (which runs unchanged)."""
        self._batch_prepares[topic] = prepare
        self.listen(topic, handler)

    def declare(self, topic: str) -> None:
        """Declare ``topic``'s queue (durable) without consuming — a
        publish-only destination like a DLQ must exist server-side or
        default-exchange publishes to it are silently unroutable.
        Re-declared on every reconnect, like consumers."""
        self._declared.add(topic)
        self._call_on_loop(lambda p: p.declare(topic))

    def publish(self, topic: str, body: bytes, headers: dict | None = None) -> None:
        payload = bytes(body)

        def _publish_or_buffer():
            if self._protocol is not None:
                self._protocol.publish(topic, payload, headers)
            elif len(self._publish_buffer) < self.MAX_BUFFERED_PUBLISHES:
                # disconnected: hold the message until reconnect, like the
                # reference stack's amqp-connection-manager does
                self._publish_buffer.append((topic, payload, headers))
            else:
                self._log.warning(
                    f"publish buffer full ({self.MAX_BUFFERED_PUBLISHES}); "
                    f"dropping message for {topic!r}"
                )

        if self._loop is None:
            raise RuntimeError("not connected; call connect() first")
        protocol = self._protocol
        if protocol is not None:
            protocol.note_publish_scheduled()
        self._loop.call_soon_threadsafe(_publish_or_buffer)

    def publish_many(
        self, items, headers: dict | None = None
    ) -> None:
        """Publish a list of ``(topic, body)`` pairs with ONE loop hop
        and ONE coalesced socket write — a per-message :meth:`publish`
        pays a ``call_soon_threadsafe`` self-pipe syscall each, which
        becomes the producer-side bottleneck at batch rates. Ordering
        matches the equivalent sequence of publishes; while
        disconnected the batch lands in the same bounded buffer."""
        payload = [(topic, bytes(body)) for topic, body in items]

        def _publish_or_buffer():
            if self._protocol is not None:
                self._protocol.publish_many(payload, headers)
            else:
                room = self.MAX_BUFFERED_PUBLISHES - len(self._publish_buffer)
                for topic, body in payload[: max(room, 0)]:
                    self._publish_buffer.append((topic, body, headers))
                if room < len(payload):
                    self._log.warning(
                        f"publish buffer full ({self.MAX_BUFFERED_PUBLISHES}); "
                        f"dropping {len(payload) - max(room, 0)} message(s)"
                    )

        if self._loop is None:
            raise RuntimeError("not connected; call connect() first")
        protocol = self._protocol
        if protocol is not None:
            protocol.note_publish_scheduled()
        self._loop.call_soon_threadsafe(_publish_or_buffer)

    def close(self) -> None:
        self._closing = True
        self._dispatch_q.put(None)
        if self._loop is not None:
            loop = self._loop

            def _shutdown():
                if self._protocol is not None and self._protocol.transport:
                    self._protocol.transport.close()
                # give connection_lost / task cancellation a tick to settle
                loop.call_later(0.1, loop.stop)

            loop.call_soon_threadsafe(_shutdown)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout=5)
        if self._loop is not None and not self._loop.is_running():
            # the loop stopped above; release its selector/self-pipe fds
            # (GC would otherwise warn "event loop not closed")
            self._loop.close()

    # -- loop-side ----------------------------------------------------------
    def _run_loop(self) -> None:
        assert self._loop is not None
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    async def _connect_loop(self) -> None:
        """The single owner of (re)connection. Re-entrant calls return
        immediately — only one loop may run, otherwise each handshake-time
        drop would spawn another loop and every reconnect would register
        duplicate consumers."""
        if self._connecting:
            return
        self._connecting = True
        creds = AmqpUrl.parse(self.url)
        loop = asyncio.get_event_loop()
        attempt = 0
        try:
            while not self._closing:
                try:
                    _transport, protocol = await loop.create_connection(
                        lambda: _Protocol(self), creds.host, creds.port
                    )
                    self._protocol = protocol
                    await protocol.ready
                    for topic in self._handlers:
                        protocol.declare_and_consume(topic)
                    for topic in self._declared:
                        protocol.declare(topic)
                    buffered, self._publish_buffer = self._publish_buffer, []
                    for topic, body, headers in buffered:
                        protocol.publish(topic, body, headers)
                    if buffered:
                        self._log.info(
                            f"flushed {len(buffered)} buffered publishes"
                        )
                    self._connected.set()
                    self._log.info(f"connected to {creds.host}:{creds.port}")
                    return
                except (OSError, ConnectionError) as err:
                    # bounded exponential backoff with jitter (uniform over
                    # [base, cap]): a fleet of consumers losing one broker
                    # must not reconnect in lockstep
                    attempt += 1
                    cap = min(
                        self.reconnect_delay * 2 ** (attempt - 1),
                        max(self.reconnect_delay, RECONNECT_MAX_DELAY_S),
                    )
                    delay = self.reconnect_delay + random.random() * max(
                        cap - self.reconnect_delay, 0.0
                    )
                    self._log.warning(
                        f"connect to {creds.host}:{creds.port} failed: {err}; "
                        f"retrying in {delay:.2f}s (attempt {attempt})"
                    )
                    await asyncio.sleep(delay)
        finally:
            self._connecting = False

    def _on_connection_lost(self, exc) -> None:
        self._connected.clear()
        self._protocol = None
        if self._closing or self._loop is None:
            return
        self._log.warning(f"connection lost ({exc}); reconnecting")
        asyncio.run_coroutine_threadsafe(self._reconnect(), self._loop)

    async def _reconnect(self) -> None:
        if self._connecting:
            return  # an active connect loop already handles retries
        await asyncio.sleep(self.reconnect_delay)
        await self._connect_loop()

    def _call_on_loop(self, fn) -> None:
        if self._loop is None:
            raise RuntimeError("not connected; call connect() first")

        def _run():
            if self._protocol is not None:
                fn(self._protocol)
            else:
                self._log.warning("operation dropped: not connected")

        self._loop.call_soon_threadsafe(_run)

    # -- delivery dispatch --------------------------------------------------
    def _build_delivery(
        self,
        topic: str,
        body: bytes,
        delivery_tag: int,
        redelivered: bool,
        headers: dict | None = None,
    ) -> Delivery:
        protocol = self._protocol
        loop = self._loop

        if protocol is not None and protocol._settle_pending is not None:
            # batched ingest: settles coalesce into one loop callback +
            # one socket write per flush (order preserved)
            def settle(tag: int, acked: bool, requeue: bool) -> None:
                if loop is not None and protocol is not None:
                    protocol.queue_settle(loop, tag, acked, requeue)

        else:

            def settle(tag: int, acked: bool, requeue: bool) -> None:
                if loop is not None and protocol is not None:
                    loop.call_soon_threadsafe(
                        protocol.settle, tag, acked, requeue
                    )

        return Delivery(
            topic, body, delivery_tag, settle, redelivered, headers=headers
        )

    def _on_deliver(
        self,
        topic: str,
        body: bytes,
        delivery_tag: int,
        redelivered: bool,
        headers: dict | None = None,
    ) -> None:
        self._dispatch_q.put(
            self._build_delivery(topic, body, delivery_tag, redelivered, headers)
        )

    def _on_deliver_batch(self, deliveries: list) -> None:
        """One queue hop for a whole poll's completed deliveries."""
        self._dispatch_q.put(deliveries)

    def _run_dispatch(self) -> None:
        while True:
            item = self._dispatch_q.get()
            if item is None:
                return
            if isinstance(item, list):
                if not self._dispatch_batch(item):
                    return
            else:
                self._dispatch_one(item)

    def _dispatch_one(self, delivery: Delivery) -> None:
        handler = self._handlers.get(delivery.topic)
        if handler is None:
            self._log.warning(f"no handler for {delivery.topic!r}; dropping")
            return
        try:
            handler(delivery)
        except Exception as err:  # noqa: BLE001
            # same contract as InMemoryBroker: a throwing handler leaves
            # its delivery unacked (redelivered after reconnect)
            self._log.warning(
                f"handler for {delivery.topic!r} raised: {err!r}; "
                f"delivery {delivery.delivery_tag} left unacked"
            )

    def _dispatch_batch(self, first: list) -> bool:
        """One batched dispatch round: drain already-queued deliveries
        into the batch (the backlog self-batches under load — nothing is
        ever WAITED for, so an idle wire keeps per-message latency),
        then run each consecutive same-topic run through its prepare
        stage + the per-message handler chain. Returns False when the
        shutdown sentinel was drained (the batch is still served)."""
        cfg = self._ingest
        max_batch = cfg.max_batch if cfg is not None else 256
        batch = list(first)
        alive = True
        while len(batch) < max_batch:
            try:
                item = self._dispatch_q.get_nowait()
            except queue_mod.Empty:
                break
            if item is None:
                alive = False  # serve what was drained, then exit
                break
            if isinstance(item, list):
                batch.extend(item)
            else:
                batch.append(item)
        i = 0
        n = len(batch)
        while i < n:
            topic = batch[i].topic
            j = i + 1
            # cap each run at max_batch even when ONE poll delivered
            # more (a coalesced pump segment can carry a whole backlog):
            # the knob bounds the prepare stage's transaction / IN(...)
            # size, not just the extra drain above
            while j < n and j - i < max_batch and batch[j].topic == topic:
                j += 1
            self._dispatch_run(topic, batch[i:j])
            i = j
        return alive

    def _dispatch_run(self, topic: str, run: list) -> None:
        handler = self._handlers.get(topic)
        if handler is None:
            for delivery in run:
                self._log.warning(f"no handler for {topic!r}; dropping")
            return
        recorder = self._ingest_recorder
        t0 = time.perf_counter() if recorder is not None else 0.0
        if self._ingest_instruments is None and self._ingest_registry is not None:
            self._ingest_instruments = IngestInstruments(self._ingest_registry)
        if self._ingest_instruments is not None:
            self._ingest_instruments.batch_size.observe(len(run))
            self._ingest_instruments.batched_msgs_total.inc(len(run))
        prepare = self._batch_prepares.get(topic)
        if prepare is not None:
            try:
                prepare(run)
            except Exception as err:  # noqa: BLE001
                # a failing prepare degrades to per-message work (each
                # handler redoes its own decode/write), never loses the
                # batch
                self._log.warning(
                    f"batch prepare for {topic!r} raised: {err!r}; "
                    "falling back to per-message work"
                )
        for delivery in run:
            try:
                handler(delivery)
            except Exception as err:  # noqa: BLE001
                self._log.warning(
                    f"handler for {topic!r} raised: {err!r}; "
                    f"delivery {delivery.delivery_tag} left unacked"
                )
        if recorder is not None:
            dur = time.perf_counter() - t0
            recorder.record(
                "ingest.batch",
                time.time() - dur,
                dur,
                batch=len(run),
                topic=topic,
            )
