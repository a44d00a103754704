"""Batched native ingest: drain-the-socket frame batches, zero-copy.

The port's own copy of the reference's ``mq/ingest.py``. The per-message
wire path pays an interpreted frame loop, a dispatch hop and a storage
round trip per message; this module is the batch-at-a-time front door:

- :class:`BatchFeed` scans ONE socket poll's bytes (plus any incomplete
  tail from the previous poll) in a single native pass
  (``framecodec_ext.scan_views``) and returns the complete frames with
  payloads as ZERO-COPY memoryviews into that poll's buffer generation —
  no per-frame ``bytes`` copies, no per-frame Python loop cost. The
  scanner is built from C++ at first use (``mq/_native.py``); a build
  failure raises with the compiler's output instead of falling back. The
  pure-Python walk runs only when asked for (``use_native=False`` or
  ``$BEHOLDER_NATIVE_CODEC=0``), and the ctypes scanner only when a test
  picks it; all three give identical frames, consumed counts and errors.
- Buffer GENERATIONS, not a trimmed accumulation buffer: each poll's
  bytes are an immutable ``bytes`` object the batch's views refcount.
  A handler that holds a payload past the batch keeps exactly its own
  generation alive; later polls allocate fresh generations and can never
  scribble over an exported view. Nothing is resized while exported.
- :class:`IngestConfig` is the ``instance.ingest.*`` knob surface
  (parsed by :func:`ingest_from_config`). Default OFF: the per-message
  path and the default /metrics exposition stay byte-identical.
- :class:`IngestInstruments` is the lazily-registered metric catalog
  (``beholder_ingest_*``): zero new series until the knob is on AND a
  batch actually flowed.

The broker side (``mq/amqp.py``) feeds polls through a BatchFeed and
dispatches whole batches; the service side (``service.py``) registers
batch PREPARE stages that fold per-message work (one protobuf decode
pass, one storage transaction per drained batch) while the per-message
handler chain — tracing, timing, at-least-once settlement — runs
unchanged, so handler outcomes are identical to the per-message loop.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from . import _native, codec

#: ingest batch-size histogram buckets: powers of two up to the default
#: dispatch drain cap (batch sizes are small integers, not seconds)
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


@dataclass(frozen=True)
class IngestConfig:
    """The ``instance.ingest.*`` knob surface (the service parses it once
    and wires whatever broker it owns)."""

    #: deliveries per dispatched batch: the dispatch thread drains up to
    #: this many already-queued deliveries into one batch (backlog
    #: self-batches under load; an idle wire stays latency-neutral
    #: because only ready items are drained, never waited for), and
    #: every dispatched same-topic run — and with it the per-batch
    #: storage transaction — is capped at this size even when a single
    #: coalesced poll carried more
    max_batch: int = 256
    #: hand handlers zero-copy memoryview payloads over the poll buffer
    #: generation; False detaches every payload to ``bytes`` defensively
    zero_copy: bool = True
    #: fold each drained batch's storage writes into one transaction via
    #: the service's batch prepare stages (``update_status_batch``)
    batch_storage: bool = True


def ingest_from_config(config) -> IngestConfig | None:
    """Parse ``instance.ingest.*`` into an :class:`IngestConfig`;
    ``None`` when absent/disabled (the default — behavior and the
    default exposition stay byte-identical)."""
    node = config.get("instance.ingest") if config is not None else None
    if node is None or not bool(node.get("enabled", False)):
        return None
    return IngestConfig(
        max_batch=int(node.get("max_batch", 256)),
        zero_copy=bool(node.get("zero_copy", True)),
        batch_storage=bool(node.get("batch_storage", True)),
    )


class IngestInstruments:
    """Lazily-registered ``beholder_ingest_*`` catalog (created on the
    first dispatched batch, so the default exposition never widens)."""

    def __init__(self, registry):
        from beholder_tpu_torch.metrics import get_or_create

        self.batch_size = get_or_create(
            registry, "histogram",
            "beholder_ingest_batch_size",
            "Deliveries per batch dispatched through the batched ingest "
            "path (1 = no backlog was queued when the batch drained)",
            buckets=BATCH_SIZE_BUCKETS,
        )
        self.batched_msgs_total = get_or_create(
            registry, "counter",
            "beholder_ingest_batched_msgs_total",
            "Messages dispatched through the batched ingest path",
        )


def _scan_python(buf: bytes) -> tuple[list, int]:
    """Pure-Python batch walk with the SAME contract as the native
    entry points: zero-copy memoryview payloads, ``ValueError`` with
    the bad frame's start offset on a corrupt frame end."""
    frames: list = []
    mv = memoryview(buf)
    pos = 0
    n = len(buf)
    unpack = struct.unpack_from
    append = frames.append
    frame = codec.Frame
    while n - pos >= 7:
        ftype, channel, size = unpack(">BHI", buf, pos)
        total = 7 + size + 1
        if n - pos < total:
            break
        if buf[pos + 7 + size] != codec.FRAME_END:
            err = ValueError(f"bad frame end at buffer offset {pos}")
            err.offset = pos
            raise err
        append(frame(ftype, channel, mv[pos + 7 : pos + 7 + size]))
        pos += total
    return frames, pos


class BatchFeed:
    """Per-connection batched frame feed over immutable buffer
    generations.

    ``feed(data)`` scans one poll in a single backend pass and returns
    every complete frame; payloads are memoryviews into this poll's
    generation (``zero_copy=False`` detaches them to ``bytes``). The
    incomplete tail is carried into the next generation. On a corrupt
    frame end the feed raises :class:`~beholder_tpu_torch.mq.codec.
    ProtocolError` with the retained buffer starting AT the bad frame —
    the same post-error contract as :class:`~beholder_tpu_torch.mq.codec.
    FrameParser` across all three backends.

    ``backend`` is ``"ext"`` (the C-API extension's ``scan_views``, one C
    call per poll), built at construction unless ``use_native=False`` or
    ``$BEHOLDER_NATIVE_CODEC=0`` ask for the pure-Python walk
    (``"python"``); ``"ctypes"`` (the plain C loop through ctypes) is
    there for a caller that sets it.
    """

    def __init__(
        self, use_native: bool | None = None, zero_copy: bool = True
    ):
        self.zero_copy = zero_copy
        self._tail = b""
        self.backend = "python"
        env_off = os.environ.get("BEHOLDER_NATIVE_CODEC") == "0"
        if use_native is False or (use_native is None and env_off):
            return  # the explicit pure-Python walk
        _native.build()  # raises with the compiler's output
        self.backend = "ext"

    def _scan(self, buf: bytes) -> tuple[list, int]:
        if self.backend == "ext":
            triples, consumed = _native._ext.scan_views(buf)
            make = codec.Frame._make
            return [make(t) for t in triples], consumed
        if self.backend == "ctypes":
            return self._scanner.scan_views(buf, codec.Frame)
        return _scan_python(buf)

    def feed(self, data: bytes) -> list[codec.Frame]:
        """Scan one poll; returns the complete frames (payloads are
        views into this poll's generation unless ``zero_copy=False``)."""
        # one concatenation when a tail is carried; the common aligned
        # poll reuses the socket's own bytes object as the generation.
        # The tail is at most ONE incomplete frame (complete frames are
        # always consumed), so the copy is bounded by frame_max per poll.
        buf = self._tail + data if self._tail else bytes(data)
        try:
            frames, consumed = self._scan(buf)
        except ValueError as err:
            # shared post-error contract with FrameParser: the retained
            # buffer starts at the bad frame (good frames before it in
            # this feed are dropped — the connection is dying anyway)
            msg = str(err)
            offset = codec.bad_frame_offset(err)
            if offset is not None:
                self._tail = buf[offset:]
                msg += " (buffer trimmed; the bad frame is now at offset 0)"
            raise codec.ProtocolError(msg) from None
        self._tail = buf[consumed:]
        if not self.zero_copy:
            frames = [
                f._replace(payload=bytes(f.payload))
                if isinstance(f.payload, memoryview)
                else f
                for f in frames
            ]
        return frames

    @property
    def pending_bytes(self) -> int:
        """Bytes of incomplete tail carried to the next generation."""
        return len(self._tail)
