"""AMQP 0-9-1 wire codec: frames, field types, and the method subset the
beholder path needs.

The port's own copy of the reference's ``mq/codec.py``, written from the
public AMQP 0-9-1 specification: the client (:mod:`beholder_tpu_torch.mq.
amqp`) and the loopback server (:mod:`beholder_tpu_torch.mq.server`) are
built on it. The frame parser walks frames in Python, or binds the native
scanner (``mq/_native.py``, built from C++ at first use) when asked to.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"
FRAME_END = 0xCE

# frame types
FRAME_METHOD = 1
FRAME_HEADER = 2
FRAME_BODY = 3
FRAME_HEARTBEAT = 8

# class ids
CLASS_CONNECTION = 10
CLASS_CHANNEL = 20
CLASS_QUEUE = 50
CLASS_BASIC = 60

# (class, method) ids
CONNECTION_START = (10, 10)
CONNECTION_START_OK = (10, 11)
CONNECTION_TUNE = (10, 30)
CONNECTION_TUNE_OK = (10, 31)
CONNECTION_OPEN = (10, 40)
CONNECTION_OPEN_OK = (10, 41)
CONNECTION_CLOSE = (10, 50)
CONNECTION_CLOSE_OK = (10, 51)
CHANNEL_OPEN = (20, 10)
CHANNEL_OPEN_OK = (20, 11)
CHANNEL_CLOSE = (20, 40)
CHANNEL_CLOSE_OK = (20, 41)
QUEUE_DECLARE = (50, 10)
QUEUE_DECLARE_OK = (50, 11)
BASIC_QOS = (60, 10)
BASIC_QOS_OK = (60, 11)
BASIC_CONSUME = (60, 20)
BASIC_CONSUME_OK = (60, 21)
BASIC_PUBLISH = (60, 40)
BASIC_DELIVER = (60, 60)
BASIC_ACK = (60, 80)
BASIC_NACK = (60, 120)


class ProtocolError(RuntimeError):
    pass


# --------------------------------------------------------------------------
# primitive encoders / decoders
# --------------------------------------------------------------------------


class Writer:
    """Accumulates AMQP-encoded fields."""

    def __init__(self):
        self._parts: list[bytes] = []

    def octet(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">B", v))
        return self

    def short(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">H", v))
        return self

    def long(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">I", v))
        return self

    def longlong(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">Q", v))
        return self

    def shortstr(self, v: str) -> "Writer":
        raw = v.encode("utf-8")
        if len(raw) > 255:
            raise ProtocolError("shortstr too long")
        self._parts.append(struct.pack(">B", len(raw)) + raw)
        return self

    def longstr(self, v: bytes) -> "Writer":
        self._parts.append(struct.pack(">I", len(v)) + v)
        return self

    def bits(self, *flags: bool) -> "Writer":
        """Pack up to 8 bit flags into one octet (AMQP bit packing)."""
        if len(flags) > 8:
            raise ProtocolError("too many bits for one octet")
        value = 0
        for i, flag in enumerate(flags):
            if flag:
                value |= 1 << i
        return self.octet(value)

    def table(self, t: dict[str, Any]) -> "Writer":
        body = Writer()
        for key, value in t.items():
            body.shortstr(key)
            body._field_value(value)
        payload = body.getvalue()
        return self.longstr(payload)

    def _field_value(self, value: Any) -> None:
        if isinstance(value, bool):
            self._parts.append(b"t" + struct.pack(">B", int(value)))
        elif isinstance(value, int):
            if -(1 << 31) <= value < (1 << 31):
                self._parts.append(b"I" + struct.pack(">i", value))
            elif -(1 << 63) <= value < (1 << 63):
                self._parts.append(b"l" + struct.pack(">q", value))
            else:
                raise ProtocolError(f"int too large for AMQP field: {value}")
        elif isinstance(value, float):
            self._parts.append(b"d" + struct.pack(">d", value))
        elif isinstance(value, str):
            raw = value.encode("utf-8")
            self._parts.append(b"S" + struct.pack(">I", len(raw)) + raw)
        elif isinstance(value, bytes):
            self._parts.append(b"S" + struct.pack(">I", len(value)) + value)
        elif isinstance(value, dict):
            self._parts.append(b"F")
            self.table(value)
        else:
            raise ProtocolError(f"unsupported table value type {type(value)}")

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    """Sequential decoder over one frame payload."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise ProtocolError("truncated frame payload")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def octet(self) -> int:
        return self._take(1)[0]

    def short(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def long(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def longlong(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def shortstr(self) -> str:
        return self._take(self.octet()).decode("utf-8")

    def longstr(self) -> bytes:
        return self._take(self.long())

    def table(self) -> dict[str, Any]:
        payload = self.longstr()
        sub = Reader(payload)
        out: dict[str, Any] = {}
        while sub._pos < len(sub._data):
            # NB: assignment evaluates the RHS first, so the key must be
            # read in its own statement
            key = sub.shortstr()
            out[key] = sub._field_value()
        return out

    def _field_value(self) -> Any:
        # the full RabbitMQ field-type set: peers and the broker itself
        # attach headers (x-death on dead-lettered messages carries arrays
        # and timestamps), so the consume path must read all of them
        kind = self._take(1)
        if kind == b"t":
            return bool(self.octet())
        if kind == b"b":
            return struct.unpack(">b", self._take(1))[0]
        if kind == b"B":
            return self.octet()
        if kind == b"s":
            return struct.unpack(">h", self._take(2))[0]
        if kind == b"u":
            return self.short()
        if kind == b"I":
            return struct.unpack(">i", self._take(4))[0]
        if kind == b"i":
            return self.long()
        if kind == b"l":
            return struct.unpack(">q", self._take(8))[0]
        if kind == b"f":
            return struct.unpack(">f", self._take(4))[0]
        if kind == b"d":
            return struct.unpack(">d", self._take(8))[0]
        if kind == b"D":  # decimal: scale octet + int32 value
            scale = self.octet()
            return struct.unpack(">i", self._take(4))[0] / (10**scale)
        if kind == b"S":
            return self.longstr().decode("utf-8", "replace")
        if kind == b"x":
            return self.longstr()
        if kind == b"A":
            payload = self.longstr()
            sub = Reader(payload)
            items = []
            while sub._pos < len(sub._data):
                items.append(sub._field_value())
            return items
        if kind == b"T":
            return struct.unpack(">Q", self._take(8))[0]
        if kind == b"F":
            return self.table()
        if kind == b"V":
            return None
        raise ProtocolError(f"unsupported field type {kind!r}")

    @property
    def remaining(self) -> int:
        return len(self._data) - self._pos


# --------------------------------------------------------------------------
# frames
# --------------------------------------------------------------------------


class Frame(NamedTuple):
    # NamedTuple, not dataclass: Frame construction is the per-frame unit of
    # work in the parse hot loop and tuple.__new__ is ~2x cheaper than a
    # dataclass __init__
    type: int
    channel: int
    payload: bytes

    def serialize(self) -> bytes:
        return (
            struct.pack(">BHI", self.type, self.channel, len(self.payload))
            + self.payload
            + bytes([FRAME_END])
        )


def method_frame(channel: int, class_method: tuple[int, int], args: bytes = b"") -> Frame:
    cid, mid = class_method
    return Frame(FRAME_METHOD, channel, struct.pack(">HH", cid, mid) + args)


#: basic-properties flag bits (AMQP 0-9-1 §4.2.6.1); properties are
#: serialized in descending flag-bit order
_FLAG_CONTENT_TYPE = 1 << 15
_FLAG_CONTENT_ENCODING = 1 << 14
_FLAG_HEADERS = 1 << 13
_FLAG_DELIVERY_MODE = 1 << 12
DELIVERY_PERSISTENT = 2


def header_frame(
    channel: int,
    class_id: int,
    body_size: int,
    delivery_mode: int | None = None,
    headers: dict[str, Any] | None = None,
) -> Frame:
    # weight=0; the beholder path sets delivery-mode=2 so messages survive
    # a broker restart alongside the durable queues they sit in, and an
    # optional headers table (trace-context propagation)
    flags = 0
    props = Writer()
    if headers:
        flags |= _FLAG_HEADERS
        props.table(headers)
    if delivery_mode is not None:
        flags |= _FLAG_DELIVERY_MODE
        props.octet(delivery_mode)
    payload = (
        struct.pack(">HHQH", class_id, 0, body_size, flags) + props.getvalue()
    )
    return Frame(FRAME_HEADER, channel, payload)


def parse_basic_header(payload: bytes) -> tuple[int, dict[str, Any]]:
    """Parse a content-header frame payload -> (body_size, headers table).

    Decodes the property subset peers may send ahead of the headers table
    (content-type/encoding) so the table offset is right; properties after
    delivery-mode are ignored — nothing downstream reads them.
    """
    reader = Reader(payload)
    reader.short()  # class id
    reader.short()  # weight
    body_size = reader.longlong()
    flags = reader.short()
    if flags & _FLAG_CONTENT_TYPE:
        reader.shortstr()
    if flags & _FLAG_CONTENT_ENCODING:
        reader.shortstr()
    headers: dict[str, Any] = {}
    if flags & _FLAG_HEADERS:
        try:
            headers = reader.table()
        except (ProtocolError, UnicodeDecodeError):
            # headers are optional metadata; a table with a field type from
            # a future spec revision — or a non-UTF-8 key from a foreign
            # client — must not kill the connection (the body size above is
            # already parsed, so delivery proceeds)
            headers = {}
    return body_size, headers


def body_frames(channel: int, body: bytes, frame_max: int) -> list[Frame]:
    # frame_max bounds the whole frame; 8 bytes overhead (7 header + 1 end)
    chunk = max(1, frame_max - 8)
    return [
        Frame(FRAME_BODY, channel, body[i : i + chunk])
        for i in range(0, len(body), chunk)
    ]


def heartbeat_frame() -> Frame:
    return Frame(FRAME_HEARTBEAT, 0, b"")


def parse_method(frame: Frame) -> tuple[tuple[int, int], Reader]:
    reader = Reader(frame.payload)
    cid = reader.short()
    mid = reader.short()
    return (cid, mid), reader


def bad_frame_offset(err: ValueError) -> int | None:
    """The bad frame's start offset from a scanner's ValueError — the
    ONE place that knows how backends report it. The Python-side
    scanners attach it structurally (``err.offset``); the C-API
    extension reports it only in its documented message format
    ("... at buffer offset N", the same across backends), which the
    regex fallback covers."""
    offset = getattr(err, "offset", None)
    if offset is not None:
        return int(offset)
    import re

    m = re.search(r"offset (\d+)$", str(err))
    return int(m.group(1)) if m else None


class FrameParser:
    """Incremental byte-stream -> frame parser.

    The default walks frames in Python (the per-message path's parser;
    the batched ingest path scans through
    :class:`~beholder_tpu_torch.mq.ingest.BatchFeed` instead).
    ``use_native=True`` builds the native scanner at first use (raising
    with the compiler's output when that fails) and binds it. Every
    backend leaves the buffer starting AT a bad frame when it raises
    :class:`ProtocolError`."""

    def __init__(self, use_native: bool = False):
        self._buf = bytearray()
        self._ext = None
        if use_native:
            from . import _native

            _native.build()
            self._ext = _native.ext_scan  # bound once; feed stays lean

    def feed(self, data: bytes) -> list[Frame]:
        self._buf.extend(data)
        if self._ext is None:
            return self._feed_python()
        try:
            frames, consumed = self._ext(self._buf, Frame)
        except ValueError as err:
            self._raise_bad_frame(err)
        del self._buf[:consumed]
        return frames

    def _raise_bad_frame(self, err: ValueError):
        """Normalize post-error buffer state across backends: the native
        scanner raises WITHOUT consuming the good frames before the bad
        one, while the pure-Python walk consumes as it goes. It reports
        the bad frame's start offset — trim up to it so both backends
        leave the buffer starting AT the bad frame."""
        msg = str(err)
        offset = bad_frame_offset(err)
        if offset is not None:
            del self._buf[:offset]
            # the reported offset described the PRE-trim buffer; the
            # retained buffer now starts at the bad frame
            msg += " (buffer trimmed; the bad frame is now at offset 0)"
        raise ProtocolError(msg) from None

    def _feed_python(self) -> list[Frame]:
        buf = self._buf
        frames = []
        pos, n = 0, len(buf)
        try:
            while n - pos >= 7:
                ftype, channel, size = struct.unpack_from(">BHI", buf, pos)
                end = pos + 7 + size
                if n < end + 1:
                    break
                if buf[end] != FRAME_END:
                    raise ProtocolError(
                        f"bad frame end 0x{buf[end]:02x} "
                        f"(type={ftype} channel={channel} size={size})"
                    )
                frames.append(Frame(ftype, channel, bytes(buf[pos + 7:end])))
                pos = end + 1
        finally:
            del buf[:pos]
        return frames
