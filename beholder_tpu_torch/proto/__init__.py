"""The ``api`` protobuf messages, as a proto3 wire codec written by hand.

The port's counterpart of the reference's ``proto/`` (``api.proto`` and
its generated ``api_pb2``), without ``google.protobuf``: three messages and
two enums, with the registry the consumers use (``load``, ``decode``,
``encode``, ``enum_to_string``, ``string_to_enum``).

- ``TelemetryStatus(mediaId=1: string, status=2: TelemetryStatusEntry)``;
- ``TelemetryProgress(mediaId=1, status=2, progress=3: int32, host=4:
  string)``;
- ``Media(id=1, name=2, creator=3: CreatorType, creatorId=4,
  metadataId=5, status=6: TelemetryStatusEntry)``;
- ``TelemetryStatusEntry`` QUEUED..ERRORED = 0..5, ``CreatorType`` API=0,
  TRELLO=1.

Encoding is the canonical proto3 one: fields in number order, default
values left out, a negative int32 or enum as a ten-byte varint. Decoding
follows the reference's parser where parsers differ: unknown fields of
every wire type are skipped (groups to their matching end, at most 100
deep), a known field sent with another wire type is an unknown field, the
last occurrence of a field wins, a varint takes at most ten bytes (bits
past the 64th dropped), a tag at most five and below 2**32, an int32 or
enum keeps the low 32 bits of its varint, enums are open, and a ``string``
must be valid UTF-8. Anything else raises :class:`DecodeError`. Unknown
fields are not kept.
"""

from __future__ import annotations

from typing import Any

_MASK64 = (1 << 64) - 1
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
#: the reference parser's limit on nested groups
_MAX_GROUP_DEPTH = 100

WIRE_VARINT, WIRE_FIXED64, WIRE_LEN, WIRE_START, WIRE_END, WIRE_FIXED32 = 0, 1, 2, 3, 4, 5


class DecodeError(Exception):
    """Bytes that are not a valid encoding of the message."""


class EnumType:
    """A proto enum: ``Name(value)``, ``Value(name)``, ``keys()``,
    ``values()``, ``items()`` and one attribute per value."""

    def __init__(self, name: str, values: dict[str, int]):
        self.name = name
        self._by_name = dict(values)
        self._by_value = {v: k for k, v in reversed(values.items())}
        for key, value in values.items():
            setattr(self, key, value)

    def Name(self, number: int) -> str:
        try:
            return self._by_value[number]
        except (KeyError, TypeError):
            raise ValueError(
                f"Enum {self.name} has no name defined for value {number!r}"
            ) from None

    def Value(self, name: str) -> int:
        try:
            return self._by_name[name]
        except (KeyError, TypeError):
            raise ValueError(
                f"Enum {self.name} has no value defined for name {name!r}"
            ) from None

    def keys(self) -> list[str]:
        return list(self._by_name)

    def values(self) -> list[int]:
        return list(self._by_name.values())

    def items(self) -> list[tuple[str, int]]:
        return list(self._by_name.items())


TelemetryStatusEntry = EnumType(
    "TelemetryStatusEntry",
    {"QUEUED": 0, "DOWNLOADING": 1, "CONVERTING": 2, "UPLOADING": 3,
     "DEPLOYED": 4, "ERRORED": 5},
)
CreatorType = EnumType("CreatorType", {"API": 0, "TRELLO": 1})

_STRING, _INT32 = "string", "int32"


def _varint(value: int) -> bytes:
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(data: bytes, pos: int, end: int, max_bytes: int = 10) -> tuple[int, int]:
    value = shift = 0
    for _ in range(max_bytes):
        if pos >= end:
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value & _MASK64, pos
        shift += 7
    raise ValueError("varint too long")


def _to_int32(value: int) -> int:
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value & 0x80000000 else value


class Message:
    """Base of the three messages. Subclasses set ``FULL_NAME`` and
    ``_FIELDS``: ``(number, name, kind, enum or None)`` in number order."""

    FULL_NAME = ""
    _FIELDS: tuple = ()
    __slots__ = ()

    def __init__(self, **fields: Any):
        for _number, name, kind, _enum in self._FIELDS:
            object.__setattr__(self, name, "" if kind == _STRING else 0)
        for name, value in fields.items():
            setattr(self, name, value)

    def __setattr__(self, name: str, value: Any) -> None:
        for _number, fname, kind, enum in self._FIELDS:
            if fname == name:
                object.__setattr__(self, name, _check(kind, enum, value))
                return
        raise ValueError(f'Protocol message {type(self).__name__} has no "{name}" field.')

    # -- protobuf message API the port uses ---------------------------------
    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(
                f"Parameter to CopyFrom() must be instance of same class: expected "
                f"{type(self).__name__} got {type(other).__name__}."
            )
        for _number, name, _kind, _enum in self._FIELDS:
            object.__setattr__(self, name, getattr(other, name))

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for number, name, kind, _enum in self._FIELDS:
            value = getattr(self, name)
            if not value:
                continue
            if kind == _STRING:
                raw = value.encode("utf-8")
                out += _varint(number << 3 | WIRE_LEN) + _varint(len(raw)) + raw
            else:
                out += _varint(number << 3 | WIRE_VARINT) + _varint(value)
        return bytes(out)

    def ParseFromString(self, data: bytes) -> int:
        """Replace every field with the decoding of ``data``; returns its
        length. Raises :class:`DecodeError` on an invalid encoding."""
        values = _decode_fields(type(self), bytes(data))
        for _number, name, kind, _enum in self._FIELDS:
            object.__setattr__(self, name, values.get(name, "" if kind == _STRING else 0))
        return len(data)

    def __eq__(self, other: object) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, f[1]) == getattr(other, f[1]) for f in self._FIELDS)

    def __repr__(self) -> str:
        set_fields = ", ".join(
            f"{f[1]}={getattr(self, f[1])!r}" for f in self._FIELDS if getattr(self, f[1])
        )
        return f"{type(self).__name__}({set_fields})"


def _check(kind: str, enum: EnumType | None, value: Any) -> Any:
    """The reference's field-assignment checks: a ``str`` for a string, an
    int in int32 range for an int32 or enum (an enum also takes a name)."""
    if kind == _STRING:
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(
                f"{value!r} has type {type(value).__name__}, but expected one of: bytes, str"
            )
        return value
    if enum is not None and isinstance(value, str):
        return enum.Value(value)
    if not isinstance(value, int):
        raise TypeError(
            f"{value!r} has type {type(value).__name__}, but expected one of: int"
        )
    if not _INT32_MIN <= value <= _INT32_MAX:
        raise ValueError(f"Value out of range: {value}")
    return int(value)


def _skip_group(data: bytes, pos: int, end: int, number: int, depth: int) -> int:
    """Skip an unknown group's contents up to its matching end tag."""
    if depth > _MAX_GROUP_DEPTH:
        raise ValueError("groups nested too deep")
    while True:
        tag, pos = _read_varint(data, pos, end, max_bytes=5)
        if tag > 0xFFFFFFFF or tag >> 3 == 0:
            raise ValueError("bad tag")
        wire = tag & 7
        if wire == WIRE_END:
            if tag >> 3 != number:
                raise ValueError("mismatched end group")
            return pos
        pos = _skip(data, pos, end, tag, depth)


def _skip(data: bytes, pos: int, end: int, tag: int, depth: int) -> int:
    wire = tag & 7
    if wire == WIRE_VARINT:
        return _read_varint(data, pos, end)[1]
    if wire == WIRE_FIXED64:
        pos += 8
    elif wire == WIRE_FIXED32:
        pos += 4
    elif wire == WIRE_LEN:
        length, pos = _read_varint(data, pos, end)
        if length > end - pos:
            raise ValueError("length past the end")
        pos += length
    elif wire == WIRE_START:
        return _skip_group(data, pos, end, tag >> 3, depth + 1)
    else:  # an end group with no start, or wire types 6 and 7
        raise ValueError("bad wire type")
    if pos > end:
        raise ValueError("truncated fixed field")
    return pos


def _decode_fields(cls: type, data: bytes) -> dict[str, Any]:
    try:
        return _decode(cls, data)
    except (ValueError, IndexError):
        raise DecodeError(f"Error parsing message with type '{cls.FULL_NAME}'") from None


def _decode(cls: type, data: bytes) -> dict[str, Any]:
    known = cls._BY_NUMBER
    values: dict[str, Any] = {}
    pos, end = 0, len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos, end, max_bytes=5)
        if tag > 0xFFFFFFFF or tag >> 3 == 0:
            raise ValueError("bad tag")
        field = known.get(tag)
        if field is None:  # unknown number, or a known one with another wire type
            pos = _skip(data, pos, end, tag, 0)
            continue
        name, kind = field
        if kind == _STRING:
            length, pos = _read_varint(data, pos, end)
            if length > end - pos:
                raise ValueError("length past the end")
            values[name] = data[pos:pos + length].decode("utf-8")
            pos += length
        else:
            raw, pos = _read_varint(data, pos, end)
            values[name] = _to_int32(raw)
    return values


def _message(full_name: str, fields: tuple) -> type:
    """A :class:`Message` subclass with ``fields`` as its slots."""
    short = full_name.rsplit(".", 1)[1]
    wire = {_STRING: WIRE_LEN, _INT32: WIRE_VARINT}
    return type(short, (Message,), {
        "__slots__": tuple(f[1] for f in fields),
        "__module__": __name__,
        "FULL_NAME": full_name,
        "_FIELDS": fields,
        "_BY_NUMBER": {f[0] << 3 | wire[f[2]]: (f[1], f[2]) for f in fields},
    })


TelemetryStatus = _message("api.TelemetryStatus", (
    (1, "mediaId", _STRING, None),
    (2, "status", _INT32, TelemetryStatusEntry),
))
TelemetryProgress = _message("api.TelemetryProgress", (
    (1, "mediaId", _STRING, None),
    (2, "status", _INT32, TelemetryStatusEntry),
    (3, "progress", _INT32, None),
    (4, "host", _STRING, None),
))
Media = _message("api.Media", (
    (1, "id", _STRING, None),
    (2, "name", _STRING, None),
    (3, "creator", _INT32, CreatorType),
    (4, "creatorId", _STRING, None),
    (5, "metadataId", _STRING, None),
    (6, "status", _INT32, TelemetryStatusEntry),
))

#: Full-name registry, mirroring ``proto.load('api.<Name>')``.
_MESSAGES: dict[str, type] = {
    cls.FULL_NAME: cls for cls in (TelemetryStatus, TelemetryProgress, Media)
}
_ENUMS = {"TelemetryStatusEntry": TelemetryStatusEntry, "CreatorType": CreatorType}


def load(full_name: str) -> type:
    """Look up a message class by full name, e.g. ``api.TelemetryStatus``."""
    try:
        return _MESSAGES[full_name]
    except KeyError:
        raise KeyError(
            f"unknown message type {full_name!r}; known: {sorted(_MESSAGES)}"
        ) from None


def decode(message_cls: type, data: bytes) -> Message:
    """Parse wire bytes into a message instance."""
    msg = message_cls()
    msg.ParseFromString(data)
    return msg


def encode(msg: Message) -> bytes:
    """Serialize a message (the producer side, for tests and tools)."""
    return msg.SerializeToString()


def enum_to_string(_scope: Any, enum_name: str, value: int) -> str:
    """Enum value -> name, e.g. ``4 -> 'DEPLOYED'``. The first argument
    (the message class the reference's call sites pass) is ignored: the
    enums are package-level."""
    return _ENUMS[enum_name].Name(value)


def string_to_enum(_scope: Any, enum_name: str, name: str) -> int:
    """Enum name -> value, e.g. ``'TRELLO' -> 1``."""
    return _ENUMS[enum_name].Value(name)
