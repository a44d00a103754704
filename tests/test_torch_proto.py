"""The port's hand-written proto3 codec against the reference's generated
``api_pb2`` (google.protobuf): byte-equal encodings, and on every input
the same outcome from both parsers — both raise, or both give equal
fields."""

import numpy as np
import pytest

from beholder_tpu import proto as ref
from beholder_tpu_torch import proto as port
from beholder_tpu_torch.ops import STATUS_NAMES

MESSAGES = ["TelemetryStatus", "TelemetryProgress", "Media"]
TEXTS = ["", "m1", "card-1", "Bebop", "é", "日本語", "\x00", "enc-1", "x" * 200, "🎞"]
INTS = [0, 1, 4, 5, 9, 55, 100, 127, 128, 300, -1, -2**31, 2**31 - 1, 16384]


def _fields(cls, msg):
    return tuple(getattr(msg, f[1]) for f in getattr(port, cls)._FIELDS)


def _parse(mod, cls, data):
    try:
        msg = getattr(mod, cls)()
        msg.ParseFromString(data)
    except Exception as err:  # noqa: BLE001 - the outcome is what is compared
        return "raises", type(err).__name__
    return "ok", _fields(cls, msg)


def _agree(cls, data):
    want, got = _parse(ref, cls, data), _parse(port, cls, data)
    assert got == want, (cls, data)
    if want[0] == "raises":
        assert got == ("raises", "DecodeError")


def _random_kwargs(rng, cls):
    out = {}
    for _number, name, kind, _enum in getattr(port, cls)._FIELDS:
        if rng.random() < 0.3:
            continue  # left at its default
        out[name] = (TEXTS[rng.integers(len(TEXTS))] if kind == "string"
                     else INTS[rng.integers(len(INTS))])
    return out


def _random_messages(seed, n):
    rng = np.random.default_rng(seed)
    for i in range(n):
        cls = MESSAGES[i % 3]
        yield cls, _random_kwargs(rng, cls)


#: the reference service tests' message bodies (tests/test_service.py:59-76)
SERVICE_BODIES = [
    ("TelemetryStatus", dict(mediaId="m1", status=1)),
    ("TelemetryStatus", dict(mediaId="unknown", status=1)),
    ("TelemetryStatus", dict(mediaId="m2", status=4)),
    ("TelemetryProgress", dict(mediaId="m1", status=2, progress=55, host="enc-1")),
    ("TelemetryProgress", dict(mediaId="m1", status=1, progress=10, host="")),
    ("TelemetryProgress", dict(mediaId="m2", status=3, progress=42, host="")),
    ("Media", dict(id="m1", name="Bebop", creator=1, creatorId="card-1",
                   metadataId="42", status=0)),
]


@pytest.mark.parametrize("cls, kwargs", SERVICE_BODIES)
def test_service_bodies_encode_byte_equal_and_decode_equal(cls, kwargs):
    data = getattr(ref, cls)(**kwargs).SerializeToString()
    assert port.encode(getattr(port, cls)(**kwargs)) == data
    assert _fields(cls, port.decode(port.load(f"api.{cls}"), data)) == _parse(ref, cls, data)[1]
    _agree(cls, b"\xff\xff\xff not a proto")  # tests/test_service.py:239-244


def test_random_messages_encode_byte_equal():
    for cls, kwargs in _random_messages(seed=0, n=600):
        want = getattr(ref, cls)(**kwargs).SerializeToString()
        got = getattr(port, cls)(**kwargs).SerializeToString()
        assert got == want, (cls, kwargs)
        _agree(cls, want)


def test_every_truncation_decodes_alike():
    for cls, kwargs in _random_messages(seed=1, n=120):
        data = getattr(ref, cls)(**kwargs).SerializeToString()
        for cut in range(len(data)):
            _agree(cls, data[:cut])


def test_random_bytes_decode_alike():
    rng = np.random.default_rng(2)
    for i in range(6000):
        data = rng.integers(0, 256, size=rng.integers(0, 24)).astype(np.uint8).tobytes()
        _agree(MESSAGES[i % 3], data)


#: pieces where parsers differ: every wire type on known and unknown field
#: numbers, groups (nested, mismatched, unterminated), invalid and
#: overlong UTF-8, overlong varints and tags, lengths past the end
PIECES = [b"\x00", b"\x80", b"\xff", b"\x7f", b"\x0a", b"\x12", b"\x10", b"\x18", b"\x1a",
          b"\x0b", b"\x0c", b"\x43", b"\x44", b"\x09", b"\x0d", b"\x15", b"\x1d", b"\x0f",
          b"\xed\xa0\x80", b"\xc3\xa9", b"\xc0\x80", b"\x80\x80\x80\x80\x10",
          b"\xff\xff\xff\xff\x0f", b"\x81\x80\x80\x80\x80\x80\x80\x80\x80\x02",
          b"\x98\x80\x80\x80\x80\x00", b"\x01", b"\x02", b"a"]


def test_structured_fuzz_decodes_alike():
    rng = np.random.default_rng(3)
    for i in range(6000):
        parts = rng.integers(0, len(PIECES), size=rng.integers(0, 12))
        _agree(MESSAGES[i % 3], b"".join(PIECES[j] for j in parts))


@pytest.mark.parametrize("data", [
    b"\x18" + b"\xff" * 9 + b"\x01",          # ten-byte varint: -1
    b"\x18" + b"\xff" * 9 + b"\x7f",          # bits past the 64th dropped
    b"\x18" + b"\xff" * 10 + b"\x01",         # eleven bytes
    b"\x18\x80\x80\x80\x80\x10",              # 2**32: int32 keeps the low bits
    b"\x0a\x02\xff\xfe", b"\x0a\x03\xed\xa0\x80", b"\x0a\x02\xc0\x80",  # bad UTF-8
    b"\x0a\x05ab",                            # length past the end
    b"\x0a\x81\x80\x80\x80\x80\x80\x80\x80\x80\x02a",  # length masked to 64 bits
    b"\x1a\x01\x05", b"\x12\x01\x04", b"\x15\x01\x00\x00\x00",  # known field, other wire type
    b"\x1b\x1c", b"\x43\x08\x01\x44", b"\x43\x4c", b"\x1c", b"\x0b",  # groups
    b"\x43" * 100 + b"\x44" * 100, b"\x43" * 101 + b"\x44" * 101,   # group depth limit
    b"\x00", b"\x07", b"\x98\x80\x80\x80\x00\x05", b"\x98\x80\x80\x80\x80\x00\x05",  # tags
    b"\x10\x09", b"\x0a\x01a\x0a\x01b",       # open enum; the last occurrence wins
])
def test_parser_edges_decode_alike(data):
    for cls in MESSAGES:
        _agree(cls, data)


def test_enums_match_the_reference():
    for name in ("TelemetryStatusEntry", "CreatorType"):
        want, got = getattr(ref, name), getattr(port, name)
        assert got.keys() == list(want.keys())
        assert got.values() == list(want.values())
        assert got.items() == list(want.items())
        for key in want.keys():
            assert getattr(got, key) == want.Value(key)
            assert ref.string_to_enum(None, name, key) == port.string_to_enum(None, name, key)
        for value in want.values():
            assert port.enum_to_string(None, name, value) == ref.enum_to_string(None, name, value)
        for call, arg in (("enum_to_string", 9), ("string_to_enum", "NOPE")):
            with pytest.raises(ValueError) as want_err:
                getattr(ref, call)(None, name, arg)
            with pytest.raises(ValueError) as got_err:
                getattr(port, call)(None, name, arg)
            assert str(got_err.value) == str(want_err.value)
    assert list(STATUS_NAMES) == port.TelemetryStatusEntry.keys()


def test_field_assignment_checks_match_the_reference():
    for kwargs in (dict(progress=2**31), dict(progress=-2**31 - 1), dict(progress="5"),
                   dict(mediaId=5), dict(bogus=1), dict(status=2**31)):
        with pytest.raises((TypeError, ValueError)) as want:
            ref.TelemetryProgress(**kwargs)
        with pytest.raises((TypeError, ValueError)) as got:
            port.TelemetryProgress(**kwargs)
        assert got.type is want.type, kwargs
    for kwargs in (dict(status="DEPLOYED"), dict(status=99)):
        want = ref.TelemetryProgress(**kwargs)
        assert _fields("TelemetryProgress", port.TelemetryProgress(**kwargs)) == \
            _fields("TelemetryProgress", want)


def test_registry_and_copy():
    for cls in MESSAGES:
        assert port.load(f"api.{cls}") is getattr(port, cls)
    with pytest.raises(KeyError):
        port.load("api.Nope")
    row = port.Media(id="m1", name="Bebop", creator=1, creatorId="c", status=4)
    clone = port.Media()
    clone.CopyFrom(row)
    assert clone == row and clone is not row
    clone.status = 2
    assert row.status == 4
    with pytest.raises(TypeError):
        clone.CopyFrom(port.TelemetryStatus())
    msg = port.decode(port.TelemetryStatus, port.encode(port.TelemetryStatus(mediaId="a", status=4)))
    assert (msg.mediaId, msg.status) == ("a", 4)
