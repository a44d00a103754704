"""The port's ``AnalyticsSink`` against the reference's, on the CPU.

Both sinks take the same numpy-seeded stream of ``record(status,
progress)`` calls; every summary must be equal dict for dict (counts and
maxes exact, means rounded to 2 places from the same f32 value: integer
progress sums exactly in both frameworks). Also what
``tests/test_analytics.py:16-39`` covers for the reference: the threshold
flush, an empty flush, a bad threshold, and the log record.
"""

import logging

import numpy as np
import pytest
import torch

from beholder_tpu import proto
from beholder_tpu.analytics import AnalyticsSink as RefSink
from beholder_tpu_torch import csrc
from beholder_tpu_torch.analytics import AnalyticsSink
from beholder_tpu_torch.ops import NUM_STATUSES, STATUS_NAMES

S = proto.TelemetryStatusEntry


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)


def _logger(name: str) -> tuple[logging.Logger, _Records]:
    log = logging.getLogger(f"test_torch_analytics.{name}")
    log.handlers.clear()
    handler = _Records()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    return log, handler


def _stream(seed: int, n: int):
    """A skewed progress stream: most events CONVERTING, some statuses rare."""
    rng = np.random.default_rng(seed)
    statuses = rng.choice(NUM_STATUSES, size=n, p=[0.05, 0.1, 0.6, 0.15, 0.07, 0.03])
    progress = rng.integers(0, 101, size=n)
    return statuses.tolist(), progress.tolist()


def _summaries(handler: _Records) -> list[dict]:
    return [r.fields["aggregate"] for r in handler.records if r.levelno == logging.INFO]


@pytest.mark.parametrize("async_flush", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("flush_every, n", [(4, 23), (64, 1000), (4096, 9000)])
def test_sink_matches_reference(async_flush, flush_every, n):
    statuses, progress = _stream(flush_every + n, n)
    ref_log, ref_records = _logger(f"ref{flush_every}{async_flush}")
    port_log, port_records = _logger(f"port{flush_every}{async_flush}")
    ref = RefSink(flush_every=flush_every, logger=ref_log, async_flush=async_flush)
    port = AnalyticsSink(flush_every=flush_every, logger=port_log, async_flush=async_flush,
                         device="cpu")
    for s, p in zip(statuses, progress):
        assert port.record(s, p) == ref.record(s, p)
        assert port.buffered == ref.buffered
    assert port.flush() == ref.flush()  # the ragged last batch
    ref.drain()
    port.drain()
    want = _summaries(ref_records)
    assert len(want) == -(-n // flush_every)
    assert _summaries(port_records) == want
    assert not [r for r in port_records.records if r.levelno >= logging.WARNING]


def test_sink_flushes_at_threshold():
    sink = AnalyticsSink(flush_every=4, device="cpu")
    assert sink.record(S.CONVERTING, 10) is None
    assert sink.record(S.CONVERTING, 20) is None
    assert sink.record(S.UPLOADING, 90) is None
    summary = sink.record(S.CONVERTING, 30)
    assert summary is not None
    assert sink.buffered == 0
    assert summary["converting"] == {"count": 3, "mean_progress": 20.0, "max_progress": 30.0}
    assert summary["uploading"]["count"] == 1
    assert set(summary) == {"converting", "uploading"}


@pytest.mark.parametrize("async_flush", [False, True], ids=["sync", "async"])
def test_sink_flush_empty_is_noop(async_flush):
    log, records = _logger(f"empty{async_flush}")
    sink = AnalyticsSink(flush_every=4, logger=log, async_flush=async_flush, device="cpu")
    assert sink.flush() is None
    sink.drain()
    assert records.records == []


@pytest.mark.parametrize("flush_every", [0, -1])
def test_sink_rejects_bad_threshold(flush_every):
    with pytest.raises(ValueError):
        AnalyticsSink(flush_every=flush_every, device="cpu")


def test_log_record_message_and_fields():
    log, records = _logger("fields")
    sink = AnalyticsSink(flush_every=3, logger=log, device="cpu")
    sink.record(S.QUEUED, 0)
    sink.record(S.DEPLOYED, 100)
    summary = sink.record(S.DEPLOYED, 51)
    (record,) = records.records
    assert record.getMessage() == "telemetry aggregate"
    assert record.levelno == logging.INFO
    assert record.fields == {"aggregate": summary}
    assert summary == {
        "queued": {"count": 1, "mean_progress": 0.0, "max_progress": 0.0},
        "deployed": {"count": 2, "mean_progress": 75.5, "max_progress": 100.0},
    }


def test_default_logger_is_the_stdlib_analytics_logger():
    assert AnalyticsSink(device="cpu")._log is logging.getLogger("analytics")


def test_async_failure_logs_a_warning_and_the_worker_survives(monkeypatch):
    log, records = _logger("failure")
    sink = AnalyticsSink(flush_every=2, logger=log, async_flush=True, device="cpu")
    real = sink._aggregate
    calls = []

    def flaky(statuses, progress):
        calls.append(len(statuses))
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real(statuses, progress)

    monkeypatch.setattr(sink, "_aggregate", flaky)
    for s, p in [(S.CONVERTING, 10), (S.CONVERTING, 20), (S.UPLOADING, 30), (S.UPLOADING, 50)]:
        sink.record(s, p)
    sink.drain()
    warnings = [r.getMessage() for r in records.records if r.levelno == logging.WARNING]
    assert warnings == ["analytics aggregation failed: RuntimeError('device lost')"]
    assert _summaries(records) == [
        {"uploading": {"count": 2, "mean_progress": 40.0, "max_progress": 50.0}}
    ]


def test_status_names_follow_the_proto_enum():
    assert list(STATUS_NAMES) == list(S.keys())
    assert [S.Value(n) for n in STATUS_NAMES] == list(range(NUM_STATUSES))


def test_sink_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnalyticsSink()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnalyticsSink(flush_every=8, async_flush=True)


def test_cpu_sink_builds_no_kernel(monkeypatch):
    def refuse(*names):
        raise AssertionError(f"a kernel build was asked for: {names}")

    monkeypatch.setattr(csrc, "build", refuse)
    monkeypatch.setattr(csrc, "load", refuse)
    sink = AnalyticsSink(flush_every=8, device="cpu")
    statuses, progress = _stream(1, 8)
    for s, p in zip(statuses[:-1], progress[:-1]):
        assert sink.record(s, p) is None
    assert sink.record(statuses[-1], progress[-1])
    assert "aggregate" not in csrc._loaded
