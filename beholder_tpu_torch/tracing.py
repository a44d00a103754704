"""Distributed tracing: spans, head sampling and text-map propagation.

The port's own copy of the reference's ``tracing.py`` (host-side Python, no
device work), trimmed to what the serving layer uses:

- :class:`SpanContext` is the (trace_id, span_id, parent_id, flags) tuple;
  :func:`inject`/:func:`extract` speak the jaeger text-map format (one
  ``uber-trace-id: {trace:032x}:{span:016x}:{parent:016x}:{flags:x}``
  entry), and :func:`to_traceparent`/:func:`from_traceparent` the W3C
  ``traceparent`` form a :class:`~beholder_tpu_torch.models.serving.Request`
  may carry;
- :class:`Span` records operation, service, start and duration (epoch µs),
  tags and logs; finished spans go to a reporter;
- :class:`InMemoryReporter` collects them, :class:`LogReporter` logs one
  structured line a span and :class:`JsonlReporter` appends jaeger-shaped
  JSON lines; :func:`tracer_from_config` builds the service's tracer from
  ``instance.tracing.*``.

A ``with span:`` block makes the span the active context
(:func:`active_context`, :func:`current_trace_id`): nested spans default to
it as parent, and histogram observations inside the block carry its trace
id (:mod:`beholder_tpu_torch.metrics`). :func:`inject_traceparent` writes
the W3C form into a headers carrier (the flight plane's write side).
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
from secrets import randbits
from typing import Any, Callable

TRACE_HEADER = "uber-trace-id"
#: W3C Trace Context header
W3C_HEADER = "traceparent"
FLAG_SAMPLED = 0x01

#: the span context active in this task/thread, set by ``with span:`` blocks
_ACTIVE: contextvars.ContextVar["SpanContext | None"] = contextvars.ContextVar(
    "beholder_torch_active_span", default=None
)


def active_context() -> "SpanContext | None":
    """The :class:`SpanContext` of the innermost ``with span:`` block."""
    return _ACTIVE.get()


def current_trace_id() -> str | None:
    """The active trace id as a 32-hex string, or None outside any span."""
    ctx = _ACTIVE.get()
    return f"{ctx.trace_id:032x}" if ctx is not None else None


class SpanContext:
    """Immutable identity of one span in one trace."""

    __slots__ = ("trace_id", "span_id", "parent_id", "flags")

    def __init__(
        self, trace_id: int, span_id: int, parent_id: int = 0, flags: int = FLAG_SAMPLED
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.flags = flags

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    def encode(self) -> str:
        return (
            f"{self.trace_id:032x}:{self.span_id:016x}"
            f":{self.parent_id:016x}:{self.flags:x}"
        )

    @classmethod
    def decode(cls, value: str) -> "SpanContext":
        trace_id, span_id, parent_id, flags = value.split(":")
        return cls(int(trace_id, 16), int(span_id, 16), int(parent_id, 16), int(flags, 16))

    def __repr__(self) -> str:
        return f"SpanContext({self.encode()})"


def inject(ctx: SpanContext, carrier: dict) -> dict:
    """Write ``ctx`` into a headers carrier."""
    carrier[TRACE_HEADER] = ctx.encode()
    return carrier


def extract(carrier: dict | None) -> SpanContext | None:
    """Read a :class:`SpanContext` out of a headers carrier; None if absent
    or malformed (a broken upstream header must never kill a consumer).
    Falls back to the W3C ``traceparent`` entry when the jaeger header is
    absent."""
    if not carrier:
        return None
    value = carrier.get(TRACE_HEADER)
    if value:
        try:
            return SpanContext.decode(str(value))
        except (ValueError, AttributeError):
            return None
    w3c = carrier.get(W3C_HEADER)
    if w3c:
        return from_traceparent(str(w3c))
    return None


def to_traceparent(ctx: SpanContext) -> str:
    """Render ``ctx`` as a W3C ``traceparent`` value
    (``00-{trace:032x}-{span:016x}-{flags:02x}``); the parent id does not
    travel."""
    return f"00-{ctx.trace_id:032x}-{ctx.span_id:016x}-{ctx.flags & 0xFF:02x}"


def from_traceparent(value: str) -> SpanContext | None:
    """Parse a W3C ``traceparent`` value; None on malformed input or the
    all-zero trace/span ids the spec marks invalid."""
    try:
        version, trace_hex, span_hex, flags_hex = value.strip().split("-")
        if len(trace_hex) != 32 or len(span_hex) != 16:
            return None
        int(version, 16)
        trace_id = int(trace_hex, 16)
        span_id = int(span_hex, 16)
        flags = int(flags_hex, 16)
    except (ValueError, AttributeError):
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return SpanContext(trace_id, span_id, 0, flags)


def inject_traceparent(ctx: SpanContext, carrier: dict) -> dict:
    """Write the W3C form of ``ctx`` into a headers carrier (the flight
    plane's armed write side)."""
    carrier[W3C_HEADER] = to_traceparent(ctx)
    return carrier


class Span:
    """One timed operation. Finish exactly once; as a context manager it
    tags errors and finishes on the way out."""

    __slots__ = (
        "context", "operation", "service", "start_us", "duration_us", "tags",
        "logs", "_tracer", "_t0_ns", "_activation",
    )

    def __init__(
        self,
        tracer: "Tracer",
        operation: str,
        context: SpanContext,
        tags: dict[str, Any] | None = None,
    ):
        self._tracer = tracer
        self.operation = operation
        self.service = tracer.service
        self.context = context
        self.start_us = int(time.time() * 1e6)  # epoch, for jaeger startTime
        self._t0_ns = time.perf_counter_ns()  # monotonic, for the duration
        self.duration_us: int | None = None
        self.tags: dict[str, Any] = dict(tags or {})
        self.logs: list[dict[str, Any]] = []

    def set_tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def log(self, event: str, **fields: Any) -> "Span":
        self.logs.append({"timestamp_us": int(time.time() * 1e6), "event": event, **fields})
        return self

    def finish(self) -> None:
        if self.duration_us is not None:
            return  # idempotent, like opentracing's
        # a monotonic delta: a clock step between start and finish must not
        # corrupt the duration
        self.duration_us = (time.perf_counter_ns() - self._t0_ns) // 1000
        self._tracer._forget(self)
        self._tracer._report(self)

    @property
    def finished(self) -> bool:
        return self.duration_us is not None

    def __enter__(self) -> "Span":
        self._activation = _ACTIVE.set(self.context)
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        _ACTIVE.reset(self._activation)
        if exc is not None:
            self.set_tag("error", True)
            self.log("error", message=repr(exc))
        self.finish()

    def to_dict(self) -> dict[str, Any]:
        return {
            "traceID": f"{self.context.trace_id:032x}",
            "spanID": f"{self.context.span_id:016x}",
            "parentSpanID": f"{self.context.parent_id:016x}",
            "operationName": self.operation,
            "serviceName": self.service,
            "startTime": self.start_us,
            "duration": self.duration_us,
            "tags": self.tags,
            "logs": self.logs,
        }


class _NoopSpan:
    """Returned for unsampled traces: absorbs the Span API and never
    reaches a reporter."""

    __slots__ = ("context", "_activation")

    def __init__(self, context: SpanContext):
        self.context = context

    def set_tag(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def log(self, event: str, **fields: Any) -> "_NoopSpan":
        return self

    def finish(self) -> None:
        pass

    finished = True

    def __enter__(self) -> "_NoopSpan":
        # an unsampled span still becomes the active context, so spans
        # started inside it inherit its cleared sample flag instead of
        # starting (and sampling anew) a root trace of their own
        self._activation = _ACTIVE.set(self.context)
        return self

    def __exit__(self, *exc_info) -> None:
        _ACTIVE.reset(self._activation)


class InMemoryReporter:
    """Collects finished spans."""

    def __init__(self):
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def report(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def by_operation(self, operation: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.operation == operation]


class LogReporter:
    """One structured log line per finished span."""

    def __init__(self, logger):
        self._logger = logger

    def report(self, span: Span) -> None:
        self._logger.info(
            "span %s %s trace=%032x span=%016x duration_us=%d tags=%s",
            span.service,
            span.operation,
            span.context.trace_id,
            span.context.span_id,
            span.duration_us,
            span.tags,
        )


class JsonlReporter:
    """One jaeger-shaped JSON object per line, append-only."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def report(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class Tracer:
    """Makes spans, samples, reports.

    ``sample_rate`` is probabilistic head sampling: the root span decides,
    children inherit the decision through the flags bit, so a trace is
    never half-reported."""

    def __init__(
        self,
        service: str,
        reporter=None,
        sample_rate: float = 1.0,
        _rand: Callable[[], float] | None = None,
    ):
        self.service = service
        self.reporter = reporter if reporter is not None else InMemoryReporter()
        self.sample_rate = sample_rate
        self._rand = _rand or random.random
        #: unfinished sampled spans, for :meth:`flush`
        self._live: set[Span] = set()
        self._live_lock = threading.Lock()

    def start_span(
        self,
        operation: str,
        child_of: SpanContext | Span | None = None,
        tags: dict[str, Any] | None = None,
    ) -> Span | _NoopSpan:
        parent = getattr(child_of, "context", child_of)
        if parent is None:
            # default to the active ``with span:`` block
            parent = _ACTIVE.get()
        if parent is not None:
            ctx = SpanContext(
                trace_id=parent.trace_id,
                span_id=randbits(64) or 1,
                parent_id=parent.span_id,
                flags=parent.flags,  # inherit the head-sampling decision
            )
        else:
            sampled = self.sample_rate >= 1.0 or self._rand() < self.sample_rate
            ctx = SpanContext(
                trace_id=randbits(128) or 1,
                span_id=randbits(64) or 1,
                parent_id=0,
                flags=FLAG_SAMPLED if sampled else 0,
            )
        if not ctx.sampled:
            return _NoopSpan(ctx)
        span = Span(self, operation, ctx, tags)
        with self._live_lock:
            self._live.add(span)
        return span

    def _forget(self, span: Span) -> None:
        with self._live_lock:
            self._live.discard(span)

    def flush(self) -> int:
        """Finish (and report) every span still open, tagged
        ``flushed_at_shutdown``; returns how many."""
        with self._live_lock:
            open_spans = list(self._live)
        for span in open_spans:
            span.set_tag("flushed_at_shutdown", True)
            span.finish()
        return len(open_spans)

    def _report(self, span: Span) -> None:
        try:
            self.reporter.report(span)
        except Exception:  # noqa: BLE001 - a broken sink must not kill work
            pass


def tracer_from_config(config, logger=None) -> Tracer | None:
    """Build the service tracer from ``instance.tracing.*`` config, or None
    when disabled (the default).

    Keys: ``enabled`` (bool), ``sample_rate`` (float, default 1.0),
    ``jsonl_path`` (str; also via $TRACE_JSONL — when set, spans append
    there instead of the log).
    """
    if not config.get("instance.tracing.enabled"):
        return None
    path = os.environ.get("TRACE_JSONL") or config.get("instance.tracing.jsonl_path")
    if path:
        reporter = JsonlReporter(str(path))
    elif logger is not None:
        reporter = LogReporter(logger)
    else:
        reporter = InMemoryReporter()
    rate = float(config.get("instance.tracing.sample_rate", 1.0))
    return Tracer("beholder", reporter=reporter, sample_rate=rate)
