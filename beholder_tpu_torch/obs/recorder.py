"""The serving flight recorder: a bounded ring of engine phase events.

The port's own copy of the reference's ``obs/recorder.py`` (host-side
Python). Every scheduling phase the
:class:`~beholder_tpu_torch.models.serving.ContinuousBatcher` runs (claim,
admit, draft, tick or wave dispatch, verify, readback, rollback, retire)
lands here as one timed event, plus instant markers for what a histogram
cannot show (prefix-cache lookups, pressure-deferral stalls, spec
accept/rollback outcomes, request claim and retirement).

- **Bounded memory.** The ring is a ``deque(maxlen=ring_size)``: a long
  run keeps the last ``ring_size`` events and counts what fell off
  (``dropped``).
- **Off by default.** ``ContinuousBatcher(flight_recorder=None)`` records
  nothing, and its streams are the same bits either way.
- **Host clocks only.** Recording adds no device read. On the card a
  dispatch phase measures the host's enqueue time; the device's work shows
  in the phase that reads back (``readback``, or the spec loop's nested
  ``device_wait``).
- **Trace-linked.** Each event carries the trace id active when it was
  recorded (:func:`beholder_tpu_torch.tracing.current_trace_id`).

Events export as JSON lines (:meth:`FlightRecorder.dump`) and as Chrome
trace-event JSON (:func:`chrome_trace`, loadable in Perfetto).

Not ported: the flight plane's ring identity and cross-worker edges
(``set_meta``, ``arm_edges``, ``next_edge``), ``bind_metrics`` (the
drop-pressure series), the ``/debug/flight`` HTTP route, and the
cluster's worker tracks and flow arrows in the Chrome export.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any

from beholder_tpu_torch.tracing import current_trace_id

DEFAULT_RING_SIZE = 4096
PROCESS_NAME = "beholder-serving"


class FlightRecorder:
    """Bounded ring buffer of serving phase events.

    ``attributor`` (a :class:`~beholder_tpu_torch.obs.roofline.
    RooflineAttributor`) arms record-time kernel attribution: a dispatch
    event recorded with ``family=``/``flops=`` tags (:meth:`kernel_tags`)
    gets a ``ceiling_frac`` — its achieved fraction of the measured matmul
    ceiling — stamped into its args. ``export_path`` is where :meth:`dump`
    writes by default."""

    def __init__(
        self,
        ring_size: int = DEFAULT_RING_SIZE,
        attributor=None,
        export_path: str | None = None,
    ):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.ring_size = ring_size
        self.attributor = attributor
        self.export_path = export_path
        self.dropped = 0
        #: the largest ring occupancy observed
        self.high_water = 0
        self._seq = 0
        self._ring: deque[dict[str, Any]] = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        #: called with each event after it lands in the ring, outside the
        #: lock; a listener that raises is swallowed
        self._listeners: list = []

    def add_listener(self, listener) -> None:
        """Subscribe ``listener(event_dict)`` to every recorded event."""
        self._listeners.append(listener)

    # -- recording -------------------------------------------------------

    def record(
        self, name: str, ts_s: float, dur_s: float, trace_id: str | None = None, **args: Any
    ) -> None:
        """One complete (``ph="X"``) phase event: epoch start ``ts_s``
        (seconds), host-measured ``dur_s``; ``trace_id`` defaults to the
        active span's. Dispatch events carrying :meth:`kernel_tags` get
        their ``ceiling_frac`` stamped here."""
        if trace_id is None:
            trace_id = current_trace_id()
        if self.attributor is not None and "family" in args and args.get("flops"):
            args["ceiling_frac"] = self.attributor.observe(
                args["family"], float(args["flops"]), dur_s
            )
        self._append({
            "name": name,
            "ph": "X",
            "ts_us": int(ts_s * 1e6),
            "dur_us": int(dur_s * 1e6),
            "trace_id": trace_id,
            "args": args,
        })

    def instant(self, name: str, trace_id: str | None = None, **args: Any) -> None:
        """A zero-duration marker (``ph="i"``); ``trace_id`` defaults to the
        active span's."""
        self._append({
            "name": name,
            "ph": "i",
            "ts_us": int(time.time() * 1e6),
            "trace_id": trace_id if trace_id is not None else current_trace_id(),
            "args": args,
        })

    def kernel_tags(self, family: str, flops: float) -> dict[str, Any]:
        """Tags that mark a dispatch event for roofline attribution: kernel
        ``family`` and the dispatch's estimated FLOPs."""
        return {"family": family, "flops": float(flops)}

    def _append(self, event: dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            if len(self._ring) == self.ring_size:
                self.dropped += 1
            self._ring.append(event)
            self.high_water = max(self.high_water, len(self._ring))
        for listener in self._listeners:
            try:
                listener(event)
            except Exception:  # noqa: BLE001 - observers must not kill serving
                pass

    # -- introspection / export -----------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self, since: int | None = None, limit: int | None = None) -> list[dict[str, Any]]:
        """Snapshot of the ring, oldest first. ``since`` keeps events with
        ``seq > since`` (a poll cursor: seq is monotone over the recorder's
        life); ``limit`` keeps the first N."""
        with self._lock:
            out = list(self._ring)
        if since is not None:
            out = [e for e in out if e.get("seq", 0) > since]
        if limit is not None and limit >= 0:
            out = out[:limit]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def jsonl(self, since: int | None = None, limit: int | None = None) -> str:
        """The ring as JSON lines, one event a line."""
        return "".join(
            json.dumps(event, default=str) + "\n" for event in self.events(since, limit)
        )

    def dump(self, path: str | None = None) -> str:
        """Write the ring as JSON lines to ``path`` (default:
        ``export_path``); returns the path written."""
        path = path or self.export_path
        if not path:
            raise ValueError("no path given and no export_path configured")
        with open(path, "w") as f:
            f.write(self.jsonl())
        return path


def parse_cursor(query) -> tuple[int | None, int | None]:
    """Decode the ``?since=<seq>&limit=<n>`` poll-cursor parameters from a
    ``parse_qs`` dict (or None); malformed values read as absent."""
    since = limit = None
    if query:
        try:
            since = int(query["since"][0])
        except (KeyError, IndexError, ValueError, TypeError):
            since = None
        try:
            limit = int(query["limit"][0])
        except (KeyError, IndexError, ValueError, TypeError):
            limit = None
    return since, limit


#: event names drawn in their own ``failover`` category
FAILOVER_EVENTS = frozenset(
    {"failover", "drain", "heartbeat", "deadline_exceeded", "promote", "standby"}
)


def chrome_trace(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Recorder events as Chrome trace-event JSON (the Perfetto-compatible
    subset): one named track per trace id, untraced events on track 0,
    phase slices (``ph="X"``) with their duration, instants thread-scoped."""
    tid_of: dict[str, int] = {}

    def tid(trace_id: str | None) -> int:
        if not trace_id:
            return 0
        if trace_id not in tid_of:
            tid_of[trace_id] = len(tid_of) + 1
        return tid_of[trace_id]

    trace_events: list[dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": PROCESS_NAME}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "untraced"}},
    ]
    for event in events:
        if event.get("ph") == "M":
            continue
        trace_id = event.get("trace_id")
        out: dict[str, Any] = {
            "name": event["name"],
            "ph": event.get("ph", "X"),
            "ts": int(event.get("ts_us", 0)),
            "pid": 1,
            "tid": tid(trace_id),
            "cat": "failover" if event["name"] in FAILOVER_EVENTS else "serving",
            "args": {**event.get("args", {}), "trace_id": trace_id},
        }
        if out["ph"] == "X":
            out["dur"] = int(event.get("dur_us", 0))
        elif out["ph"] == "i":
            out["s"] = "t"
        trace_events.append(out)
    for trace_id, row in tid_of.items():
        trace_events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": row,
                             "args": {"name": f"trace {trace_id[:12]}"}})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
