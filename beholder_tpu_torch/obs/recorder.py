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
trace-event JSON (:func:`beholder_tpu_torch.tools.trace_export.chrome_trace`,
loadable in Perfetto).

:meth:`FlightRecorder.bind_metrics` registers the drop-pressure series
and :meth:`FlightRecorder.route` serves the live ring (``GET
/debug/flight``). A bound :class:`~beholder_tpu_torch.obs.flightplane.
FlightPlane` stamps the ring's identity (:meth:`FlightRecorder.set_meta`,
rendered as a ``flight.meta`` header line) and arms cross-worker edge ids
(:meth:`FlightRecorder.next_edge`); unbound, ``next_edge`` returns None and
a dump is what it was without the plane.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any

from beholder_tpu_torch.tracing import current_trace_id

DEFAULT_RING_SIZE = 4096


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
        self._dropped_counter = None
        self._high_water_gauge = None
        self._seq = 0
        self._ring: deque[dict[str, Any]] = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        #: ring identity and clock anchor (set by the flight plane through
        #: :meth:`set_meta`); rendered as a ``flight.meta`` header line in
        #: :meth:`jsonl`, never stored in the ring
        self.meta: dict[str, Any] | None = None
        #: cross-worker edge ids, armed by the flight plane; unarmed,
        #: :meth:`next_edge` returns None and the cluster's edge events
        #: stay off
        self._edge_prefix: str | None = None
        self._edge_seq = 0
        #: called with each event after it lands in the ring, outside the
        #: lock; a listener that raises is swallowed
        self._listeners: list = []

    def add_listener(self, listener) -> None:
        """Subscribe ``listener(event_dict)`` to every recorded event."""
        self._listeners.append(listener)

    def set_meta(self, **meta: Any) -> None:
        """Attach ring identity (worker name, pid) and a monotonic/epoch
        clock anchor, the header the flight plane's merge aligns skew on.
        Merged into any meta set before."""
        if self.meta is None:
            self.meta = {}
        self.meta.update(meta)

    def arm_edges(self, prefix: str) -> None:
        """Arm cross-worker edge ids; ``prefix`` namespaces them per worker
        so two workers never mint the same edge."""
        self._edge_prefix = prefix

    def next_edge(self) -> str | None:
        """Mint a cross-worker edge id, or None when no flight plane is
        bound (the cluster's send/receive events key off this None)."""
        if self._edge_prefix is None:
            return None
        with self._lock:
            self._edge_seq += 1
            return f"{self._edge_prefix}-{self._edge_seq}"

    def bind_metrics(self, registry) -> None:
        """Register the drop-pressure series on ``registry``:
        ``beholder_flight_dropped_total`` (events lost to ring saturation)
        and ``beholder_flight_ring_high_water`` (the largest occupancy)."""
        from beholder_tpu_torch.metrics import get_or_create

        self._dropped_counter = get_or_create(
            registry, "counter", "beholder_flight_dropped_total",
            "Flight-recorder events dropped to ring saturation",
        )
        self._high_water_gauge = get_or_create(
            registry, "gauge", "beholder_flight_ring_high_water",
            "Max flight-recorder ring occupancy observed",
        )
        if self.dropped:
            self._dropped_counter.inc(self.dropped)
        self._high_water_gauge.set(float(self.high_water))

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
            dropped_now = len(self._ring) == self.ring_size
            if dropped_now:
                self.dropped += 1
            self._ring.append(event)
            if len(self._ring) > self.high_water:
                self.high_water = len(self._ring)
                if self._high_water_gauge is not None:
                    self._high_water_gauge.set(float(self.high_water))
        if dropped_now and self._dropped_counter is not None:
            self._dropped_counter.inc()
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

    def jsonl(self, since: int | None = None, limit: int | None = None,
              cursor: bool = False) -> str:
        """The ring as JSON lines, one event a line. When the flight plane
        has stamped ring identity a ``flight.meta`` header line leads.
        ``cursor=True`` (the poll route) appends a ``flight.cursor`` line
        whose ``next_since`` is the seq a poller passes back as
        ``?since=``."""
        head = ""
        if self.meta is not None:
            head = json.dumps({"name": "flight.meta", "ph": "M", **self.meta}, default=str) + "\n"
        events = self.events(since, limit)
        tail = ""
        if cursor:
            next_since = events[-1].get("seq", 0) if events else (since or 0)
            tail = json.dumps(
                {"name": "flight.cursor", "ph": "M", "next_since": next_since}
            ) + "\n"
        return head + "".join(json.dumps(event, default=str) + "\n" for event in events) + tail

    def dump(self, path: str | None = None) -> str:
        """Write the ring as JSON lines to ``path`` (default:
        ``export_path``); returns the path written."""
        path = path or self.export_path
        if not path:
            raise ValueError("no path given and no export_path configured")
        with open(path, "w") as f:
            f.write(self.jsonl())
        return path

    def route(self):
        """An httpd Route serving the live ring as JSONL — the ``GET
        /debug/flight`` endpoint. Accepts ``?since=<seq>`` and
        ``limit=<n>``; the response ends with a ``flight.cursor`` line."""

        def flight_route(query=None):
            since, limit = parse_cursor(query)
            body = self.jsonl(since=since, limit=limit, cursor=True).encode()
            return 200, "application/x-ndjson", body

        flight_route.wants_query = True
        return flight_route


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

