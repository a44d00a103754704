"""The cluster-wide flight plane: N process-local rings, one timeline.

The port's own copy of the reference's ``obs/flightplane.py`` (host-side
Python, no device work). A serving run spans ingest wire, prefill workers,
decode shards, recovery legs and egress clients; this is the cross-worker
layer over the process's :class:`~beholder_tpu_torch.obs.recorder.
FlightRecorder`:

- **Identity and clock anchor.** :meth:`FlightPlane.bind` stamps the bound
  recorder's ring with the worker name, pid and a paired monotonic/epoch
  clock reading (``flight.meta``), which :func:`merge` uses to undo
  per-worker wall-clock skew.
- **Edge ids.** Binding arms :meth:`FlightRecorder.next_edge`; the
  cluster's send/receive sites (the transfer handoff, the drain restock,
  the memory fabric's ``fabric`` and ``mirror`` page hops) then tag each
  cross-worker hop with one shared edge id: a ``<base>.send`` instant in
  the sending ring paired with the receiving ring's event. Matched pairs
  refine skew alignment (a receive never precedes its send) and render as
  Perfetto flow arrows (:mod:`beholder_tpu_torch.tools.trace_export`).
- **Merge.** :func:`merge` folds N rings into one causally ordered
  timeline: coarse alignment on clock anchors, causality on the matched
  edge pairs, a deterministic sort, a monotone merged ``seq``. Served live
  at ``GET /debug/cluster-flight`` and dumped at shutdown when
  ``export_path`` is set.

Off by default (``instance.observability.flight_plane.*``): nothing binds,
:meth:`FlightRecorder.next_edge` returns None, no header goes on any wire,
and serving output, wire bytes and the /metrics exposition are unchanged.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any

from .recorder import FlightRecorder, parse_cursor

#: edge-tagged send instants end with this suffix; the paired receive is
#: the event in another ring carrying the same ``args["edge"]``
SEND_SUFFIX = ".send"


class Ring:
    """One worker's flight ring: identity meta and its event list."""

    __slots__ = ("worker", "meta", "events")

    def __init__(self, worker: str, events: list[dict[str, Any]],
                 meta: dict[str, Any] | None = None):
        self.worker = worker
        self.meta = dict(meta or {})
        self.meta.setdefault("worker", worker)
        self.events = events


class MergedTimeline:
    """The output of :func:`merge`: one causally ordered event list plus
    the numbers an artifact's ``flight_plane`` block records."""

    __slots__ = ("events", "summary", "offsets_us")

    def __init__(self, events: list[dict[str, Any]], summary: dict[str, float],
                 offsets_us: dict[str, int]):
        self.events = events
        self.summary = summary
        self.offsets_us = offsets_us

    def jsonl(self, since: int | None = None, limit: int | None = None) -> str:
        """The merged timeline as JSON lines, led by a ``flight.plane``
        header carrying the per-worker offsets applied, the merge summary
        and the ``next_since`` poll cursor (the last merged seq served).
        ``since``/``limit`` cut on the merged ``seq``."""
        events = self.events
        if since is not None:
            events = [e for e in events if e.get("seq", 0) > since]
        if limit is not None and limit >= 0:
            events = events[:limit]
        next_since = events[-1].get("seq", 0) if events else (since or 0)
        head = json.dumps(
            {"name": "flight.plane", "ph": "M", "offsets_us": self.offsets_us,
             "next_since": next_since, **self.summary},
            default=str,
        )
        return head + "\n" + "".join(json.dumps(event, default=str) + "\n" for event in events)


class FlightPlane:
    """Cross-worker trace context and ring merge for one process.
    ``worker`` names this process's track in merged output (default
    ``hostname:pid``); ``export_path`` is where the merged timeline dumps
    at shutdown."""

    def __init__(self, worker: str | None = None, export_path: str | None = None):
        self.worker = worker or f"{socket.gethostname()}:{os.getpid()}"
        self.export_path = export_path
        self.recorder: FlightRecorder | None = None

    def bind(self, recorder: FlightRecorder) -> FlightRecorder:
        """Arm ``recorder`` as this plane's ring: stamp identity and the
        monotonic/epoch clock anchor, arm edge-id minting."""
        recorder.set_meta(
            worker=self.worker,
            pid=os.getpid(),
            epoch_us=int(time.time() * 1e6),
            mono_us=int(time.monotonic() * 1e6),
        )
        recorder.arm_edges(self.worker)
        self.recorder = recorder
        return recorder

    def wire_headers(self, headers: dict[str, Any] | None = None) -> dict[str, Any] | None:
        """The AMQP write side: merge the active span's W3C ``traceparent``
        into an outgoing message's headers table (a publisher calls
        ``publish(..., headers=plane.wire_headers(headers))``). With no
        active span the input passes through untouched. Explicit caller
        headers win on conflict."""
        from beholder_tpu_torch.tracing import active_context, to_traceparent

        ctx = active_context()
        if ctx is None:
            return headers
        merged: dict[str, Any] = {"traceparent": to_traceparent(ctx)}
        if headers:
            merged.update(headers)
        return merged

    def rings(self) -> list[Ring]:
        """The bound ring split per worker (:func:`split_rings`)."""
        if self.recorder is None:
            return []
        return split_rings(self.recorder.events(), default_worker=self.worker,
                           meta=self.recorder.meta)

    def merged(self) -> MergedTimeline:
        """The merge of everything the bound ring holds now."""
        return merge(self.rings())

    def route(self):
        """A route for ``GET /debug/cluster-flight``: the live merged
        timeline as JSONL, with ``/debug/flight``'s ``?since=``/``limit``
        poll cursor (cut on the merged seq)."""

        def cluster_flight_route(query=None):
            since, limit = parse_cursor(query)
            body = self.merged().jsonl(since=since, limit=limit).encode()
            return 200, "application/x-ndjson", body

        cluster_flight_route.wants_query = True
        return cluster_flight_route

    def dump(self, path: str | None = None) -> str:
        """Write the merged timeline as JSONL to ``path`` (default
        ``export_path``); returns the path written."""
        path = path or self.export_path
        if not path:
            raise ValueError("no path given and no export_path configured")
        with open(path, "w") as f:
            f.write(self.merged().jsonl())
        return path


def split_rings(events: list[dict[str, Any]], default_worker: str,
                meta: dict[str, Any] | None = None) -> list[Ring]:
    """Partition one process ring into per-worker rings by each event's
    ``args["worker"]`` (events without one stay on ``default_worker``). A
    single-process cluster, every shard in one process, thereby runs the
    same N-ring merge a multi-process deployment feeds from one exported
    ring a process; each split ring inherits the process's clock anchor."""
    by_worker: dict[str, list[dict[str, Any]]] = {}
    for event in events:
        worker = event.get("args", {}).get("worker") or default_worker
        by_worker.setdefault(str(worker), []).append(event)
    base = dict(meta or {})
    return [Ring(worker, evs, meta={**base, "worker": worker})
            for worker, evs in sorted(by_worker.items())]


def load_rings(paths: list[str]) -> list[Ring]:
    """Read exported rings (``FlightRecorder.dump`` JSONL, one file a
    process) back as :class:`Ring` objects, the offline path into
    :func:`merge`."""
    rings = []
    for path in paths:
        meta: dict[str, Any] = {}
        events: list[dict[str, Any]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if obj.get("name") == "flight.meta":
                    meta = {k: v for k, v in obj.items() if k not in ("name", "ph")}
                else:
                    events.append(obj)
        worker = str(meta.get("worker") or os.path.basename(path))
        rings.append(Ring(worker, events, meta=meta))
    return rings


def _edge_pairs(rings: list[Ring]) -> list[tuple[str, str, dict[str, Any], str, dict[str, Any]]]:
    """Matched cross-worker hops: ``(edge_id, src_worker, send_event,
    dst_worker, recv_event)`` for every edge id with both a ``*.send``
    instant and a receiving event."""
    sends: dict[str, tuple[str, dict[str, Any]]] = {}
    recvs: dict[str, tuple[str, dict[str, Any]]] = {}
    for ring in rings:
        for event in ring.events:
            edge = event.get("args", {}).get("edge")
            if not edge:
                continue
            if str(event.get("name", "")).endswith(SEND_SUFFIX):
                sends[str(edge)] = (ring.worker, event)
            else:
                recvs[str(edge)] = (ring.worker, event)
    pairs = []
    for edge in sorted(sends.keys() & recvs.keys()):
        (src, send), (dst, recv) = sends[edge], recvs[edge]
        pairs.append((edge, src, send, dst, recv))
    return pairs


def merge(rings: list[Ring]) -> MergedTimeline:
    """Fold N per-worker rings into one causally ordered timeline.

    Deterministic: the reference clock is the lexicographically smallest
    worker name; every other ring gets (1) a coarse offset from its clock
    anchor (``epoch_us - mono_us`` against the reference's), then (2) a
    causal correction from matched edge pairs: a receive observed before
    its own send shifts its ring forward by the worst violation. Events
    merge sorted by aligned timestamp (ties on original seq, then worker)
    and are re-stamped with a monotone merged ``seq``."""
    rings = sorted(rings, key=lambda r: r.worker)
    if not rings:
        return MergedTimeline(
            [], {"workers": 0.0, "merged_events": 0.0, "flow_edges": 0.0,
                 "max_abs_skew_us": 0.0}, {})

    def anchor(ring: Ring) -> int | None:
        meta = ring.meta
        if "epoch_us" in meta and "mono_us" in meta:
            return int(meta["epoch_us"]) - int(meta["mono_us"])
        return None

    ref = anchor(rings[0])
    offsets: dict[str, int] = {}
    for ring in rings:
        a = anchor(ring)
        offsets[ring.worker] = (a - ref) if (a is not None and ref is not None) else 0

    pairs = _edge_pairs(rings)
    # causal pass in worker order: when ring R is corrected every ring
    # before it is fixed, so a chain of hops settles in one sweep
    for ring in rings[1:]:
        worst = 0
        for _, src, send, dst, recv in pairs:
            if dst != ring.worker:
                continue
            send_end = int(send["ts_us"]) + int(send.get("dur_us", 0)) - offsets.get(src, 0)
            recv_ts = int(recv["ts_us"]) - offsets[ring.worker]
            if recv_ts - send_end < worst:
                worst = recv_ts - send_end
        if worst < 0:
            # the receive sits `worst` µs before its send: pull the ring's
            # clock back so it lands at or after the send's end
            offsets[ring.worker] += worst

    merged: list[dict[str, Any]] = []
    for ring in rings:
        off = offsets[ring.worker]
        for event in ring.events:
            out = dict(event)
            out["ts_us"] = int(event["ts_us"]) - off
            args = dict(event.get("args", {}))
            args.setdefault("worker", ring.worker)
            out["args"] = args
            merged.append(out)
    merged.sort(key=lambda e: (e["ts_us"], e.get("seq", 0), e["args"].get("worker", "")))
    for i, event in enumerate(merged):
        event["seq"] = i + 1

    summary = {
        "workers": float(len(rings)),
        "merged_events": float(len(merged)),
        "flow_edges": float(len(pairs)),
        "max_abs_skew_us": float(max((abs(o) for o in offsets.values()), default=0)),
    }
    return MergedTimeline(merged, summary, offsets)


def flight_plane_from_config(config) -> FlightPlane | None:
    """Build the flight plane from ``instance.observability.flight_plane.*``,
    or None when disabled (the default).

    Keys: ``enabled`` (bool), ``worker`` (str, default ``hostname:pid``:
    this process's track in merged timelines), ``export_path`` (str; the
    service dumps the merged timeline there on shutdown)."""
    node = config.get("instance.observability.flight_plane")
    if node is None or not node.get("enabled"):
        return None
    return FlightPlane(worker=node.get("worker"), export_path=node.get("export_path"))
