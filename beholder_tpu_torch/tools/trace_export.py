"""Export flight-recorder events as Chrome trace-event JSON.

The port's own copy of the reference's ``tools/trace_export.py``. The
:class:`~beholder_tpu_torch.obs.FlightRecorder` ring (or its
:meth:`~beholder_tpu_torch.obs.FlightRecorder.dump` JSONL, or a flight
plane's merged timeline) becomes one ``{"traceEvents": [...]}`` document
loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:
per-round phase slices, instant markers, and each dispatch's kernel family
and achieved fraction of the measured matmul ceiling in its args.

Rows: each distinct trace id gets its own named track; untraced events
share track 0; an event whose args carry a ``worker`` goes on that worker's
track. Cross-worker hops of a flight-plane timeline render as flow arrows.

CLI::

    python -m beholder_tpu_torch.tools.trace_export events.jsonl -o trace.json
"""

from __future__ import annotations

import json
from typing import Any

PROCESS_NAME = "beholder-serving"

#: cluster-worker tracks start here, far above any count of trace ids in
#: one ring, so the two track namespaces never collide
WORKER_TID_BASE = 100_000

#: failover-subsystem events (worker failures, drain migrations, missed
#: heartbeats, deadline retirements, the fabric's standby spawn and
#: promotion), drawn in their own ``failover`` category
FAILOVER_EVENTS = frozenset(
    {"failover", "drain", "heartbeat", "deadline_exceeded", "promote", "standby"}
)


def load_events(path: str) -> list[dict[str, Any]]:
    """Read a :meth:`FlightRecorder.dump` JSONL file, one event a line;
    blank and corrupt lines are skipped (a ring dumped mid-crash must still
    export)."""
    events: list[dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and "name" in obj:
                events.append(obj)
    return events


def chrome_trace(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Recorder events as Chrome trace-event JSON (the Perfetto-compatible
    subset): one named track per trace id, untraced events on track 0,
    phase slices (``ph="X"``) with their duration, instants thread-scoped.
    An event whose args carry a ``worker`` (the cluster's route, transfer,
    prefill, claim and tick events, the failover events) goes on that
    worker's own track instead (``worker decode-0``, ``worker prefill-0``,
    ...), so a disaggregated run reads as parallel worker lanes. Header
    lines (``ph="M"``: ``flight.meta``, ``flight.plane``) are skipped, and
    a flight plane's cross-worker hops become flow arrows
    (:func:`_flow_events`)."""
    tid_of: dict[str, int] = {}
    worker_tid_of: dict[str, int] = {}

    def tid(trace_id: str | None) -> int:
        if not trace_id:
            return 0
        if trace_id not in tid_of:
            tid_of[trace_id] = len(tid_of) + 1
        return tid_of[trace_id]

    def worker_tid(worker: str) -> int:
        if worker not in worker_tid_of:
            worker_tid_of[worker] = WORKER_TID_BASE + len(worker_tid_of)
        return worker_tid_of[worker]

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
        worker = (event.get("args") or {}).get("worker")
        out: dict[str, Any] = {
            "name": event["name"],
            "ph": event.get("ph", "X"),
            "ts": int(event.get("ts_us", 0)),
            "pid": 1,
            "tid": worker_tid(str(worker)) if worker else tid(trace_id),
            "cat": "failover" if event["name"] in FAILOVER_EVENTS else "serving",
            "args": {**event.get("args", {}), "trace_id": trace_id},
        }
        if out["ph"] == "X":
            out["dur"] = int(event.get("dur_us", 0))
        elif out["ph"] == "i":
            out["s"] = "t"
        trace_events.append(out)
    trace_events.extend(_flow_events(events, worker_tid))
    for trace_id, row in tid_of.items():
        trace_events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": row,
                             "args": {"name": f"trace {trace_id[:12]}"}})
    for worker, row in worker_tid_of.items():
        trace_events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": row,
                             "args": {"name": f"worker {worker}"}})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def _flow_events(events: list[dict[str, Any]], worker_tid) -> list[dict[str, Any]]:
    """Cross-worker flow arrows (``ph="s"`` start and ``ph="f"`` finish
    pairs sharing an ``id``) for a flight-plane timeline:

    - **edge pairs**: a ``<base>.send`` instant and the receiving event
      tagged with the same ``args["edge"]`` (transfer handoffs, drain
      restocks, fabric and mirror page hops) become one arrow from the
      sender's track to the receiver's;
    - **recovery legs**: a ``req.recovered`` instant chains to the same
      gid's next ``req.claim``, so a failover re-admission reads as an
      arrow from the dying worker to where the request landed.

    Events without edges or gids produce nothing: a ring without the plane
    exports as it did before."""
    flows: list[dict[str, Any]] = []

    def arrow(flow_id: str, name: str, src_ev, dst_ev) -> None:
        src_worker = (src_ev.get("args") or {}).get("worker")
        dst_worker = (dst_ev.get("args") or {}).get("worker")
        if not src_worker or not dst_worker:
            return
        flows.append({
            "name": name, "ph": "s", "id": flow_id, "pid": 1,
            "tid": worker_tid(str(src_worker)),
            "ts": int(src_ev.get("ts_us", 0)), "cat": "flow",
        })
        flows.append({
            "name": name, "ph": "f", "bp": "e", "id": flow_id, "pid": 1,
            "tid": worker_tid(str(dst_worker)),
            "ts": int(dst_ev.get("ts_us", 0)), "cat": "flow",
        })

    sends: dict[str, dict[str, Any]] = {}
    recvs: dict[str, dict[str, Any]] = {}
    recovered: list[dict[str, Any]] = []
    claims: dict[str, list[dict[str, Any]]] = {}
    for event in events:
        args = event.get("args") or {}
        edge = args.get("edge")
        name = str(event.get("name", ""))
        if edge:
            (sends if name.endswith(".send") else recvs)[str(edge)] = event
        if name == "req.recovered" and args.get("gid"):
            recovered.append(event)
        elif name == "req.claim" and args.get("gid"):
            claims.setdefault(str(args["gid"]), []).append(event)
    for edge in sorted(sends.keys() & recvs.keys()):
        send, recv = sends[edge], recvs[edge]
        base = str(send["name"]).removesuffix(".send")
        arrow(str(edge), base, send, recv)
    for k, rec in enumerate(recovered):
        gid = str((rec.get("args") or {})["gid"])
        rec_ts = int(rec.get("ts_us", 0))
        after = [c for c in claims.get(gid, ()) if int(c.get("ts_us", 0)) >= rec_ts]
        if after:
            nxt = min(after, key=lambda c: int(c.get("ts_us", 0)))
            arrow(f"rec-{gid}-{k}", "recovery", rec, nxt)
    return flows


def export(events_or_path, out_path: str) -> str:
    """Write the Chrome trace for ``events_or_path`` (a list of recorder
    events, a :class:`FlightRecorder`, or a dump's JSONL path) to
    ``out_path``; returns the path."""
    if isinstance(events_or_path, str):
        events = load_events(events_or_path)
    elif hasattr(events_or_path, "events"):
        events = events_or_path.events()
    else:
        events = list(events_or_path)
    with open(out_path, "w") as f:
        json.dump(chrome_trace(events), f, indent=1)
        f.write("\n")
    return out_path


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description=(
            "Convert a flight-recorder JSONL dump to Chrome trace-event "
            "JSON (load the output in https://ui.perfetto.dev)"
        )
    )
    parser.add_argument("events", help="FlightRecorder.dump() JSONL path")
    parser.add_argument("-o", "--out", default=None,
                        help="output path (default: <events>.trace.json)")
    args = parser.parse_args(argv)
    out = args.out or f"{args.events.removesuffix('.jsonl')}.trace.json"
    events = load_events(args.events)
    export(events, out)
    slices = sum(1 for e in events if e.get("ph", "X") == "X")
    instants = len(events) - slices
    print(f"wrote {out}: {slices} phase slices, {instants} instant markers from {args.events}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
