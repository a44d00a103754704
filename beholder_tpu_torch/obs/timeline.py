"""Request-level timelines folded out of the flight-recorder stream.

The port's own copy of the reference's ``obs/timeline.py`` (host-side
Python; it never reads the device). The flight recorder answers where an
engine step's wall went; an operator pages on the request. This module
folds the events the batcher and the cluster already emit (claim,
prefix_lookup, admit, prefill, transfer, tick/wave, verify, readback,
retire, and the failover recovery, drop and deadline instants) into one
lifecycle record per request: queue wait, TTFT, per-token TPOT, and a
per-request phase attribution whose sums reconcile with the recorder's
wall.

Per-request attribution rides the recorder-only instants ``req.claim``,
``req.retire`` and ``req.recovered``. A round slice is shared by every
request open in the same trace, so its wall is split evenly across them
(a slice with a ``slot`` arg that matches exactly one open request is
charged to it alone). Splitting conserves duration, so ``sum(phases) +
unattributed == the recorder wall`` exactly.

Request identity: the cluster router annotates its requests with a global
``gid`` (stable across failover recovery passes, so a recovered request's
second claim lands on the same timeline as a new leg); a bare batcher run
falls back to ``(trace_id, rid)``.

On the card an ``admit`` round's event ends when the host has enqueued
its work, not when the token exists on the device, so the TTFT folded
here is host time (the serving loops add no synchronising call for it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

#: slices excluded from per-request attribution: ``device_wait`` is
#: NESTED inside admit/verify rounds (charging it would double-count
#: its parent — same rule as roofline.attribution_summary)
_NESTED_SLICES = frozenset({"device_wait"})

#: per-request lifecycle instants (recorder-only; never attributed as
#: phase wall — they are markers, not work)
_REQ_EVENTS = frozenset({"req.claim", "req.retire", "req.recovered"})


def _key_of(event: dict[str, Any]):
    """A request event's identity: the router-annotated global ``gid``
    when present, else (trace_id, rid) — unique per scheduler call."""
    args = event.get("args", {})
    if args.get("gid") is not None:
        return args["gid"]
    return (event.get("trace_id"), args.get("rid"))


@dataclass
class _Leg:
    """One claim→retire stretch on one engine; a recovered request has
    one leg per (re-)admission."""

    claim_us: int
    trace_id: str | None
    slot: int | None = None
    first_token_us: int | None = None
    retire_us: int | None = None

    def open_at(self, ts_us: float) -> bool:
        end = self.retire_us if self.retire_us is not None else float("inf")
        return self.claim_us <= ts_us <= end

    def overlaps(self, start_us: float, end_us: float) -> bool:
        end = self.retire_us if self.retire_us is not None else float("inf")
        return self.claim_us <= end_us and start_us <= end


@dataclass
class RequestTimeline:
    """One request's reconstructed lifecycle.

    - ``queue_wait_s``: intake-queue residency (stamped at claim by the
      ``beholder_intake_wait_seconds`` path; 0.0 for call-with-a-list
      serving that never queued)
    - ``ttft_s``: first claim → end of the admit round that produced
      the request's first forecast token (prefill IS first-token here);
      for a recovered request this spans the failure + re-admission,
      so recovery cost sits on the critical path it actually delayed
    - ``tpot_s``: mean per-token wall AFTER the first token
      (``(retire - first_token) / (tokens - 1)``)
    - ``phases``: seconds of round wall attributed to this request per
      phase name (tick/verify/admit/prefill/transfer/...), the
      even-split partition described in the module docstring
    - ``hops``: the request's cross-worker legs — disaggregated
      prefill, page-granular transfer, failover recovery — in event
      order
    - ``legs``: claim→retire stretches (> 1 means the request was
      recovered onto another shard mid-flight); ``recovery_s`` is the
      wall between the first and last claim (0.0 unrecovered)
    """

    key: Any
    queue_wait_s: float = 0.0
    horizon: int = 0
    prefix_tokens: int = 0
    tokens: int = 0
    outcome: str = "incomplete"
    #: tenant id from the claim instant (control subsystem); None for
    #: an untenanted request
    tenant: str | None = None
    ttft_s: float | None = None
    tpot_s: float | None = None
    recovery_s: float = 0.0
    phases: dict[str, float] = field(default_factory=dict)
    hops: list[dict[str, Any]] = field(default_factory=list)
    legs: list[_Leg] = field(default_factory=list)
    #: set between a ``req.recovered`` marker and the recovery
    #: re-claim: a request can retire ON the failed shard before the
    #: batch failure voids the whole serve (its results were never
    #: delivered) — the re-claim must REOPEN this record as a new leg,
    #: not fork a fresh request
    recovery_pending: bool = False

    @property
    def recovered(self) -> bool:
        return len(self.legs) > 1

    @property
    def wall_s(self) -> float:
        """First claim → retire (the request's whole engine residency)."""
        if not self.legs or self.legs[-1].retire_us is None:
            return 0.0
        return (self.legs[-1].retire_us - self.legs[0].claim_us) / 1e6

    def to_dict(self) -> dict[str, Any]:
        return {
            "key": (
                self.key if isinstance(self.key, (str, int, float))
                else list(self.key)
            ),
            "tenant": self.tenant,
            "queue_wait_s": round(self.queue_wait_s, 6),
            "horizon": self.horizon,
            "prefix_tokens": self.prefix_tokens,
            "tokens": self.tokens,
            "outcome": self.outcome,
            "ttft_s": (
                round(self.ttft_s, 6) if self.ttft_s is not None else None
            ),
            "tpot_s": (
                round(self.tpot_s, 6) if self.tpot_s is not None else None
            ),
            "wall_s": round(self.wall_s, 6),
            "recovered": self.recovered,
            "recovery_s": round(self.recovery_s, 6),
            "legs": len(self.legs),
            "phases_s": {
                name: round(s, 6) for name, s in sorted(self.phases.items())
            },
            "hops": list(self.hops),
        }


@dataclass
class TimelineReport:
    """The fold's output: per-request timelines plus the wall
    reconciliation (``attributed_s + unattributed_s == wall_s`` by
    construction — splitting conserves duration)."""

    timelines: list[RequestTimeline]
    wall_s: float = 0.0          # total top-level slice wall in the stream
    attributed_s: float = 0.0    # wall charged to some request
    unattributed_s: float = 0.0  # wall with no request open (idle rounds)

    def by_key(self) -> dict[Any, RequestTimeline]:
        return {t.key: t for t in self.timelines}


def build_timelines(events: Iterable[dict[str, Any]]) -> TimelineReport:
    """Fold one flight-recorder event stream (``FlightRecorder.events()``
    or a parsed JSONL export — chronological, as the ring keeps it)
    into per-request timelines. Events from runs whose ``req.claim``
    fell off the ring yield no timeline (their wall lands in
    ``unattributed_s``) — the fold degrades with the ring, it never
    guesses."""
    all_records: list[RequestTimeline] = []
    #: key -> the record still in flight under that key. Keys can
    #: legitimately RECUR across scheduler calls (run()'s rids restart
    #: at 0; without a tracer every call shares trace None), so a claim
    #: for a key whose previous lifecycle already RETIRED starts a
    #: fresh record — only an unretired lifecycle (a failover recovery
    #: re-claim) extends the existing one
    records: dict[Any, RequestTimeline] = {}
    slices: list[dict[str, Any]] = []

    for event in events:
        name = event.get("name")
        args = event.get("args", {})
        if name == "req.claim":
            key = _key_of(event)
            record = records.get(key)
            if record is None or (
                not record.recovery_pending
                and record.legs
                and record.legs[-1].retire_us is not None
            ):
                record = RequestTimeline(key=key)
                records[key] = record
                all_records.append(record)
            record.recovery_pending = False
            record.legs.append(
                _Leg(
                    claim_us=int(event.get("ts_us", 0)),
                    trace_id=event.get("trace_id"),
                    slot=args.get("slot"),
                )
            )
            if args.get("queue_wait_s"):
                record.queue_wait_s = float(args["queue_wait_s"])
            if args.get("horizon"):
                record.horizon = int(args["horizon"])
            if args.get("prefix_tokens"):
                record.prefix_tokens = int(args["prefix_tokens"])
            if args.get("tenant") is not None:
                record.tenant = args["tenant"]
        elif name == "req.retire":
            record = records.get(_key_of(event))
            if record is None or not record.legs:
                continue
            leg = record.legs[-1]
            leg.retire_us = int(event.get("ts_us", 0))
            record.tokens = int(args.get("tokens", 0))
            record.outcome = args.get("outcome", "ok")
        elif name == "req.recovered":
            record = records.get(_key_of(event))
            if record is not None:
                record.recovery_pending = True
                record.hops.append(
                    {
                        "type": "recovery",
                        "worker": args.get("worker"),
                        "reason": args.get("reason"),
                    }
                )
        elif name == "req.dropped":
            # the failover layer lost this request (recovery_limit /
            # shard_down): close its record — or book a fresh
            # zero-token one if it never claimed (drain-time drops of
            # queued work) — so the loss has a timeline
            key = _key_of(event)
            record = records.get(key)
            if record is None or not (
                record.recovery_pending
                or (record.legs and record.legs[-1].retire_us is None)
            ):
                record = RequestTimeline(key=key)
                records[key] = record
                all_records.append(record)
            record.outcome = "dropped"
            record.recovery_pending = False
            record.hops.append(
                {"type": "dropped", "reason": args.get("reason")}
            )
        elif name == "deadline_exceeded" and args.get("stage") == "claim":
            # expired while QUEUED: no req.claim/req.retire ever comes.
            # Touch an existing record only if its lifecycle is still
            # open (a recovery re-queue whose budget ran out) — a
            # COMPLETED record that merely shares a recurring key must
            # not have its outcome rewritten; everyone else gets a
            # fresh zero-token record so the expiry is on the books
            key = _key_of(event)
            record = records.get(key)
            if record is None or not (
                record.recovery_pending
                or (record.legs and record.legs[-1].retire_us is None)
            ):
                record = RequestTimeline(key=key)
                records[key] = record
                all_records.append(record)
            record.outcome = "deadline_exceeded"
            record.recovery_pending = False
            if args.get("queue_wait_s"):
                record.queue_wait_s = float(args["queue_wait_s"])
        elif (
            event.get("ph") == "X"
            and name not in _NESTED_SLICES
            and name not in _REQ_EVENTS
        ):
            slices.append(event)

    # -- attribution pass: split each round slice across the requests
    # it served (trace-matched, lifecycle-overlapping; a slot-tagged
    # slice matching exactly one open request is charged to it alone)
    wall_s = attributed_s = unattributed_s = 0.0
    legs_by_trace: dict[str | None, list[tuple[RequestTimeline, _Leg]]] = {}
    for record in all_records:
        for leg in record.legs:
            legs_by_trace.setdefault(leg.trace_id, []).append((record, leg))
    #: per-trace end of the PREVIOUS readback slice: a readback charges
    #: only legs claimed after it, so when a trace id recurs across
    #: scheduler calls (no tracer -> every call is trace None) one
    #: run's delivery wall never lands on an earlier run's requests
    last_readback_end: dict[str | None, int] = {}

    for event in slices:
        ts = int(event.get("ts_us", 0))
        dur_us = int(event.get("dur_us", 0))
        dur_s = dur_us / 1e6
        wall_s += dur_s
        end = ts + dur_us
        args = event.get("args", {})
        name = event["name"]
        if name == "readback":
            # the end-of-run packed readback happens AFTER the slots
            # retired, but it is the wall that DELIVERS those requests'
            # tokens (on an async runtime it carries the device wait):
            # charge it to every request of its run, not to nobody
            floor = last_readback_end.get(event.get("trace_id"), -1)
            candidates = [
                (record, leg)
                for record, leg in legs_by_trace.get(
                    event.get("trace_id"), ()
                )
                if floor < leg.claim_us <= end
            ]
            last_readback_end[event.get("trace_id")] = end
        else:
            candidates = [
                (record, leg)
                for record, leg in legs_by_trace.get(
                    event.get("trace_id"), ()
                )
                if leg.overlaps(ts, end)
            ]
        slot = args.get("slot")
        if slot is not None:
            slotted = [
                (r, leg) for r, leg in candidates if leg.slot == slot
            ]
            if len(slotted) == 1:
                candidates = slotted
        if name in ("prefill", "transfer") and len(candidates) == 1:
            record = candidates[0][0]
            hop = {"type": name}
            for field_name in ("worker", "src", "dst"):
                if field_name in args:
                    hop[field_name] = args[field_name]
            record.hops.append(hop)
        if not candidates:
            unattributed_s += dur_s
            continue
        share = dur_s / len(candidates)
        for record, leg in candidates:
            record.phases[name] = record.phases.get(name, 0.0) + share
            if (
                name in ("admit", "wave")
                and leg.first_token_us is None
                and leg.claim_us <= end
            ):
                # prefill produces the request's first forecast token,
                # so the admit round's END is first-token time
                leg.first_token_us = end
        attributed_s += dur_s

    # -- derived latencies
    for record in all_records:
        if not record.legs:
            continue
        first = record.legs[0]
        last = record.legs[-1]
        record.recovery_s = max(0.0, (last.claim_us - first.claim_us) / 1e6)
        if last.first_token_us is not None:
            record.ttft_s = (last.first_token_us - first.claim_us) / 1e6
            if last.retire_us is not None and record.tokens > 1:
                record.tpot_s = max(
                    0.0, (last.retire_us - last.first_token_us) / 1e6
                ) / (record.tokens - 1)

    ordered = sorted(
        all_records, key=lambda r: r.legs[0].claim_us if r.legs else 0
    )
    return TimelineReport(
        timelines=ordered,
        wall_s=wall_s,
        attributed_s=attributed_s,
        unattributed_s=unattributed_s,
    )


def phase_walls(
    events: Iterable[dict[str, Any]],
) -> dict[str, dict[str, float]]:
    """Aggregate phase wall per ``(phase, worker)`` plus per kernel
    family (the unit a diff of two runs compares). Returns ``{"phases": {"<phase>@<worker>": seconds},
    "families": {"<family>@<worker>": seconds}}``; worker-less events
    (single-engine runs) aggregate under ``all``. Nested slices
    (``device_wait``) are excluded exactly like the per-request
    attribution above, so the totals reconcile with the same wall."""
    phases: dict[str, float] = {}
    families: dict[str, float] = {}
    for event in events:
        if event.get("ph", "X") != "X":
            continue
        name = str(event.get("name", ""))
        if name in _NESTED_SLICES:
            continue
        args = event.get("args", {}) or {}
        worker = str(args.get("worker") or "all")
        dur_s = int(event.get("dur_us", 0)) / 1e6
        key = f"{name}@{worker}"
        phases[key] = phases.get(key, 0.0) + dur_s
        family = args.get("family")
        if family:
            fkey = f"{family}@{worker}"
            families[fkey] = families.get(fkey, 0.0) + dur_s
    return {"phases": phases, "families": families}
