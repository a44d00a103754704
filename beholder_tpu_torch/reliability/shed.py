"""Load shedding: bounded intake for the serving scheduler.

The port's own copy of the reference's ``reliability/shed.py`` (host-side
Python, whole). Unbounded queueing turns overload into unbounded latency
and memory; admission control turns it into an explicit, cheap rejection
the caller can act on. :class:`IntakeQueue` is the policy object: a
bounded pending queue (depth and, optionally, total page cost) with an
accept/shed outcome per offer.
:class:`~beholder_tpu_torch.models.serving.ContinuousBatcher` puts one in
front of its schedulers (``submit()`` / ``run_pending()``) and reports
sheds on ``beholder_serving_shed_total{reason}``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, NamedTuple

from beholder_tpu_torch.metrics import get_or_create

#: buckets for the time-in-queue histogram: intake waits span
#: sub-ms drains to seconds of backlog under pressure
WAIT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)

#: per-process counter behind IntakeQueue's default names
_default_names = itertools.count()

#: shed reasons (the rejection outcome's vocabulary)
SHED_QUEUE_FULL = "queue_full"
SHED_COST_BACKLOG = "cost_backlog"
SHED_OVERSIZED = "oversized"
#: failover: the request would fit SOME shard, but every shard that
#: could hold it is down/draining — surviving capacity is insufficient
SHED_SHARD_DOWN = "shard_down"


class Admission(NamedTuple):
    """The explicit outcome of one intake offer."""

    accepted: bool
    reason: str | None = None  # set when shed


class LoadShedError(RuntimeError):
    """Raised by callers that prefer an exception to an outcome value."""

    def __init__(self, reason: str):
        super().__init__(f"request shed: {reason}")
        self.reason = reason


class IntakeQueue:
    """Bounded FIFO intake with explicit shedding.

    - ``max_depth`` bounds the number of pending requests.
    - ``max_cost`` (optional) bounds the SUM of per-request costs (the
      serving layer uses worst-case KV pages, so backlog is bounded in
      the resource that actually runs out, not just in count).
    - ``cost_fn`` computes one request's cost (required with
      ``max_cost``). A request whose own cost exceeds ``max_cost`` can
      never be admitted and sheds as ``oversized``.

    ``metrics`` (a Registry, or any object with a ``.registry``) exports
    ``beholder_serving_shed_total{reason}``,
    ``beholder_serving_intake_depth``,
    ``beholder_serving_admitted_total``, and — naming this queue via
    ``name`` — the labelled ``beholder_intake_queue_depth{queue}``
    series, so several intakes in one process chart side by side.

    Time-in-queue is measured too: every :meth:`take_all` drain stamps
    each item's wait into ``beholder_intake_wait_seconds{queue}``
    (registered lazily on the FIRST drain — the default exposition
    stays untouched until intake wait actually exists) and exposes the
    drained items' waits as :attr:`last_drain_waits`, which the serving
    schedulers fold into per-request timeline queue-wait.

    ``labelled_sheds`` (off by default so the existing exposition is
    untouched) additionally attributes every shed to THIS queue on the
    labelled ``beholder_intake_shed_total{queue, reason}`` series —
    the shed twin of the labelled depth gauge. The cluster router
    turns it on for its per-shard intakes (uniquely named
    ``cluster.decode-<i>``), so shed attribution survives the move
    from one queue to N: which SHARD said no stays chartable after
    the reason-only ``beholder_serving_shed_total`` series folds all
    shards together.
    """

    def __init__(
        self,
        max_depth: int,
        max_cost: float | None = None,
        cost_fn: Callable[[Any], float] | None = None,
        metrics=None,
        name: str | None = None,
        labelled_sheds: bool = False,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if name is None:
            # default names stay unique per process: two unnamed queues
            # sharing a registry must not silently overwrite each
            # other's depth series (the first keeps the bare name so the
            # common single-queue case charts stably)
            n = next(_default_names)
            name = "serving.intake" if n == 0 else f"serving.intake-{n + 1}"
        if max_cost is not None and cost_fn is None:
            raise ValueError("max_cost needs a cost_fn")
        self.max_depth = int(max_depth)
        self.max_cost = max_cost
        self.cost_fn = cost_fn
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: list = []
        #: per-item enqueue stamps, parallel to ``_pending`` — the
        #: time-in-queue source (``beholder_intake_wait_seconds``)
        self._enqueued_at: list[float] = []
        self._pending_cost = 0.0
        #: waits (seconds) of the items the LAST take_all drained, in
        #: drain order — the scheduler feeds these into the request
        #: timelines (queue-wait is measured at claim, not inferred) —
        #: plus the raw enqueue stamps for restock round trips
        self.last_drain_waits: list[float] = []
        self.last_drain_stamps: list[float] = []
        self.shed_counts: dict[str, int] = {}
        self._shed_total = None
        self._depth_gauge = None
        self._labelled_depth = None
        self._labelled_sheds = None
        self._admitted_total = None
        self._wait_hist = None
        self._registry = None
        if metrics is not None:
            registry = getattr(metrics, "registry", metrics)
            self._registry = registry
            self._shed_total = get_or_create(
                registry, "counter",
                "beholder_serving_shed_total",
                "Serving requests rejected at the intake queue, by reason",
                labelnames=["reason"],
            )
            self._admitted_total = get_or_create(
                registry, "counter",
                "beholder_serving_admitted_total",
                "Serving requests admitted through the intake queue",
            )
            self._depth_gauge = get_or_create(
                registry, "gauge",
                "beholder_serving_intake_depth",
                "Requests waiting in the serving intake queue",
            )
            self._labelled_depth = get_or_create(
                registry, "gauge",
                "beholder_intake_queue_depth",
                "Requests waiting in a bounded intake queue, by queue "
                "name (serving-side twin of beholder_mq_queue_depth)",
                labelnames=["queue"],
            )
            self._labelled_depth.set(0, queue=self.name)
            if labelled_sheds:
                self._labelled_sheds = get_or_create(
                    registry, "counter",
                    "beholder_intake_shed_total",
                    "Requests shed at a bounded intake queue, by queue "
                    "name and reason (per-queue twin of "
                    "beholder_serving_shed_total)",
                    labelnames=["queue", "reason"],
                )

    # -- introspection -------------------------------------------------------
    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def pending_cost(self) -> float:
        with self._lock:
            return self._pending_cost

    # -- intake --------------------------------------------------------------
    def _shed(self, reason: str) -> Admission:
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        if self._shed_total is not None:
            self._shed_total.inc(reason=reason)
        if self._labelled_sheds is not None:
            self._labelled_sheds.inc(queue=self.name, reason=reason)
        return Admission(False, reason)

    def shed(self, reason: str) -> Admission:
        """Record an externally-decided rejection (e.g. the scheduler
        judged the request unservable at any load) on the same counters."""
        with self._lock:
            return self._shed(reason)

    def offer(self, item: Any, cost: float | None = None) -> Admission:
        """Try to enqueue ``item``; never blocks, never grows past the
        bounds — the whole point is that saying no is O(1). A caller
        that already computed the item's cost passes it via ``cost`` to
        skip the second ``cost_fn`` evaluation."""
        if cost is None:
            cost = float(self.cost_fn(item)) if self.cost_fn is not None else 0.0
        with self._lock:
            if self.max_cost is not None and cost > self.max_cost:
                return self._shed(SHED_OVERSIZED)
            if len(self._pending) >= self.max_depth:
                return self._shed(SHED_QUEUE_FULL)
            if (
                self.max_cost is not None
                and self._pending_cost + cost > self.max_cost
            ):
                return self._shed(SHED_COST_BACKLOG)
            self._pending.append(item)
            self._enqueued_at.append(self._clock())
            self._pending_cost += cost
            if self._admitted_total is not None:
                self._admitted_total.inc()
            if self._depth_gauge is not None:
                self._depth_gauge.set(len(self._pending))
            if self._labelled_depth is not None:
                self._labelled_depth.set(len(self._pending), queue=self.name)
            return Admission(True)

    def take_all(self, record_waits: bool = True) -> list:
        """Drain every pending item (the scheduler's batch pull).

        Each drained item's time-in-queue is stamped HERE — the claim
        moment — into ``beholder_intake_wait_seconds{queue}``
        (registered on first observation, so the default exposition is
        untouched until a drain actually happens) and kept in
        :attr:`last_drain_waits` for the request-timeline layer.

        ``record_waits=False`` is for drain-then-restock ROUND TRIPS
        (the cluster rebalance / graceful drain): the items are not
        being claimed, only re-packed, so their partial waits must not
        land on the histogram — the eventual claiming drain observes
        the one true wait. Stamps and waits are still computed (the
        re-pack hands the stamps back via ``restock(enqueued_at=)``)."""
        items, _, _ = self.drain_all(record_waits=record_waits)
        return items

    def drain_all(
        self, record_waits: bool = True
    ) -> tuple[list, list[float], list[float]]:
        """:meth:`take_all` returning ``(items, waits, enqueue_stamps)``
        as ONE atomic read — callers that restock with the original
        stamps (the re-pack paths) or attach the waits to request
        timelines must not read ``last_drain_waits``/
        ``last_drain_stamps`` as a second step: a concurrent drain in
        between would clobber them, and a zip over mismatched lists
        silently drops items."""
        with self._lock:
            items, self._pending = self._pending, []
            stamps, self._enqueued_at = self._enqueued_at, []
            self._pending_cost = 0.0
            now = self._clock()
            self.last_drain_waits = [now - ts for ts in stamps]
            # the raw stamps ride along so a drain-then-restock (the
            # cluster rebalance / graceful drain) can hand them back
            # via restock(enqueued_at=...) — queue time actually
            # waited must survive a re-pack
            self.last_drain_stamps = stamps
            if self._depth_gauge is not None:
                self._depth_gauge.set(0)
            if self._labelled_depth is not None:
                self._labelled_depth.set(0, queue=self.name)
            waits = self.last_drain_waits
        if record_waits:
            self._observe_waits(waits)
        return items, waits, stamps

    def _observe_waits(self, waits: list[float]) -> None:
        if self._registry is None or not waits:
            return
        if self._wait_hist is None:
            self._wait_hist = get_or_create(
                self._registry, "histogram",
                "beholder_intake_wait_seconds",
                "Time from intake admission to scheduler claim, by "
                "queue (the queue-wait leg of a request's timeline)",
                labelnames=["queue"],
                buckets=WAIT_BUCKETS,
            )
        for wait in waits:
            self._wait_hist.observe(wait, queue=self.name)

    def restock(self, items: list, enqueued_at: list[float] | None = None) -> None:
        """Put back items previously drained by :meth:`take_all` (the
        cluster router's rebalance re-packs queued work across shard
        queues). Bypasses the bounds and the admitted/shed counters —
        every item here was already admitted exactly once; rebalancing
        must neither re-count nor re-shed it. Restocked items land at
        the FRONT in order, so a drain sees them before newer offers
        (FIFO is preserved across a rebalance).

        ``enqueued_at`` hands back the items' ORIGINAL enqueue stamps
        (``last_drain_stamps`` from the drain, item-parallel) so the
        eventual claim still measures the queue time actually waited;
        without it items re-stamp at restock time (a rebalance-sized
        underestimate — the conservative fallback)."""
        if not items:
            return
        if enqueued_at is not None and len(enqueued_at) != len(items):
            raise ValueError(
                f"enqueued_at has {len(enqueued_at)} stamps for "
                f"{len(items)} items"
            )
        with self._lock:
            cost = sum(
                float(self.cost_fn(item)) if self.cost_fn is not None
                else 0.0
                for item in items
            )
            self._pending = list(items) + self._pending
            self._enqueued_at = (
                list(enqueued_at)
                if enqueued_at is not None
                else [self._clock()] * len(items)
            ) + self._enqueued_at
            self._pending_cost += cost
            if self._depth_gauge is not None:
                self._depth_gauge.set(len(self._pending))
            if self._labelled_depth is not None:
                self._labelled_depth.set(
                    len(self._pending), queue=self.name
                )
