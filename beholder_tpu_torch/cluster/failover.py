"""Fault-tolerant cluster serving: failure detection, in-flight request
recovery, live-slot migration and graceful drain (the port's copy of the
reference's ``cluster/failover.py``). Off by default
(``ClusterConfig.failover is None``: the cluster is fail-stop).

- **Worker health and failure detection.** Every decode shard and prefill
  worker carries a heartbeat the router stamps at each scheduling event;
  :meth:`FailoverEngine.sweep` marks a watched worker (one with a serve in
  progress) down once its beat is older than ``heartbeat_interval_s *
  miss_threshold``. Deterministic faults
  (:class:`~beholder_tpu_torch.reliability.chaos.WorkerFault`) inject the
  three failure kinds: ``kill`` (a typed :class:`WorkerKilled` raised
  mid-dispatch), ``hang`` (frozen beats) and ``transfer_corruption``
  (scripted hop faults, absorbed by the transfer engine's retry or
  surfaced as :class:`~beholder_tpu_torch.cluster.transfer.TransferFailed`).
  A down shard leaves the routing set.
- **In-flight recovery.** Requests on a failed shard are re-admitted on
  survivors by re-prefilling from the request's host-side state. Under
  exact greedy the replay is the computation the dead shard was running,
  so recovered streams are the uninterrupted run's bits;
  :meth:`FailoverEngine.splice` joins a replay onto tokens already
  delivered (:meth:`FailoverEngine.record_emitted`), never emitting an
  index twice or skipping one.
- **Graceful drain** (:meth:`FailoverEngine.drain`). Queued work moves to
  surviving intakes, and the shard's resident pool (live slots and warm
  prefix-cache pages) moves page by page through the transfer engine's
  retried hop as raw pool representation
  (:func:`~beholder_tpu_torch.models.serving.paged_export_pages` /
  :func:`~beholder_tpu_torch.models.serving.paged_import_pages`): no
  dequantize/requantize round trip, so destination pages are
  byte-identical (bf16, int8 and fp8), refcounts move wholesale, and the
  prefix-cache index is re-rooted with its pins.
- **Deadline-aware degraded mode.** An expired request retires with an
  explicit ``DeadlineExceededResult``, and the router sheds with
  ``reason=shard_down`` when surviving capacity is short, resolving the
  requests it cannot place to an explicit :class:`Dropped` outcome.

Observability: the ``beholder_failover_*`` catalog
(:class:`~beholder_tpu_torch.cluster.instruments.FailoverMetrics`,
registered on demand) and recorder-only ``failover`` / ``drain`` /
``heartbeat`` events on the owning worker's track.
"""

from __future__ import annotations

import time

import numpy as np

from .transfer import TransferFailed

#: worker lifecycle states. DOWN is a FAILURE (degrades health);
#: DRAINED is a completed planned decommission — capacity is gone but
#: nothing was lost, and planned is not sick (the health check treats
#: only DOWN as degradation)
WORKER_UP = "up"
WORKER_DRAINING = "draining"
WORKER_DOWN = "down"
WORKER_DRAINED = "drained"


class WorkerKilled(RuntimeError):
    """A worker died mid-dispatch (chaos ``kill`` or a wrapped device
    fault). Typed so the router's recovery loop can distinguish a
    worker-level failure from a numerics/logic bug — only typed
    failures are recovered; anything else still raises."""

    def __init__(self, worker: str, kind: str = "kill"):
        super().__init__(f"worker {worker} {kind}ed mid-dispatch")
        self.worker = worker
        self.kind = kind


class NoHealthyShards(RuntimeError):
    """Every decode shard is down — nothing can serve."""


class DrainError(RuntimeError):
    """A graceful drain could not complete (capacity shortfall on the
    surviving shards, or the shard is not in a drainable state)."""


class Dropped:
    """Explicit terminal outcome for a request the failover layer could
    not serve: ``shard_down`` (surviving capacity insufficient) or
    ``recovery_limit`` (re-admitted more than
    ``max_recoveries_per_request`` times). Callers in failover mode
    receive this in the request's result position instead of an
    exception tearing down every other in-flight request."""

    __slots__ = ("reason",)
    outcome = "dropped"

    def __init__(self, reason: str):
        self.reason = reason

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Dropped({self.reason!r})"


class FailoverEngine:
    """The cluster's fault-tolerance brain: worker states, heartbeats,
    fault injection, recovery bookkeeping, and drain migration. Owned
    by a :class:`~beholder_tpu_torch.cluster.router.ClusterScheduler` when
    ``ClusterConfig.failover`` is set; the router consults it at every
    scheduling decision and hands it failed shards' batches to
    recover. ``clock`` is injectable for deterministic heartbeat
    tests."""

    #: typed failures the router recovers from (anything else raises —
    #: a logic bug must never be silently absorbed as a worker fault)
    RECOVERABLE: tuple[type[BaseException], ...] = (
        WorkerKilled, TransferFailed,
    )

    def __init__(self, router, config, registry=None,
                 flight_recorder=None, clock=time.monotonic):
        self.router = router
        self.config = config
        self.flight_recorder = flight_recorder
        self._clock = clock
        self.instruments = None
        if registry is not None:
            from .instruments import FailoverMetrics

            self.instruments = FailoverMetrics(registry)
        self.states: dict[str, str] = {}
        for shard in router.shards:
            self._set_state(shard.pool.name, WORKER_UP)
        for worker in router.prefill_workers:
            self._set_state(worker.name, WORKER_UP)
        self.last_beat: dict[str, float] = {}
        #: workers with a serve in progress — the only ones a stale
        #: heartbeat can condemn (an idle worker is not a dead worker)
        self._watched: set[str] = set()
        #: chaos-hung workers: their beats freeze
        self._hung: set[str] = set()
        #: host-side tokens already DELIVERED per request key — the
        #: splice ledger that pins "no token emitted twice or skipped"
        self._emitted: dict = {}
        self.recovered_total = 0
        self.dropped_total = 0
        self.drains = 0
        self.migrated_pages = 0
        #: wall seconds of each recovery re-serve pass (bench evidence)
        self.recovery_walls: list[float] = []
        #: set by the scheduler's shutdown() final drain: draining shards
        #: stay servable (they only stopped admitting)
        self._drain_serving = False

    # -- worker state ----------------------------------------------------

    def _set_state(self, worker: str, state: str) -> None:
        self.states[worker] = state
        if self.instruments is not None:
            self.instruments.worker_up.set(
                1 if state == WORKER_UP else 0, worker=worker
            )

    def state(self, worker: str) -> str:
        return self.states.get(worker, WORKER_UP)

    def routable_shards(self) -> list:
        """Shards admissions may use: the up ones — plus the draining ones
        during a shutdown's final drain (they stopped admitting, not
        serving; see :meth:`~beholder_tpu_torch.cluster.router.
        ClusterScheduler.shutdown`)."""
        states = (WORKER_UP, WORKER_DRAINING) if self._drain_serving else (WORKER_UP,)
        return [s for s in self.router.shards if self.state(s.pool.name) in states]

    def up_prefill_workers(self) -> list:
        return [
            w for w in self.router.prefill_workers
            if self.state(w.name) == WORKER_UP
        ]

    def adopt_worker(self, worker: str) -> None:
        """Register a worker that joined outside
        :meth:`~beholder_tpu_torch.cluster.router.ClusterScheduler.scale_up`
        (the fabric's standby promotion) as up and beating, so routing and
        the sweep treat it as a boot-time shard."""
        self._set_state(worker, WORKER_UP)
        self.heartbeat(worker)

    def mark_down(self, worker: str, kind: str) -> None:
        """Record a detected failure: the worker leaves the routing
        set, the failure counts by kind, and the timeline gets a
        ``failover`` instant on the worker's track."""
        if self.state(worker) == WORKER_DOWN:
            return
        self._set_state(worker, WORKER_DOWN)
        self._watched.discard(worker)
        if self.instruments is not None:
            self.instruments.worker_failures_total.inc(
                worker=worker, kind=kind
            )
        if self.flight_recorder is not None:
            self.flight_recorder.instant(
                "failover", worker=worker, reason=kind
            )

    # -- heartbeats ------------------------------------------------------

    def heartbeat(self, worker: str) -> None:
        if worker not in self._hung:
            self.last_beat[worker] = self._clock()

    def begin_serve(self, worker: str) -> None:
        self._watched.add(worker)
        self.heartbeat(worker)

    def end_serve(self, worker: str) -> None:
        self._watched.discard(worker)

    def sweep(self) -> None:
        """Failure-detection pass, run at every router entry point: a
        WATCHED worker whose heartbeat is stale past
        ``heartbeat_interval_s * miss_threshold`` is marked down
        (``kind="hang"``), with a recorder-only ``heartbeat`` instant
        carrying the observed staleness."""
        limit = (
            self.config.heartbeat_interval_s * self.config.miss_threshold
        )
        now = self._clock()
        for worker in list(self._watched):
            if self.state(worker) != WORKER_UP:
                continue
            age = now - self.last_beat.get(worker, now)
            if age > limit:
                if self.flight_recorder is not None:
                    self.flight_recorder.instant(
                        "heartbeat", worker=worker,
                        age_s=round(age, 3), limit_s=limit,
                    )
                self.mark_down(worker, "hang")

    # -- chaos injection -------------------------------------------------

    def inject_fault(self, fault) -> None:
        """Arm one deterministic :class:`~beholder_tpu_torch.reliability.
        chaos.WorkerFault`. ``kill`` wraps the worker's dispatch entry
        point (the decode shard's ``_tick_chunk`` / the prefill worker's
        ``prefill``) to raise :class:`WorkerKilled` after
        ``after_dispatches`` successful calls — a genuine mid-stream
        death. ``hang`` freezes the worker's heartbeats (and watches
        it) so the next sweep condemns it. ``transfer_corruption``
        scripts the transfer engine's next hops to fail."""
        from beholder_tpu_torch.reliability.chaos import (
            WORKER_HANG,
            WORKER_KILL,
            WORKER_TRANSFER_CORRUPTION,
        )

        if fault.kind == WORKER_TRANSFER_CORRUPTION:
            # scoped to hops whose DESTINATION is the faulted worker —
            # one broken link, not a cluster-wide fabric outage
            self.router.transfer.fail_next(
                fault.transfer_failures, worker=fault.worker
            )
            return
        if fault.kind == WORKER_HANG:
            self._hung.add(fault.worker)
            self._watched.add(fault.worker)
            limit = (
                self.config.heartbeat_interval_s
                * self.config.miss_threshold
            )
            self.last_beat[fault.worker] = self._clock() - limit - 1.0
            return
        if fault.kind != WORKER_KILL:
            raise ValueError(f"unknown worker-fault kind {fault.kind!r}")
        shard = next(
            (s for s in self.router.shards
             if s.pool.name == fault.worker), None
        )
        if shard is not None:
            self._wrap_kill(
                shard.batcher, "_tick_chunk", fault.worker,
                fault.after_dispatches,
            )
            return
        worker = next(
            (w for w in self.router.prefill_workers
             if w.name == fault.worker), None
        )
        if worker is None:
            raise ValueError(f"unknown worker {fault.worker!r}")
        self._wrap_kill(worker, "prefill", fault.worker,
                        fault.after_dispatches)

    @staticmethod
    def _wrap_kill(owner, attr: str, worker: str, after: int) -> None:
        orig = getattr(owner, attr)
        calls = [0]

        def killer(*args, **kwargs):
            calls[0] += 1
            if calls[0] > after:
                raise WorkerKilled(worker)
            return orig(*args, **kwargs)

        setattr(owner, attr, killer)

    # -- recovery bookkeeping --------------------------------------------

    def on_shard_failure(self, shard, err) -> str:
        """A typed worker failure escaped a shard's serve: mark it
        down; returns the failure kind. Recovery accounting happens
        separately (:meth:`count_recovered`) — only requests actually
        RE-ADMITTED count, not ones the recovery cap drops."""
        kind = getattr(err, "kind", "kill")
        self.mark_down(shard.pool.name, kind)
        return kind

    def count_recovered(self, worker: str, reason: str, n: int) -> None:
        """Account ``n`` requests genuinely re-admitted on surviving
        shards after ``worker`` failed with ``reason``."""
        if n <= 0:
            return
        self.recovered_total += n
        if self.instruments is not None:
            self.instruments.recoveries_total.inc(n, reason=reason)
        if self.flight_recorder is not None:
            self.flight_recorder.instant(
                "failover", worker=worker, reason=reason, recovered=n
            )

    def drop(self, reason: str, key=None) -> Dropped:
        """Resolve one request to an explicit :class:`Dropped` outcome.
        ``key`` (the request's timeline gid, when the caller has one)
        also emits a recorder-only ``req.dropped`` lifecycle instant —
        a lost request must be VISIBLE to the SLO layer (a recovery
        storm that drops requests while attainment reads 1.0 would be
        exactly the blind spot the burn-rate page exists to close)."""
        self.dropped_total += 1
        if self.instruments is not None:
            self.instruments.dropped_total.inc(reason=reason)
        if self.flight_recorder is not None and key is not None:
            self.flight_recorder.instant(
                "req.dropped", gid=key, reason=reason
            )
        return Dropped(reason)

    def shed(self, reason: str):
        """Shed one SUBMISSION on the counters of the queue that said
        no — a down shard's when one exists (it is the missing
        capacity), the first shard's otherwise. Deliberately not
        counted on ``dropped_total``: that series is reserved for
        in-flight requests resolved to a :class:`Dropped` outcome; a
        submit-time rejection already lands on the intake shed
        counters, and double-counting the same rejection across both
        families would inflate either read."""
        intake = next(
            (s.intake for s in self.router.shards
             if self.state(s.pool.name) != WORKER_UP),
            self.router.shards[0].intake,
        )
        return intake.shed(reason)

    # -- emitted-token ledger (the no-duplicate/no-skip pin) -------------

    def record_emitted(self, key, tokens) -> None:
        """Record tokens already DELIVERED for ``key`` (host-side
        request state). Recovery replays the full deterministic stream
        and splices past these — they are never re-emitted. The
        embedder-facing half of the ledger: the synchronous schedulers
        deliver whole streams only (their recoveries always splice an
        empty prefix); a caller streaming tokens out incrementally
        records each delivery here so a later recovery cannot
        re-emit or skip an index."""
        self._emitted[key] = np.asarray(tokens, np.float32)

    def splice(self, key, replayed):
        """Join a recovered request's replayed stream onto what was
        already delivered: the recomputed prefix must MATCH the
        delivered tokens bitwise (exact greedy is deterministic —
        a mismatch means corrupted recovery, raised loudly, never
        silently emitted), and only the suffix past the delivered
        count is new. With nothing delivered (the common batch case)
        the replay passes through untouched.

        The ledger entry is CONSUMED here — producing the request's
        final stream completes it, and run()'s keys (0..n-1) recur on
        every call, so a surviving entry would splice one run's stale
        tokens into the next run's same-keyed request (and leak
        unboundedly on a long-lived scheduler)."""
        emitted = self._emitted.pop(key, None)
        if emitted is None or len(emitted) == 0:
            return replayed
        replayed = np.asarray(replayed)
        if not np.array_equal(replayed[: len(emitted)], emitted):
            raise RuntimeError(
                f"recovered stream diverged from {len(emitted)} "
                f"already-emitted token(s) for request {key!r} — "
                "refusing to emit a token index twice with a "
                "different value"
            )
        return np.concatenate([emitted, replayed[len(emitted):]])

    def discard_emitted(self, keys) -> None:
        """Drop ledger entries for keys whose requests reached a
        TERMINAL outcome without a splice (Dropped, deadline) — the
        serve loop calls this once per batch so run()'s recurring key
        space can never inherit a dead run's tokens."""
        for key in keys:
            self._emitted.pop(key, None)

    # -- graceful drain --------------------------------------------------

    def drain(self, shard_id: int):
        """Planned decommission of one decode shard with zero loss:

        1. the shard leaves the routing set (``draining``);
        2. its queued intake migrates to surviving shards'
           queues (restocked — admission counters untouched, FIFO
           preserved via the cluster-wide submit sequence); items no
           surviving shard can ever hold shed ``shard_down``;
        3. its RESIDENT pool — live slots and prefix-cache pages —
           migrates byte-identically to the least-pressure surviving
           shard (:func:`migrate_pool`), refcounts and cache pins
           intact;
        4. the shard is marked down (``drained`` capacity is gone, but
           nothing on it was lost).

        Returns ``{"requeued": n, "migrated_pages": n, "target": name}``.
        """
        from beholder_tpu_torch.reliability.shed import SHED_SHARD_DOWN

        router = self.router
        shard = router.shards[shard_id]
        name = shard.pool.name
        if self.state(name) != WORKER_UP:
            raise DrainError(f"{name} is {self.state(name)}, not up")
        self._set_state(name, WORKER_DRAINING)
        survivors = self.routable_shards()
        if not survivors:
            self._set_state(name, WORKER_UP)
            raise DrainError(
                f"cannot drain {name}: it is the last healthy shard"
            )
        ts = time.time()
        t0 = time.perf_counter()

        # 2. queued work moves first (it holds no device state). The
        # original enqueue stamps migrate WITH the items, so the
        # eventual claim still measures the full queue wait
        # a re-pack onto survivors, not a claim: waits stay OFF the
        # histogram (the claiming drain observes the one true wait);
        # the (items, stamps) pair is read atomically — a second-step
        # attribute read could be clobbered by a concurrent drain and
        # zip-drop every pending item
        pending, _, pending_stamps = shard.intake.drain_all(
            record_waits=False
        )
        requeued = 0
        moves: dict[int, list] = {s.pool.shard_id: [] for s in survivors}
        move_stamps: dict[int, list[float]] = {
            s.pool.shard_id: [] for s in survivors
        }
        for item, stamp in zip(pending, pending_stamps):
            request = item[1]
            need = router._need(request)
            shard.pool.release(need)
            fits = [s for s in survivors if router._fits(s, need)]
            if not fits:
                # ONE family records the loss: the request resolves to
                # a Dropped outcome (dropped_total) — it was already
                # counted admitted at submit, so re-shedding it on the
                # intake counters would double-report one request. The
                # submit-seq gid keeps the loss on the SLO books too
                router._pending_drops[item[0]] = self.drop(
                    SHED_SHARD_DOWN, key=f"s{item[0]}"
                )
                continue
            target = router.shards[
                router.pool_view.least_pressure(
                    [s.pool for s in fits]
                ).shard_id
            ]
            target.pool.reserve(need)
            moves[target.pool.shard_id].append(item)
            move_stamps[target.pool.shard_id].append(stamp)
            router._record_route(target, "drain", need, 0.0, time.time())
            requeued += 1
        for target in survivors:
            items = moves[target.pool.shard_id]
            if items:
                # flight-plane edge pair (armed only): the drained worker's
                # send instant and the survivor's restock mark share an id
                fr = self.flight_recorder
                edge = fr.next_edge() if fr is not None else None
                if edge is not None:
                    fr.instant("drain.send", worker=name, dst=target.pool.name,
                               requeued=len(items), edge=edge)
                target.intake.restock(
                    items,
                    enqueued_at=move_stamps[target.pool.shard_id],
                )
                if edge is not None:
                    fr.instant("restock", worker=target.pool.name, src=name,
                               requeued=len(items), edge=edge)

        # 3. resident pool state moves byte-identically. A migration
        # failure (destination capacity, transfer) rolls the shard back
        # to UP — its pool is untouched (capacity checks precede any
        # destination write), its queued work already lives safely on
        # survivors, and the operator can retry after adding capacity;
        # a shard stranded in "draining" would be unroutable forever
        target = router.shards[
            router.pool_view.least_pressure(
                [s.pool for s in survivors]
            ).shard_id
        ]
        try:
            migrated = migrate_pool(
                shard.batcher, target.batcher, router.transfer,
                src=name, dst=target.pool.name,
            )
        except Exception:
            self._set_state(name, WORKER_UP)
            raise
        self.migrated_pages += migrated

        # 4. capacity is gone; nothing on it was lost. DRAINED, not
        # DOWN: a planned decommission must not degrade health
        self._set_state(name, WORKER_DRAINED)
        self.drains += 1
        if self.instruments is not None:
            self.instruments.drains_total.inc()
            if migrated:
                self.instruments.migrated_pages_total.inc(migrated)
        if self.flight_recorder is not None:
            self.flight_recorder.record(
                "drain", ts, time.perf_counter() - t0,
                worker=name, dst=target.pool.name,
                pages=int(migrated), requeued=int(requeued),
            )
        router.pool_view.refresh_gauges(router.instruments)
        return {
            "requeued": requeued,
            "migrated_pages": int(migrated),
            "target": target.pool.name,
        }


# -- live migration: the raw page/slot move -------------------------------


def migrate_pool(src_batcher, dst_batcher, transfer=None, *,
                 src: str = "src", dst: str = "dst") -> int:
    """Move everything resident in ``src_batcher``'s pool (live slots'
    pages, prefix-cache pages, their refcounts and the cache index) into
    ``dst_batcher``'s pool, byte-identically.

    The unit is the page, the path is the transfer engine's retried hop,
    and the representation is raw
    (:func:`~beholder_tpu_torch.models.serving.paged_export_pages` /
    :func:`~beholder_tpu_torch.models.serving.paged_import_pages`): 8-bit
    pools move their values and scales verbatim. The export is a gather
    into new tensors, so on one device (where the hop moves nothing) the
    destination still holds its own copy. Refcounts move wholesale; live
    slots land in free destination slots with their page tables rewritten
    through the old -> new page mapping; the prefix-cache index is
    re-rooted with its pins (``live_users``) intact.

    When the destination cannot hold every live source page, cold
    prefix-cache pages are surrendered on the source first; live-slot state
    moves losslessly or the drain fails with :class:`DrainError`.

    This is an admin operation, the one place host readbacks are fine. The
    source batcher is poisoned afterwards. Returns the pages migrated."""
    import torch

    def snapshot():
        state = src_batcher.state
        return tuple(
            x.cpu().numpy()
            for x in (state.page_table, state.seq_lens, state.active, state.page_ref)
        )

    table, lens, active, refs = snapshot()
    live = np.nonzero(refs > 0)[0]
    if live.size == 0:
        return 0

    dst_free = int(dst_batcher.state.free_top)
    if live.size > dst_free and src_batcher.prefix_cache is not None:
        # surrender cold cache pages on the source: live slots must move
        # losslessly, cache warmth is best-effort
        src_batcher._evict_cached(int(live.size) - dst_free)
        table, lens, active, refs = snapshot()
        live = np.nonzero(refs > 0)[0]
    if live.size > dst_free:
        raise DrainError(
            f"destination pool cannot hold {live.size} live pages "
            f"({dst_free} free) — add capacity before draining"
        )

    src_slots = np.nonzero(active)[0]
    free_slots: np.ndarray = np.zeros(0, np.int64)
    if src_slots.size:
        free_slots = np.nonzero(~dst_batcher.state.active.cpu().numpy())[0]
        if src_slots.size > free_slots.size:
            raise DrainError(
                f"destination has {free_slots.size} free slots for "
                f"{src_slots.size} live source slots"
            )

    # the raw move: export in pool representation, one retried hop to the
    # destination's device, import verbatim with the source refcounts
    chunks_k, chunks_v = src_batcher.export_pages(src_batcher._up(live.astype(np.int64)))
    dst_device = dst_batcher.transfer_device
    if transfer is not None:
        chunks_k, chunks_v = transfer.raw_move(
            (chunks_k, chunks_v), dst_device, src=src, dst=dst, op=f"drain.{src}->{dst}",
        )
    else:
        from .pool import place_paged_state

        chunks_k, chunks_v = place_paged_state((chunks_k, chunks_v), dst_device)
    ref_vals = dst_batcher._up(refs[live].astype(np.int32))
    new_state, dest = dst_batcher.import_pages(chunks_k, chunks_v, int(live.size), ref_vals)
    dest = dest.cpu().numpy()[: live.size]
    mapping = {int(o): int(d) for o, d in zip(live, dest)}

    # live slots: free destination slots, page tables rewritten through the
    # mapping, lengths and active bits carried over
    page = src_batcher.page_size
    if src_slots.size:
        table_np = new_state.page_table.cpu().numpy()
        lens_np = new_state.seq_lens.cpu().numpy()
        active_np = new_state.active.cpu().numpy()
        for i, s in enumerate(src_slots):
            d = int(free_slots[i])
            row = np.zeros(table_np.shape[1], np.int32)
            count = -(-int(lens[s]) // page)
            row[:count] = [mapping[int(p)] for p in table[s][:count]]
            table_np[d] = row
            lens_np[d] = int(lens[s])
            active_np[d] = True
        dev = new_state.seq_lens.device
        new_state = new_state._replace(
            page_table=torch.from_numpy(table_np).to(dev),
            seq_lens=torch.from_numpy(lens_np).to(dev),
            active=torch.from_numpy(active_np).to(dev),
        )
    dst_batcher.state = new_state

    # prefix-cache index: re-root chains onto the destination pool. A chain
    # already cached on the destination keeps the destination's entry; the
    # duplicate migrated page drops the cache's one reference (insert()'s
    # collision rule)
    src_cache = src_batcher.prefix_cache
    dst_cache = dst_batcher.prefix_cache
    if src_cache is not None and dst_cache is not None:
        duplicates: list[int] = []
        for key, parent, page_id, live_users in src_cache.export_entries():
            new_id = mapping[int(page_id)]
            if not dst_cache.adopt_entry(key, parent, new_id, live_users):
                duplicates.append(new_id)
        if duplicates:
            from beholder_tpu_torch.models.serving import cache_unref_pages

            dst_batcher.state = cache_unref_pages(
                dst_batcher.state, *dst_batcher._page_id_batch(duplicates)
            )

    # the source is decommissioned: poison it so accidental reuse fails
    # loudly instead of serving from a migrated-away pool
    src_batcher._poisoned = True
    return int(live.size)
