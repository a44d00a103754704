"""The fabric engine: cross-shard page movement with one owner.

The router consults this engine at four points, all behind
``ClusterConfig.fabric is not None`` (without an engine the cluster is the
fabric-less one):

- **Admission.** Every attached shard's batcher gets a ``prefix_fetcher``
  hook: when its own prefix cache cannot cover a request's prefix, the
  engine asks the :class:`~.index.GlobalPrefixIndex` which shard can, pins
  the owner's chain, moves the missing pages verbatim over the transfer
  engine (:meth:`~beholder_tpu_torch.models.serving.ContinuousBatcher.
  export_pages` -> ``raw_move`` -> ``import_pages``, the path a drain's
  migration takes, so 8-bit pools move their values and scales raw) and
  adopts them into the borrower's cache, so the local lookup one line later
  hits. The admission is then a plain warm hit: same pins, same eviction
  rules, same page bytes, and the stream is the local hit's bits.
- **Serve completion** (:meth:`FabricEngine.finish_serve`): the borrower's
  cross-shard pins release against their owners, and borrowed chains whose
  cross-shard hit count never reached ``FabricConfig.replicate_after`` are
  dropped (transient borrows; hot prefixes stay as replicas).
- **Worker death** (:meth:`FabricEngine.on_worker_down`) and **drain**
  (:meth:`FabricEngine.on_drain`): the pin ledger and the directory forget
  the worker (a drain repoints pins at the migration target: the chains
  moved there byte for byte, ``live_users`` intact), and a mirroring standby
  is promoted in place of the replay.
- **Between serves** (:meth:`FabricEngine.sync`): the standby mirror
  refreshes (:class:`~.mirror.StandbyMirror`), spawning a dark standby shard
  on first use.

Each page hop is a recorder-only ``fabric`` or ``mirror`` event (worker,
source, pages), and a promotion and a spawn are ``promote`` and ``standby``
instants. With a flight plane bound to the recorder, each hop's event and a
``fabric.send`` or ``mirror.send`` instant on the source worker share an
edge id, as :mod:`beholder_tpu_torch.cluster.transfer`'s handoff does.
"""

from __future__ import annotations

import time

import numpy as np

from beholder_tpu_torch.models.serving import cache_unref_pages

from .index import GlobalPrefixIndex, IndexedPrefixCache
from .mirror import StandbyMirror


class FabricEngine:
    """One cluster's memory fabric: directory, pins and standby."""

    #: moves pad their page list to the next multiple of this, as the
    #: reference pads its fixed-shape programs; the import drops the rows
    #: past the real count, so padding costs a few wire bytes, never a page
    MOVE_BUCKET = 8
    #: shape-replay budget of :meth:`_warm_standby`
    MAX_WARM_SHAPES = 8

    def __init__(self, config, transfer, flight_recorder=None):
        self.config = config
        self.transfer = transfer
        self.flight_recorder = flight_recorder
        self.index = GlobalPrefixIndex()
        self.mirror = StandbyMirror(self)
        #: attached serving shards by pool name (the standby stays out until
        #: promotion: a dark shard is never a fetch owner or a mirror source)
        self._shards: dict[str, object] = {}
        #: transient borrows per borrower: chains adopted below the
        #: replication threshold, dropped at finish_serve
        self._borrows: dict[str, list[list[bytes]]] = {}
        #: the dark standby (a router ``_Shard``), or None
        self.standby = None
        # host counters (no metric series: the exposition is unchanged)
        self.cross_shard_lookups = 0
        self.cross_shard_hits = 0
        self.pages_fetched = 0
        self.fetch_failures = 0
        self.pins_released = 0
        self.borrows_dropped = 0
        self.replicas = 0
        self.promotions = 0
        self.standbys_spawned = 0
        self.standby_failures = 0

    # -- attachment -------------------------------------------------------

    def attach_shard(self, shard) -> None:
        """Join one serving shard to the fabric: wrap its prefix cache so
        the directory follows every index mutation (publishing what the
        cache already holds) and arm the batcher's admission hook. A shard
        without a prefix cache has nothing to share and stays out. (The
        reference also builds the release program at every round width
        here; eager PyTorch has nothing to build.)"""
        batcher = shard.batcher
        if batcher.prefix_cache is None:
            return
        name = shard.pool.name
        batcher.prefix_cache = IndexedPrefixCache(batcher.prefix_cache, self.index, name)
        batcher.prefix_fetcher = self._make_fetcher(shard)
        self._shards[name] = shard

    # -- admission: the cross-shard fetch ---------------------------------

    def _make_fetcher(self, shard):
        def fetch(hashes, max_pages, free_fn):
            try:
                self._fetch(shard, hashes, max_pages, free_fn)
            except Exception:  # noqa: BLE001 - degrade, never poison
                # a failed fetch falls back to a cold prefill; a
                # TransferFailed escaping here would mark the borrower down
                # for the owner's link fault
                self.fetch_failures += 1

        return fetch

    def _fetch(self, shard, hashes, max_pages, free_fn) -> None:
        batcher = shard.batcher
        name = shard.pool.name
        cache = batcher.prefix_cache
        chain = hashes[:max_pages]
        if not chain:
            return
        local = cache.lookup(chain, len(chain), record=False)
        if len(local) >= len(chain):
            return
        self.cross_shard_lookups += 1
        found = self.index.best_owner(chain, exclude=name, beyond=len(local))
        if found is None:
            return
        owner_name, depth = found
        owner = self._shards.get(owner_name)
        if owner is None:
            return
        owner_cache = owner.batcher.prefix_cache
        # re-resolve against the owner's live cache: the directory is kept
        # coherent, but the cache's own index is the page truth
        owner_pages = owner_cache.lookup(chain, depth, record=False)
        if len(owner_pages) <= len(local):
            return
        fetch_keys = chain[len(local):len(owner_pages)]
        n = len(fetch_keys)
        if n > max(0, int(free_fn())):
            # no headroom for the fetched pages on top of the request's own
            # worst case: a cold prefill beats thrashing
            return
        # pin before moving, so the owner's eviction cannot take the chain
        # mid-move; the pin lasts until the borrower's finish_serve
        pin_keys = chain[:len(owner_pages)]
        owner_cache.acquire(pin_keys)
        pin = self.index.register_pin(owner_name, name, pin_keys)
        src_ids = owner_pages[len(local):]
        try:
            dest = self._move_pages(owner, shard, src_ids, plane="fabric")
        except Exception:
            owner_cache.release(pin_keys)
            self.index.release_pin(pin)
            raise
        # adopt into the borrower's cache: each imported page arrived at
        # refcount 1, the cache's one reference; a collision keeps the
        # resident entry and unrefs the duplicate
        parent = chain[len(local) - 1] if local else None
        adopted: list[bytes] = []
        duplicates: list[int] = []
        for key, page_id in zip(fetch_keys, dest):
            if cache.adopt_entry(key, parent, page_id, live_users=0):
                adopted.append(key)
            else:
                duplicates.append(page_id)
            parent = key
        if duplicates:
            batcher.state = cache_unref_pages(batcher.state, *batcher._page_id_batch(duplicates))
        self.cross_shard_hits += 1
        self.pages_fetched += n
        hits = self.index.record_remote_hit(chain[len(owner_pages) - 1])
        if hits < self.config.replicate_after:
            # cold cross-shard traffic borrows (dropped after the serve); a
            # chain hit this often replicates and stays cached here
            self._borrows.setdefault(name, []).append(adopted)
        else:
            self.replicas += 1

    # -- the raw page hop --------------------------------------------------

    def _move_pages(self, src, dst, page_ids, *, plane: str) -> list[int]:
        """Move ``page_ids`` from ``src``'s pool into ``dst``'s verbatim
        (pool representation: 8-bit layers move values and scales raw),
        each at refcount 1, the receiving cache's one reference. Returns the
        destination page ids, read back once (the host must learn where the
        pages landed). ``plane`` ("fabric" or "mirror") names the hop for
        the transfer engine's per-plane count and the recorder. A decode
        group merges its members' heads on export and slices them on import,
        so both ends speak the full-head format."""
        src_name, dst_name = src.pool.name, dst.pool.name
        n = len(page_ids)
        fr = self.flight_recorder
        ts = time.time() if fr is not None else 0.0
        edge = fr.next_edge() if fr is not None else None
        if edge is not None:
            fr.instant(f"{plane}.send", worker=src_name, dst=dst_name, pages=n, edge=edge)
        t0 = time.perf_counter()
        padded = list(page_ids)
        padded += [padded[-1]] * (-n % self.MOVE_BUCKET)
        chunks_k, chunks_v = src.batcher.export_pages(
            src.batcher._up(np.asarray(padded, np.int64))
        )
        chunks_k, chunks_v = self.transfer.raw_move(
            (chunks_k, chunks_v), dst.batcher.transfer_device,
            src=src_name, dst=dst_name, op=f"{plane}.{src_name}->{dst_name}",
        )
        new_state, dest = dst.batcher.import_pages(
            chunks_k, chunks_v, n, dst.batcher._up(np.ones(len(padded), np.int32))
        )
        dst.batcher.state = new_state
        dest = dest.cpu().numpy()[:n]
        if fr is not None:
            edge_note = {"edge": edge} if edge is not None else {}
            fr.record(plane, ts, time.perf_counter() - t0,
                      worker=dst_name, src=src_name, pages=n, **edge_note)
        return [int(d) for d in dest]

    # -- pin lifecycle -----------------------------------------------------

    def _release_borrower_pins(self, name: str) -> None:
        for pin in self.index.take_pins(borrower=name):
            owner = self._shards.get(pin["owner"])
            if owner is not None:
                owner.batcher.prefix_cache.release(pin["keys"])
            self.pins_released += 1

    def finish_serve(self, shard) -> None:
        """The borrower's serve retired its slots: release its cross-shard
        pins against their owners and drop transient borrows (their cache
        references come off in one unref; a borrowed page a live slot still
        shares survives, ``drop_entries``' own rule)."""
        name = shard.pool.name
        self._release_borrower_pins(name)
        chains = self._borrows.pop(name, None)
        if not chains:
            return
        batcher = shard.batcher
        dropped: list[int] = []
        for keys in chains:
            dropped.extend(batcher.prefix_cache.drop_entries(keys))
        if dropped:
            batcher.state = cache_unref_pages(batcher.state, *batcher._page_id_batch(dropped))
            self.borrows_dropped += len(dropped)

    # -- failure and drain --------------------------------------------------

    def on_worker_down(self, scheduler, name: str):
        """A worker failed: its borrower pins release against the surviving
        owners, pins against its own (dead) pool leave the ledger, the
        directory forgets it, and a mirroring standby is promoted so
        recovery re-admits onto warm pages instead of prefilling again.
        Returns the promoted shard, or None."""
        self._release_borrower_pins(name)
        # the dead worker's pool died with its pins: nothing to release
        self.pins_released += len(self.index.take_pins(owner=name))
        self._borrows.pop(name, None)
        self.index.forget_shard(name)
        self._shards.pop(name, None)
        if self.standby is not None and name == self.standby.pool.name:
            # the standby itself died: discard it, spawn anew at the next sync
            self.standby = None
            self.standby_failures += 1
            return None
        if self.standby is not None:
            return self.promote(scheduler)
        return None

    def promote(self, scheduler):
        """Failover's swap: the mirrored standby joins the routing set as a
        full shard. Recovery then re-admits the dead worker's requests
        against a pool already holding their warm prefix pages: a prefix
        hit plus pin adoption, not a prefill."""
        shard = self.standby
        self.standby = None
        if shard is None:  # pragma: no cover - guarded by callers
            return None
        shard.pool.shard_id = len(scheduler.shards)
        scheduler.shards.append(shard)
        scheduler.pool_view.shards.append(shard.pool)
        if scheduler.failover is not None:
            scheduler.failover.adopt_worker(shard.pool.name)
        if scheduler.instruments is not None:
            scheduler.instruments.shards.set(sum(
                1 for s in scheduler.shards
                if scheduler.failover is None
                or scheduler.failover.state(s.pool.name) not in ("down", "drained")
            ))
        scheduler.pool_view.refresh_gauges(scheduler.instruments)
        self.promotions += 1
        if self.flight_recorder is not None:
            self.flight_recorder.instant(
                "promote", worker=shard.pool.name,
                pages=int(shard.batcher.prefix_cache.page_count),
            )
        # wrapping the (plain, dark) mirror cache publishes every mirrored
        # chain: the promoted shard becomes a fetch owner
        self.attach_shard(shard)
        return shard

    def on_drain(self, name: str, target: str) -> None:
        """A drain migrated ``name``'s pool to ``target``: pins against the
        drained owner repoint there (the chains and their ``live_users``
        moved byte for byte), its own borrows release, and the directory
        forgets it (the migration re-published the chains under ``target``
        through its wrapped cache's ``adopt_entry``)."""
        self._release_borrower_pins(name)
        self.index.rewrite_pin_owner(name, target)
        self._borrows.pop(name, None)
        self.index.forget_shard(name)
        self._shards.pop(name, None)

    # -- the standby mirror --------------------------------------------------

    def sync(self, scheduler) -> None:
        """Between-serves housekeeping: with ``standby`` configured, spawn
        the dark standby on first use and refresh its mirror from every
        attached primary. A standby that dies mid-mirror (a transfer fault
        on its link) is discarded: the primaries were only read, so they
        keep serving, and a fresh standby syncs from live pages at the next
        call."""
        if not self.config.standby:
            return
        from beholder_tpu_torch.cluster.failover import WorkerKilled
        from beholder_tpu_torch.cluster.transfer import TransferFailed

        try:
            if self.standby is None:
                self._spawn_standby(scheduler)
            self.mirror.sync(self.standby, self._mirror_sources(scheduler))
        except (TransferFailed, WorkerKilled):
            self.standby = None
            self.standby_failures += 1

    def _mirror_sources(self, scheduler) -> list:
        up = self._shards
        if scheduler.failover is not None:
            from beholder_tpu_torch.cluster.failover import WORKER_UP

            state = scheduler.failover.state
            return [up[n] for n in sorted(up) if state(up[n].pool.name) == WORKER_UP]
        return [up[n] for n in sorted(up)]

    def _spawn_standby(self, scheduler) -> None:
        """Build the dark standby on the device after the ones in use. A
        standby is single-device even when the primaries are groups: the
        mirror's wire format is full-head either way, and group == single
        bit for bit, so promotion keeps the streams."""
        from beholder_tpu_torch.parallel.mesh import serving_shard_devices

        gcfg = scheduler.cluster.group
        used = scheduler._devices_used * (gcfg.size if gcfg is not None else 1)
        device = serving_shard_devices(used + 1, devices=scheduler._devices)[-1]
        scheduler._devices_used += 1
        n = self.standbys_spawned
        self.standbys_spawned += 1
        # ids apart from decode-<n> until promotion renumbers it; the name
        # marks its origin in health and trace output
        shard = scheduler._build_shard(1000 + n, device, name=f"standby-{n}")
        self._warm_standby(shard)
        self._probe_links(shard)
        self.standby = shard
        if self.flight_recorder is not None:
            self.flight_recorder.instant("standby", worker=shard.pool.name, action="spawn")

    def _warm_standby(self, shard) -> None:
        """Serve the primaries' observed request shapes on the new standby
        (each batcher's ``seen_request_shapes``, at its observed
        concurrency, the last ``MAX_WARM_SHAPES``), cold and then warm, then
        drop the throwaway chains: the mirror starts from an empty cache
        over a pristine pool.

        In the reference this compiles the standby's programs, so that a
        promotion pays no compile inside the recovery wall. Eager PyTorch
        compiles nothing; on the card the replay touches the standby's pool
        and makes cuBLAS and the kernels' first calls for those shapes (the
        kernel libraries are built once a process, at their first launch),
        and no cost of it is claimed here. The replay is kept so the
        standby's counters (ticks, admission rounds, cache lookups) are the
        reference's."""
        from beholder_tpu_torch.models.serving import Request

        batcher = shard.batcher
        shapes: dict[tuple[int, int], int] = {}
        for primary in self._shards.values():
            for key, n in primary.batcher.seen_request_shapes.items():
                shapes[key] = max(shapes.get(key, 0), n)
        if not shapes:
            shapes = {(int(batcher.page_size) + 1, 2): 1}
        replay = sorted(shapes.items())[-self.MAX_WARM_SHAPES:]
        cache = batcher.prefix_cache
        for (width, horizon), n in replay:
            reqs = [
                Request(np.cumsum(np.full(width, 1.0 + 0.25 * i)), np.full(width, 2), horizon)
                for i in range(n)
            ]
            batcher.run(reqs)  # cold: prefill, ticks, retire
            if cache is not None:
                batcher.run(reqs)  # warm: the prefix-hit admission
        if cache is None:  # pragma: no cover - the fabric implies caches
            return
        keys = [key for key, _, _, _ in cache.export_entries()]
        dropped = cache.drop_entries(keys)
        if dropped:
            batcher.state = cache_unref_pages(batcher.state, *batcher._page_id_batch(dropped))

    def _probe_links(self, standby) -> None:
        """One bucket-wide probe move from the standby to each primary, the
        direction a survivor's first fetch from a promoted standby takes
        (the mirror moves the other way). In the reference it compiles that
        export and import; here it exercises the hop once (on the card: the
        gather, the copy and the scatter's first calls at that shape) and no
        cost of it is claimed. The probe page is unref'd on arrival
        (refcount 1 -> 0, back on the free stack), so every pool stays
        pristine; a link fault propagates to :meth:`sync`'s discard."""
        for name in sorted(self._shards):
            primary = self._shards[name]
            dest = self._move_pages(standby, primary, [0], plane="mirror")
            batcher = primary.batcher
            batcher.state = cache_unref_pages(batcher.state, *batcher._page_id_batch(dest))
