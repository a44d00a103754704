"""Standby-replica page mirroring.

The standby shard's own prefix cache is the mirror's state: each
:meth:`StandbyMirror.sync` diffs every primary's prefix-cache index against
what the standby caches, moves only the pages it lacks (pool
representation, verbatim, through the fabric's page hop), and drops the
entries no primary caches any more (a mirror must follow evictions, or it
keeps dead prefixes holding real pages).

The standby stays dark: it owns no slots, serves no requests, holds every
mirrored page at the cache's one reference with ``live_users=0``, and its
cache is a plain :class:`~beholder_tpu_torch.cache.PrefixCache` (never
published into the global directory), so it is never a fetch owner or a
mirror source. Promotion (:meth:`~.engine.FabricEngine.promote`) turns the
mirror into serving state: recovered requests re-admit against the warm
cache, pin adoption instead of a prefill.

Mirroring runs between serves (the router's sync point), where the
primaries' pools are settled: a live slot's pages can be derived again from
its request, while the prefix cache is the state that is costly to rebuild.
"""

from __future__ import annotations

from beholder_tpu_torch.models.serving import cache_unref_pages


class StandbyMirror:
    """Page mirroring onto the dark standby shard."""

    def __init__(self, engine):
        self.engine = engine
        self.mirrored_pages = 0
        self.stale_dropped = 0
        #: pages a sync could not place for lack of standby headroom
        #: (counted, never capped silently)
        self.skipped_pages = 0
        self.syncs = 0

    def sync(self, standby, primaries: list) -> None:
        """One mirror pass: per primary, move the pages the standby does not
        cache yet (parent first: any prefix of an export is closed under
        parents, so a headroom cut still adopts valid chains), then drop the
        standby's entries no primary indexes any more. The standby's free
        page count is read back from the card once a primary with fresh
        pages."""
        cache = standby.batcher.prefix_cache
        if cache is None:  # pragma: no cover - factory-less cluster
            return
        batcher = standby.batcher
        union: set[bytes] = set()
        for shard in primaries:
            src_cache = shard.batcher.prefix_cache
            if src_cache is None:
                continue
            entries = src_cache.export_entries()
            union.update(key for key, _, _, _ in entries)
            fresh = [
                (key, parent, page_id)
                for key, parent, page_id, _ in entries
                if key not in cache._entries
            ]
            if not fresh:
                continue
            free = int(batcher.state.free_top)
            if len(fresh) > free:
                self.skipped_pages += len(fresh) - free
                fresh = fresh[:free]
            if not fresh:
                continue
            dest = self.engine._move_pages(
                shard, standby, [pid for _, _, pid in fresh], plane="mirror"
            )
            duplicates: list[int] = []
            for (key, parent, _), new_id in zip(fresh, dest):
                if not cache.adopt_entry(key, parent, new_id, live_users=0):
                    duplicates.append(new_id)
            if duplicates:  # pragma: no cover - keys were diffed above
                batcher.state = cache_unref_pages(
                    batcher.state, *batcher._page_id_batch(duplicates)
                )
            self.mirrored_pages += len(fresh)
        stale = [key for key in list(cache._entries) if key not in union]
        if stale:
            dropped = cache.drop_entries(stale)
            if dropped:
                batcher.state = cache_unref_pages(
                    batcher.state, *batcher._page_id_batch(dropped)
                )
                self.stale_dropped += len(dropped)
        self.syncs += 1
