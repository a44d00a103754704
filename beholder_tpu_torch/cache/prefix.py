"""Automatic prefix cache: a radix index over admitted token prefixes.

The port's own copy of the reference's ``cache/prefix.py`` (host-side
bookkeeping only, no JAX there either; the port imports nothing of the JAX
package). Two requests with the same page-aligned prompt prefix share pool
pages: the second admit looks up the longest cached chain, takes a
reference on those pages and prefills only the uncached suffix
(:func:`beholder_tpu_torch.models.serving.paged_admit_with_prefix`).

**The index is a radix tree collapsed via chained page hashes**: page ``i``
of a prefix is keyed by ``H(parent_key, feature_bytes_of_page_i)``, so one
flat dict encodes the whole trie and a key can only match when every
ancestor page matched too. Only FULL pages are cached (a partial tail page
receives decode writes; full prefix pages are read-only because a slot only
writes at its own length). The keys are byte-identical to the reference's
for the same features.

**Refcount contract with the device allocator.** The cache holds ONE device
reference on every cached page. A slot adopting cached pages takes its own
reference on top; slot release drops only the slot's, so cached pages
survive retirement as "cold" entries at refcount 1. Eviction drops the
cache's reference through the allocator's vectorized unref, so a page still
shared with a live or forked slot is never reclaimed by eviction.

Eviction picks cold (``live_users == 0``) LEAF entries in LRU order, so
every indexed key keeps its full ancestor chain.

A cluster drain moves the index with the pages: :meth:`PrefixCache.
export_entries` lists it parent-first, :meth:`PrefixCache.adopt_entry`
re-roots each entry on the destination pool, and :meth:`PrefixCache.
drop_entries` forgets chosen chains.
"""

from __future__ import annotations

import hashlib
import heapq

import numpy as np

from .instruments import PrefixCacheMetrics


class _PageEntry:
    __slots__ = (
        "key", "parent", "page_id", "children", "live_users", "stamp"
    )

    def __init__(self, key: bytes, parent: bytes | None, page_id: int):
        self.key = key
        self.parent = parent
        self.page_id = int(page_id)
        self.children = 0       # cached direct descendants
        self.live_users = 0     # slots currently holding this page
        self.stamp = 0          # LRU recency (monotonic)


def page_hashes(feats: np.ndarray, page_size: int) -> list[bytes]:
    """Chained content hashes for every FULL page of a feature prefix.

    ``feats`` is the request's (t, F) float32 feature matrix (the exact
    array handed to prefill); page ``i`` covers rows
    ``[i*page_size, (i+1)*page_size)``. Chaining makes each key encode
    its whole ancestry, so equal keys imply equal full prefixes."""
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    n_full = feats.shape[0] // page_size
    out: list[bytes] = []
    parent = b"root"
    for i in range(n_full):
        chunk = feats[i * page_size : (i + 1) * page_size]
        parent = hashlib.sha1(parent + chunk.tobytes()).digest()
        out.append(parent)
    return out


class PrefixCache:
    """Host-side radix index: chained page hash -> pool page id.

    Pure bookkeeping — the owner (``ContinuousBatcher``) performs the
    matching device refcount operations and tells the cache what
    happened. ``metrics`` (a registry) registers the
    ``beholder_prefix_cache_*`` series; plain int counters record hits,
    misses, evictions and prefilled tokens either way.
    """

    def __init__(self, page_size: int, metrics=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self._entries: dict[bytes, _PageEntry] = {}
        self._stamp = 0
        self._metrics = PrefixCacheMetrics(metrics) if metrics is not None else None
        self.hits = 0           # admits reusing >= 1 cached page
        self.misses = 0         # admits reusing none
        self.evictions = 0      # pages reclaimed
        self.hit_tokens = 0     # tokens served from cached pages
        self.prefill_tokens = 0  # tokens actually prefilled

    # -- introspection -------------------------------------------------------
    @property
    def page_count(self) -> int:
        """Pages the cache holds a device reference on."""
        return len(self._entries)

    @property
    def page_ids(self) -> set[int]:
        """Pool page ids currently indexed. Introspection for tests and
        safety assertions — the speculative-decoding rollback stress
        test uses it to pin that a rejected-suffix rollback never frees
        a page the cache still indexes (rollback only ever truncates
        DECODE-time pages, which are never inserted into the index; the
        device refcount enforces the same invariant independently)."""
        return {e.page_id for e in self._entries.values()}

    @property
    def cold_page_count(self) -> int:
        """Cached pages with no live slot user — the pool headroom the
        cache could surrender under pressure (an upper bound: a cold
        page shared with a forked slot frees nothing until that slot
        retires; the device refcount owns that truth)."""
        return sum(1 for e in self._entries.values() if e.live_users == 0)

    def hashes(self, feats: np.ndarray) -> list[bytes]:
        return page_hashes(feats, self.page_size)

    # -- lookup / admission --------------------------------------------------
    def lookup(
        self, hashes: list[bytes], max_pages: int, record: bool = True
    ) -> list[int]:
        """Longest cached chain over ``hashes`` (capped at ``max_pages``
        so at least one real token is always left to prefill — the admit
        needs a live forward pass for its prediction). Returns the
        matched pages' pool ids, root-first.

        ``record=True`` counts one hit or miss immediately; the batcher
        passes ``record=False`` and calls :meth:`record_admit` only once
        the claim actually lands — a request deferred under pool
        pressure is re-looked-up every scheduling round, and counting
        each probe would inflate the hit series exactly in the pressured
        workloads the counters exist to measure."""
        pages: list[int] = []
        self._stamp += 1
        for key in hashes[:max_pages]:
            entry = self._entries.get(key)
            if entry is None:
                break
            entry.stamp = self._stamp
            pages.append(entry.page_id)
        if record:
            self.record_admit(pages)
        return pages

    def record_admit(self, hit_pages: list[int]) -> None:
        """Count one admission outcome: a hit (>= 1 page reused, with
        its reused-token volume) or a miss."""
        if hit_pages:
            self.hits += 1
            self.hit_tokens += len(hit_pages) * self.page_size
            if self._metrics is not None:
                self._metrics.hits_total.inc()
                self._metrics.hit_tokens_total.inc(len(hit_pages) * self.page_size)
        else:
            self.misses += 1
            if self._metrics is not None:
                self._metrics.misses_total.inc()

    def acquire(self, hashes: list[bytes]) -> None:
        """Mark a slot as a live user of this chain (call after the slot
        adopted/inserted these pages); pairs with :meth:`release`."""
        for key in hashes:
            self._entries[key].live_users += 1

    def release(self, hashes: list[bytes]) -> None:
        """Drop a retired slot's liveness marks; fully-cold chains become
        eviction candidates (the pages themselves stay cached)."""
        for key in hashes:
            entry = self._entries.get(key)
            if entry is not None:
                entry.live_users -= 1

    def insert(
        self, hashes: list[bytes], page_ids: list[int]
    ) -> tuple[list[int], list[bytes]]:
        """Index freshly prefilled full pages. ``hashes[i]`` must chain
        from ``hashes[i-1]`` (or the root) and ``page_ids[i]`` is the
        pool page now holding that content. Keys already cached are
        skipped (their existing page keeps serving; the duplicate page
        stays owned by the inserting slot alone and frees on its
        release). Returns (newly indexed page ids, their keys) — the
        caller must take ONE device reference on exactly those pages."""
        new_pages: list[int] = []
        new_keys: list[bytes] = []
        parent: bytes | None = None
        self._stamp += 1
        for key, page_id in zip(hashes, page_ids):
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _PageEntry(key, parent, page_id)
                if parent is not None and parent in self._entries:
                    self._entries[parent].children += 1
                new_pages.append(int(page_id))
                new_keys.append(key)
            entry.stamp = self._stamp
            parent = key
        if self._metrics is not None:
            self._metrics.cached_pages.set(len(self._entries))
        return new_pages, new_keys

    # -- migration (cluster drain) -------------------------------------------
    def export_entries(self) -> list[tuple[bytes, bytes | None, int, int]]:
        """Every entry as ``(key, parent, page_id, live_users)``, parent
        first (:func:`beholder_tpu_torch.cluster.failover.migrate_pool`), so
        :meth:`adopt_entry` never sees a child before its ancestor."""
        emitted: set[bytes | None] = {None}
        out: list[tuple[bytes, bytes | None, int, int]] = []
        remaining = dict(self._entries)
        while remaining:
            progressed = False
            for key in list(remaining):
                entry = remaining[key]
                parent = entry.parent
                # a parent outside the index counts as emitted
                if parent in emitted or parent not in self._entries:
                    out.append((key, parent, entry.page_id, entry.live_users))
                    emitted.add(key)
                    del remaining[key]
                    progressed = True
            if not progressed:  # pragma: no cover - defensive
                raise RuntimeError("prefix-cache index has a parent cycle")
        return out

    def adopt_entry(
        self, key: bytes, parent: bytes | None, page_id: int, live_users: int = 0
    ) -> bool:
        """Adopt one migrated entry with :meth:`insert`'s collision rule: a
        key already cached here keeps its page (returns False, and the
        caller drops the cache's reference on the duplicate migrated page);
        otherwise the entry lands with its pins (``live_users``), and its
        one device reference rides the migrated refcount."""
        if key in self._entries:
            return False
        entry = self._entries[key] = _PageEntry(key, parent, page_id)
        entry.live_users = int(live_users)
        self._stamp += 1
        entry.stamp = self._stamp
        if parent is not None and parent in self._entries:
            self._entries[parent].children += 1
        if self._metrics is not None:
            self._metrics.cached_pages.set(len(self._entries))
        return True

    def drop_entries(self, keys) -> list[int]:
        """Forget specific cached chains, tip first over ``reversed(keys)``.
        Pinned entries (``live_users != 0``), entries with cached descendants
        and absent keys are skipped, as :meth:`evict` would. Returns the
        dropped page ids; the caller releases the cache's one device
        reference on each."""
        out: list[int] = []
        for key in reversed(list(keys)):
            entry = self._entries.get(key)
            if entry is None or entry.live_users != 0 or entry.children != 0:
                continue
            del self._entries[key]
            if entry.parent is not None:
                parent = self._entries.get(entry.parent)
                if parent is not None:
                    parent.children -= 1
            out.append(entry.page_id)
        if out and self._metrics is not None:
            self._metrics.cached_pages.set(len(self._entries))
        return out

    def prefilled(self, n_tokens: int) -> None:
        """Record tokens actually run through the prefill forward."""
        self.prefill_tokens += int(n_tokens)
        if self._metrics is not None:
            self._metrics.prefill_tokens_total.inc(int(n_tokens))

    # -- eviction ------------------------------------------------------------
    def evict(self, n_pages: int) -> list[int]:
        """Surrender up to ``n_pages`` cold pages, LRU leaf-first (an
        interior entry becomes a leaf, and thus evictable, once its
        cached descendants go). Returns the evicted pool page ids — the
        caller must drop the cache's ONE device reference on each; the
        allocator only returns a page to the free stack when no live
        slot still shares it (the refcount invariant the stress test
        pins).

        One scan builds a min-heap of cold leaves by recency; cascade
        (a parent becoming a cold leaf) pushes as it goes — O((e + k)
        log e) rather than a full rescan per evicted page, since this
        runs inside the admission loop at the worst possible time."""
        heap = [
            (e.stamp, e.key)
            for e in self._entries.values()
            if e.live_users == 0 and e.children == 0
        ]
        heapq.heapify(heap)
        out: list[int] = []
        while heap and len(out) < n_pages:
            stamp, key = heapq.heappop(heap)
            victim = self._entries.get(key)
            if (
                victim is None
                or victim.stamp != stamp  # touched since pushed
                or victim.live_users != 0
                or victim.children != 0
            ):
                continue
            del self._entries[key]
            if victim.parent is not None:
                parent = self._entries.get(victim.parent)
                if parent is not None:
                    parent.children -= 1
                    if parent.children == 0 and parent.live_users == 0:
                        heapq.heappush(heap, (parent.stamp, parent.key))
            out.append(victim.page_id)
        if out:
            self.evictions += len(out)
            if self._metrics is not None:
                self._metrics.evictions_total.inc(len(out))
                self._metrics.cached_pages.set(len(self._entries))
        return out
