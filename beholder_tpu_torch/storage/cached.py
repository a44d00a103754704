"""Memoized storage reads with writer-side invalidation (the port's own
copy of the reference's ``storage/cached.py``).

An extension beyond the original daemon, which queries Postgres on every
message (index.js:76,140). :class:`CachingStorage` wraps any
:class:`~beholder_tpu_torch.storage.base.Storage` backend and serves
``get_by_id`` from a TTL'd keyed cache
(:class:`beholder_tpu_torch.cache.KeyedCache`):

- **Writer-side invalidation.** ``add_media`` / ``update_status`` write
  through to the backend, then invalidate the row's cache entry — the
  next read observes the write. The status consumer's own
  read-after-write (update_status -> get_by_id, index.js:68,76) is
  therefore never stale, while the progress consumer's pure reads (the
  hot path: one ``get_by_id`` per progress message, for rows that
  change only on status transitions) collapse onto the cache.
- **TTL bound on external writers.** A row changed by a DIFFERENT
  process (this service is not the only Postgres client in the triton
  stack) is stale for at most ``ttl_s``.
- **Singleflight.** Concurrent misses on one id issue ONE backend
  query; :class:`~beholder_tpu_torch.storage.base.MediaNotFound` propagates
  to every collapsed caller and is never cached (a row inserted a
  moment later must be findable).

The service wires this behind ``instance.cache.storage`` (off unless
``instance.cache.enabled``); constructed directly it works over any
backend (the Postgres query-cache tests run it against the wire client and
:class:`~beholder_tpu_torch.storage.pg_server.PgTestServer`).
"""

from __future__ import annotations

from beholder_tpu_torch import proto
from beholder_tpu_torch.cache import KeyedCache

from .base import Storage


class CachingStorage(Storage):
    """Read-through cache over a ``Storage`` backend."""

    def __init__(
        self,
        inner: Storage,
        ttl_s: float = 30.0,
        max_entries: int = 1024,
        metrics=None,
        clock=None,
    ):
        self.inner = inner
        kwargs = {"clock": clock} if clock is not None else {}
        self._cache = KeyedCache(
            "storage.media",
            max_entries=max_entries,
            policy="ttl",
            ttl_s=ttl_s,
            metrics=metrics,
            **kwargs,
        )

    @property
    def cache(self) -> KeyedCache:
        return self._cache

    def add_media(self, media: proto.Media) -> None:
        self.inner.add_media(media)
        self._cache.invalidate(media.id)

    def update_status(self, media_id: str, status: int) -> None:
        self.inner.update_status(media_id, status)
        self._cache.invalidate(media_id)

    def update_status_batch(
        self, updates: list[tuple[str, int]]
    ) -> list[bool]:
        """The batched-ingest write hop, FORWARDED to the backend's
        one-transaction implementation with write-through invalidation
        per touched row — the base-class default would fall back to
        the per-row loop, silently unfolding exactly the transaction
        the native ingest path batched (the ROADMAP item-4 leftover).
        Rows invalidate whether found or not: a row inserted between
        this write and the next read must never be shadowed by a
        cached MISS-era value, and invalidating an absent key is
        free."""
        found = self.inner.update_status_batch(updates)
        for media_id, _ in updates:
            self._cache.invalidate(media_id)
        return found

    def get_by_id(self, media_id: str) -> proto.Media:
        # a defensive copy per call: Media is a mutable protobuf and a
        # caller mutating the returned row must not poison the cache
        row = self._cache.get_or_load(
            media_id, lambda: self.inner.get_by_id(media_id)
        )
        clone = proto.Media()
        clone.CopyFrom(row)
        return clone

    def get_by_ids(self, media_ids) -> dict[str, proto.Media]:
        """The batched-ingest read hop: cached rows serve from memory,
        the MISSES fetch in ONE backend ``get_by_ids`` round trip (the
        base default would loop ``get_by_id`` per id — correct, but
        per-row again), and every fetched row populates the cache for
        the per-message handlers that re-read it. Defensive copies
        both ways, same contract as :meth:`get_by_id`: the caller's
        mutations must not poison the cache, and missing ids are
        simply absent."""
        out: dict[str, proto.Media] = {}
        misses: list[str] = []
        for media_id in media_ids:
            row = self._cache.get(media_id)
            if row is None:
                misses.append(media_id)
            else:
                clone = proto.Media()
                clone.CopyFrom(row)
                out[media_id] = clone
        if misses:
            fetched = self.inner.get_by_ids(misses)
            for media_id, row in fetched.items():
                cached = proto.Media()
                cached.CopyFrom(row)
                self._cache.put(media_id, cached)
                clone = proto.Media()
                clone.CopyFrom(row)
                out[media_id] = clone
        return out

    def invalidate(self, media_id: str) -> None:
        """Explicit invalidation hook for out-of-band writers."""
        self._cache.invalidate(media_id)

    def close(self) -> None:
        self.inner.close()
