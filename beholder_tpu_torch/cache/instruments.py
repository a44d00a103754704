"""The caching subsystem's metric catalog (the port's own copy of the
reference's ``cache/instruments.py``).

Nothing is registered unless a cache is handed a registry, so the default
exposition stays byte-identical. Every series goes through
:func:`~beholder_tpu_torch.metrics.get_or_create`, so many caches sharing one
registry share one set of labelled series instead of tripping the duplicate
guard.

Keyed-cache core (label ``cache`` = the cache's name: ``storage.media``,
``http.get``, ``httpd.response``):

- ``beholder_cache_hits_total{cache}`` — lookups served from the cache;
- ``beholder_cache_misses_total{cache}`` — lookups that fell through;
- ``beholder_cache_evictions_total{cache, reason}`` — entries dropped
  (``capacity`` / ``ttl``);
- ``beholder_cache_invalidations_total{cache}`` — explicit writer-side
  invalidations (a correctness event, not an eviction);
- ``beholder_cache_singleflight_collapsed_total{cache}`` — concurrent
  duplicate loads collapsed into one underlying call;
- ``beholder_cache_entries{cache}`` / ``beholder_cache_bytes{cache}`` —
  current occupancy gauges.

Serving prefix cache (one per process; no label — one batcher owns it):

- ``beholder_prefix_cache_hits_total`` — admits that reused >= 1 cached page;
- ``beholder_prefix_cache_misses_total`` — admits that reused none;
- ``beholder_prefix_cache_evictions_total`` — cached pages reclaimed under
  pool pressure;
- ``beholder_prefix_cache_cached_pages`` — pages the cache holds (gauge);
- ``beholder_prefix_cache_hit_tokens_total`` — prefix tokens not
  re-prefilled thanks to a hit;
- ``beholder_prefix_cache_prefill_tokens_total`` — tokens run through the
  prefill forward.
"""

from __future__ import annotations

from beholder_tpu_torch.metrics import get_or_create

#: eviction reasons (the ``reason`` label's vocabulary)
EVICT_CAPACITY = "capacity"
EVICT_TTL = "ttl"


class CacheMetrics:
    """The keyed-cache series above, find-or-registered on a shared
    registry (a :class:`~beholder_tpu_torch.metrics.Registry`, or a
    :class:`~beholder_tpu_torch.metrics.Metrics` whose registry is used),
    bound to one ``cache`` label value."""

    def __init__(self, registry, cache: str):
        registry = getattr(registry, "registry", registry)
        self.registry = registry
        self.cache = cache
        self.hits_total = get_or_create(
            registry, "counter",
            "beholder_cache_hits_total",
            "Cache lookups served from the cache, by cache name",
            labelnames=["cache"],
        )
        self.misses_total = get_or_create(
            registry, "counter",
            "beholder_cache_misses_total",
            "Cache lookups that fell through to the loader, by cache name",
            labelnames=["cache"],
        )
        self.evictions_total = get_or_create(
            registry, "counter",
            "beholder_cache_evictions_total",
            "Cache entries dropped, by cache name and reason "
            "(capacity/ttl)",
            labelnames=["cache", "reason"],
        )
        self.invalidations_total = get_or_create(
            registry, "counter",
            "beholder_cache_invalidations_total",
            "Explicit writer-side cache invalidations, by cache name",
            labelnames=["cache"],
        )
        self.singleflight_collapsed_total = get_or_create(
            registry, "counter",
            "beholder_cache_singleflight_collapsed_total",
            "Concurrent duplicate loads collapsed into one underlying "
            "call, by cache name",
            labelnames=["cache"],
        )
        self.entries = get_or_create(
            registry, "gauge",
            "beholder_cache_entries",
            "Entries currently held, by cache name",
            labelnames=["cache"],
        )
        self.bytes = get_or_create(
            registry, "gauge",
            "beholder_cache_bytes",
            "Approximate bytes currently held, by cache name",
            labelnames=["cache"],
        )

    # bound-label conveniences (hot paths go through these)
    def hit(self) -> None:
        self.hits_total.inc(cache=self.cache)

    def miss(self) -> None:
        self.misses_total.inc(cache=self.cache)

    def evicted(self, reason: str) -> None:
        self.evictions_total.inc(cache=self.cache, reason=reason)

    def invalidated(self) -> None:
        self.invalidations_total.inc(cache=self.cache)

    def collapsed(self) -> None:
        self.singleflight_collapsed_total.inc(cache=self.cache)

    def occupancy(self, entries: int, size_bytes: float) -> None:
        self.entries.set(entries, cache=self.cache)
        self.bytes.set(size_bytes, cache=self.cache)


class PrefixCacheMetrics:
    """The serving prefix cache's series (one per process)."""

    def __init__(self, registry):
        registry = getattr(registry, "registry", registry)
        self.registry = registry
        self.hits_total = get_or_create(
            registry, "counter",
            "beholder_prefix_cache_hits_total",
            "Admitted requests that reused at least one cached KV page",
        )
        self.misses_total = get_or_create(
            registry, "counter",
            "beholder_prefix_cache_misses_total",
            "Admitted requests that reused no cached KV page",
        )
        self.evictions_total = get_or_create(
            registry, "counter",
            "beholder_prefix_cache_evictions_total",
            "Cached KV pages reclaimed under pool pressure",
        )
        self.cached_pages = get_or_create(
            registry, "gauge",
            "beholder_prefix_cache_cached_pages",
            "KV pages currently held by the prefix cache",
        )
        self.hit_tokens_total = get_or_create(
            registry, "counter",
            "beholder_prefix_cache_hit_tokens_total",
            "Prefix tokens served from cached pages instead of prefill",
        )
        self.prefill_tokens_total = get_or_create(
            registry, "counter",
            "beholder_prefix_cache_prefill_tokens_total",
            "Tokens actually run through the prefill forward",
        )
