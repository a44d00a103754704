"""The prefix cache's metric catalog (the serving half of the reference's
``cache/instruments.py``).

Nothing is registered unless a :class:`~beholder_tpu_torch.cache.PrefixCache`
is handed a registry; every series goes through
:func:`~beholder_tpu_torch.metrics.get_or_create`:

- ``beholder_prefix_cache_hits_total`` — admits that reused >= 1 cached page;
- ``beholder_prefix_cache_misses_total`` — admits that reused none;
- ``beholder_prefix_cache_evictions_total`` — cached pages reclaimed under
  pool pressure;
- ``beholder_prefix_cache_cached_pages`` — pages the cache holds (gauge);
- ``beholder_prefix_cache_hit_tokens_total`` — prefix tokens not
  re-prefilled thanks to a hit;
- ``beholder_prefix_cache_prefill_tokens_total`` — tokens run through the
  prefill forward.

Not ported: ``CacheMetrics``, the keyed response cache's catalog.
"""

from __future__ import annotations

from beholder_tpu_torch.metrics import get_or_create


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
