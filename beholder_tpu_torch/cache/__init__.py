"""Host-side caches of the port (its own copy of the reference's ``cache/``).

- :mod:`.core` — a policy-pluggable (LRU/LFU/TTL) keyed cache with byte and
  entry capacity, singleflight duplicate-load collapse and writer-side
  invalidation. Used by the storage read cache
  (:mod:`beholder_tpu_torch.storage.cached`), the outbound lookup cache
  (:class:`beholder_tpu_torch.clients.http.CachingTransport`) and the
  endpoint response cache (:class:`beholder_tpu_torch.httpd.CachedRoute`).
- :mod:`.prefix` — the serving layer's automatic prefix cache.
- :mod:`.instruments` — the metric catalog, registered only on demand.

Everything here is opt-in: with caching off, behaviour is byte-identical to
the uncached paths.
"""

from .core import (
    EvictionPolicy,
    KeyedCache,
    LFUPolicy,
    LRUPolicy,
    SingleFlight,
    TTLPolicy,
)
from .instruments import CacheMetrics, PrefixCacheMetrics
from .prefix import PrefixCache, page_hashes

__all__ = [
    "KeyedCache",
    "SingleFlight",
    "EvictionPolicy",
    "LRUPolicy",
    "LFUPolicy",
    "TTLPolicy",
    "PrefixCache",
    "page_hashes",
    "CacheMetrics",
    "PrefixCacheMetrics",
]
