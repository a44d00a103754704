"""Host-side caches of the port: the automatic prefix cache and its metric
catalog."""

from .instruments import PrefixCacheMetrics
from .prefix import PrefixCache, page_hashes

__all__ = ["PrefixCache", "PrefixCacheMetrics", "page_hashes"]
