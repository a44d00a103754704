"""Host-side caches of the port: the automatic prefix cache."""

from .prefix import PrefixCache, page_hashes

__all__ = ["PrefixCache", "page_hashes"]
