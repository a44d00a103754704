"""Media storage — the triton-core Storage contract (the port's own copy of
the reference's ``storage/``).

The reference calls two methods, ``update_status(media_id, status)`` and
``get_by_id(media_id)``; the batched ingest path adds
``update_status_batch`` (one transaction per drained batch) and
``get_by_ids`` (one read per batch). Backends: :class:`MemoryStorage` (dict-backed,
for tests) and :class:`SqliteStorage` (the durable single-file default).
Rows are :class:`beholder_tpu_torch.proto.Media` messages.

Not ported: the Postgres backend (its wire client and test server) and the
caching wrapper.
"""

from .base import MediaNotFound, MemoryStorage, Storage
from .sqlite import SqliteStorage

__all__ = ["Storage", "MemoryStorage", "SqliteStorage", "MediaNotFound"]
