"""Media storage — the triton-core Storage contract (the port's own copy of
the reference's ``storage/``).

The reference calls two methods, ``update_status(media_id, status)`` and
``get_by_id(media_id)``; the batched ingest path adds
``update_status_batch`` (one transaction per drained batch) and
``get_by_ids`` (one read per batch). Backends:

- :class:`MemoryStorage` — dict-backed, for tests;
- :class:`SqliteStorage` — the durable single-file default;
- :class:`PostgresStorage` — the production shape, over a from-scratch v3
  wire-protocol client (:mod:`.pg_wire`; SCRAM-SHA-256 on the standard
  library), tested against :class:`.pg_server.PgTestServer` over real
  sockets;
- :class:`CachingStorage` — a read-through TTL cache over any backend with
  writer-side invalidation and singleflight (:mod:`.cached`;
  ``instance.cache.storage``).

Rows are :class:`beholder_tpu_torch.proto.Media` messages.
"""

from .base import MediaNotFound, MemoryStorage, Storage, postgres_storage
from .cached import CachingStorage
from .postgres import PostgresStorage
from .sqlite import SqliteStorage

__all__ = [
    "Storage",
    "MemoryStorage",
    "SqliteStorage",
    "PostgresStorage",
    "CachingStorage",
    "MediaNotFound",
    "postgres_storage",
]
