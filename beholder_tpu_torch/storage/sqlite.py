"""SQLite-backed storage — the durable default (the port's own copy of the
reference's ``storage/sqlite.py``, same schema: a database file either
side writes reads the same in the other).

The reference's rows live in an external Postgres owned by triton-core
(schema not in the reference repo); this backend persists the same
observable fields the handlers read, keyed by media id.
"""

from __future__ import annotations

import sqlite3
import threading

from beholder_tpu_torch import proto

from .base import MediaNotFound, Storage

_SCHEMA = """
CREATE TABLE IF NOT EXISTS media (
    id          TEXT PRIMARY KEY,
    name        TEXT NOT NULL DEFAULT '',
    creator     INTEGER NOT NULL DEFAULT 0,
    creator_id  TEXT NOT NULL DEFAULT '',
    metadata_id TEXT NOT NULL DEFAULT '',
    status      INTEGER NOT NULL DEFAULT 0
);
"""


class SqliteStorage(Storage):
    def __init__(self, path: str = "beholder.db"):
        # The service's consumers run on one dispatch thread, but allow
        # cross-thread use (metrics server, tools) with a lock.
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock, self._conn:
            # WAL + NORMAL: one fsync per checkpoint instead of per commit.
            # Status updates are idempotent telemetry (the producer re-sends
            # state transitions), so power-loss durability of the last few
            # commits is not worth a ~50x throughput cliff on the hot path.
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(_SCHEMA)

    def add_media(self, media: proto.Media) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO media "
                "(id, name, creator, creator_id, metadata_id, status) "
                "VALUES (?, ?, ?, ?, ?, ?)",
                (
                    media.id,
                    media.name,
                    media.creator,
                    media.creatorId,
                    media.metadataId,
                    media.status,
                ),
            )

    def update_status(self, media_id: str, status: int) -> None:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE media SET status = ? WHERE id = ?", (status, media_id)
            )
            if cur.rowcount == 0:
                raise MediaNotFound(media_id)

    def update_status_batch(
        self, updates: list[tuple[str, int]]
    ) -> list[bool]:
        """One transaction per drained ingest batch: the per-message
        loop pays a WAL commit per status update — the commit, not the
        UPDATE, is the storage hop's fixed cost. Rows execute in order
        (a later duplicate id wins, like the per-message loop) and
        per-row found flags preserve the MediaNotFound outcomes."""
        found: list[bool] = []
        with self._lock, self._conn:
            execute = self._conn.execute
            for media_id, status in updates:
                cur = execute(
                    "UPDATE media SET status = ? WHERE id = ?",
                    (status, media_id),
                )
                found.append(cur.rowcount != 0)
        return found

    def get_by_id(self, media_id: str) -> proto.Media:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, name, creator, creator_id, metadata_id, status "
                "FROM media WHERE id = ?",
                (media_id,),
            ).fetchone()
        if row is None:
            raise MediaNotFound(media_id)
        return proto.Media(
            id=row[0],
            name=row[1],
            creator=row[2],
            creatorId=row[3],
            metadataId=row[4],
            status=row[5],
        )

    def get_by_ids(self, media_ids) -> dict[str, proto.Media]:
        """One ``IN`` query per drained ingest batch instead of one
        SELECT round trip per message (missing ids absent, per the base
        contract)."""
        ids = list(dict.fromkeys(media_ids))  # de-dupe, keep order
        if not ids:
            return {}
        placeholders = ",".join("?" * len(ids))
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, name, creator, creator_id, metadata_id, status "
                f"FROM media WHERE id IN ({placeholders})",
                ids,
            ).fetchall()
        return {
            row[0]: proto.Media(
                id=row[0],
                name=row[1],
                creator=row[2],
                creatorId=row[3],
                metadataId=row[4],
                status=row[5],
            )
            for row in rows
        }

    def close(self) -> None:
        self._conn.close()
