"""Postgres-backed Storage on the from-scratch wire client (the port's own
copy of the reference's ``storage/postgres.py``).

The original daemon's production storage (index.js:19,42 via
triton-core's ``pg``). Same three-method contract as every backend here;
the table is reconstructed from the fields the daemon reads and writes
(index.js:64,68,74-118,131-148: id, name, creator, creatorId,
metadataId, status).

Elastic recovery: when the wire client poisons its connection (server
restart, network fault — any :class:`ProtocolError`), the storage
reconnects with bounded exponential backoff and re-runs the statement,
mirroring the AMQP client's reconnect design (``mq/amqp.py``). Retrying
is safe because every statement here is idempotent: the upsert, the
absolute status UPDATE, and the SELECT all converge on re-execution.
"""

from __future__ import annotations

import time

from beholder_tpu_torch import proto

from .base import MediaNotFound, Storage
from .pg_wire import PgConnection, ProtocolError

_SCHEMA = """
CREATE TABLE IF NOT EXISTS media (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL DEFAULT '',
    creator INT NOT NULL DEFAULT 0,
    creator_id TEXT NOT NULL DEFAULT '',
    metadata_id TEXT NOT NULL DEFAULT '',
    status INT NOT NULL DEFAULT 0
)
"""


class PostgresStorage(Storage):
    """``Storage`` over a real Postgres (or wire-compatible) server."""

    def __init__(
        self,
        url: str,
        connect_timeout: float = 10.0,
        reconnect_attempts: int = 3,
        reconnect_delay: float = 0.05,
    ):
        self._conn = PgConnection(url, connect_timeout=connect_timeout)
        self._attempts = reconnect_attempts
        self._delay = reconnect_delay
        self._connect()

    def _connect(self) -> None:
        self._conn.connect()
        self._conn.execute(_SCHEMA)  # idempotent; safe on every reconnect

    def _run(self, fn):
        """Run a statement; on a poisoned connection, reconnect with
        bounded exponential backoff and re-run (statements here are all
        idempotent — see module docstring)."""
        try:
            return fn()
        except ProtocolError as err:
            last: Exception = err
        for attempt in range(self._attempts):
            time.sleep(self._delay * (2**attempt))
            try:
                self._conn.close()
                self._connect()
                return fn()
            except (ProtocolError, OSError) as err:
                last = err
        raise last

    def add_media(self, media: proto.Media) -> None:
        self._run(lambda: self._query_add(media))

    def _query_add(self, media: proto.Media) -> None:
        self._conn.query(
            "INSERT INTO media (id, name, creator, creator_id, metadata_id, status) "
            "VALUES ($1, $2, $3, $4, $5, $6) "
            "ON CONFLICT (id) DO UPDATE SET name = $2, creator = $3, "
            "creator_id = $4, metadata_id = $5, status = $6",
            (
                media.id,
                media.name,
                int(media.creator),
                media.creatorId,
                media.metadataId,
                int(media.status),
            ),
        )

    def update_status(self, media_id: str, status: int) -> None:
        _, _, tag = self._run(
            lambda: self._conn.query(
                "UPDATE media SET status = $1 WHERE id = $2",
                (int(status), media_id),
            )
        )
        if tag.endswith(" 0"):  # "UPDATE 0" — no row matched
            raise MediaNotFound(media_id)

    def update_status_batch(
        self, updates: list[tuple[str, int]]
    ) -> list[bool]:
        """One BEGIN/COMMIT per drained ingest batch instead of one
        autocommit per message. Statements run in order inside the
        transaction; per-row "UPDATE 0" tags become found flags (the
        MediaNotFound outcomes the per-message loop produces). The
        whole batch shares one :meth:`_run` retry scope — absolute
        status updates are idempotent, so a reconnect replays the batch
        safely."""

        def run() -> list[bool]:
            self._conn.execute("BEGIN")
            try:
                found: list[bool] = []
                for media_id, status in updates:
                    _, _, tag = self._conn.query(
                        "UPDATE media SET status = $1 WHERE id = $2",
                        (int(status), media_id),
                    )
                    found.append(not tag.endswith(" 0"))
            except BaseException:
                # roll back best-effort; a poisoned connection is
                # handled (and the batch replayed) by _run's reconnect
                try:
                    self._conn.execute("ROLLBACK")
                except ProtocolError:
                    pass
                raise
            self._conn.execute("COMMIT")
            return found

        return self._run(run)

    def get_by_id(self, media_id: str) -> proto.Media:
        _, rows, _ = self._run(
            lambda: self._conn.query(
                "SELECT id, name, creator, creator_id, metadata_id, status "
                "FROM media WHERE id = $1",
                (media_id,),
            )
        )
        if not rows:
            raise MediaNotFound(media_id)
        row = rows[0]
        return proto.Media(
            id=row[0] or "",
            name=row[1] or "",
            creator=int(row[2] or 0),
            creatorId=row[3] or "",
            metadataId=row[4] or "",
            status=int(row[5] or 0),
        )

    def close(self) -> None:
        self._conn.close()
