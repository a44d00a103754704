"""Storage interface and the in-memory backend (the port's own copy of
the reference's ``storage/base.py``)."""

from __future__ import annotations

import abc

from beholder_tpu_torch import proto


class MediaNotFound(KeyError):
    """Raised by ``get_by_id`` for an unknown media id."""


class Storage(abc.ABC):
    """The two-method contract the reference exercises (index.js:68,76,140),
    plus ``add_media`` for the producer side (tests, tools)."""

    @abc.abstractmethod
    def update_status(self, media_id: str, status: int) -> None:
        """Persist a new lifecycle status for a media row (index.js:68)."""

    @abc.abstractmethod
    def get_by_id(self, media_id: str) -> proto.Media:
        """Fetch the full media row (index.js:76,140)."""

    @abc.abstractmethod
    def add_media(self, media: proto.Media) -> None:
        """Insert/replace a media row."""

    def update_status_batch(
        self, updates: list[tuple[str, int]]
    ) -> list[bool]:
        """Apply status updates IN ORDER; returns per-row found flags
        (``False`` where :meth:`update_status` would have raised
        :class:`MediaNotFound`).

        The batched-ingest storage hop: backends override this with a
        one-transaction implementation (one commit per drained batch
        instead of per message) — rows and per-row outcomes must be
        identical to the per-message loop, which is exactly what this
        default does."""
        found: list[bool] = []
        for media_id, status in updates:
            try:
                self.update_status(media_id, status)
                found.append(True)
            except MediaNotFound:
                found.append(False)
        return found

    def get_by_ids(self, media_ids) -> dict[str, proto.Media]:
        """Fetch several media rows at once; missing ids are simply
        absent from the result (callers keep :meth:`get_by_id`'s
        MediaNotFound semantics by falling back per id).

        The batched-ingest read hop: backends override this with a
        single-query implementation so a drained batch stops paying a
        storage round trip per message. This default is the per-id
        loop, semantics identical."""
        out: dict[str, proto.Media] = {}
        for media_id in media_ids:
            try:
                out[media_id] = self.get_by_id(media_id)
            except MediaNotFound:
                pass
        return out

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


class MemoryStorage(Storage):
    """Dict-backed storage for tests."""

    def __init__(self):
        self._rows: dict[str, proto.Media] = {}

    def add_media(self, media: proto.Media) -> None:
        clone = proto.Media()
        clone.CopyFrom(media)
        self._rows[media.id] = clone

    def update_status(self, media_id: str, status: int) -> None:
        row = self._rows.get(media_id)
        if row is None:
            raise MediaNotFound(media_id)
        row.status = status

    def get_by_id(self, media_id: str) -> proto.Media:
        row = self._rows.get(media_id)
        if row is None:
            raise MediaNotFound(media_id)
        clone = proto.Media()
        clone.CopyFrom(row)
        return clone


def postgres_storage(url: str, **kwargs) -> Storage:
    """The Postgres backend (:class:`.postgres.PostgresStorage` over the
    from-scratch wire client in :mod:`.pg_wire`), kept as a function for
    callers that predate the class."""
    from .postgres import PostgresStorage

    return PostgresStorage(url, **kwargs)
