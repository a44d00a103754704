"""Storage interface and the in-memory backend (the port's own copy of
the reference's ``storage/base.py``, without the batched-ingest hops
``update_status_batch`` and ``get_by_ids``)."""

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
