"""Trello REST v1 client.

Covers the two operations the reference performs through the ``trello`` npm
package: moving a card to a list (index.js:83-86) and commenting on a card
(index.js:53-55), plus the read-only board and card lookups. Auth is
key+token query parameters, as the npm client does.

The port's own copy of the reference's ``clients/trello.py``.
"""

from __future__ import annotations

import os
from typing import Any

from .http import HttpResponse, HttpTransport, RequestsTransport

BASE_URL = "https://api.trello.com"


class TrelloClient:
    def __init__(
        self,
        key: str,
        token: str,
        transport: HttpTransport | None = None,
        base_url: str | None = None,
        deadline_s: float = 10.0,
    ):
        self._key = key
        self._token = token
        self._transport = transport or RequestsTransport()
        # TRELLO_API_URL lets tests/self-hosted setups redirect traffic
        base_url = base_url or os.environ.get("TRELLO_API_URL", BASE_URL)
        self._base_url = base_url.rstrip("/")
        #: per-request time budget handed to the transport (the service
        #: threads ``instance.http.deadline_s`` here)
        self._deadline_s = float(deadline_s)

    def make_request(
        self, method: str, path: str, params: dict[str, Any] | None = None
    ) -> HttpResponse:
        """Generic call mirroring ``trello.makeRequest`` (index.js:53,83)."""
        merged = {"key": self._key, "token": self._token}
        merged.update(params or {})
        resp = self._transport.request(
            method, f"{self._base_url}{path}", params=merged,
            timeout=self._deadline_s,
        )
        resp.raise_for_status()
        return resp

    def move_card(self, card_id: str, list_id: str, pos: int = 2) -> HttpResponse:
        """PUT /1/cards/<id> with idList + pos, exactly as index.js:83-86."""
        return self.make_request(
            "put", f"/1/cards/{card_id}", {"idList": list_id, "pos": pos}
        )

    def comment_card(self, card_id: str, text: str) -> HttpResponse:
        """POST a comment action; empty text falls back like index.js:54."""
        return self.make_request(
            "post",
            f"/1/cards/{card_id}/actions/comments",
            {"text": text or "Failed to retrieve comment text."},
        )

    def get_board(self, board_id: str) -> HttpResponse:
        """GET /1/boards/<id> — a read-only lookup (board metadata, list
        layout). Hot when resolving flow lists for many cards; the
        service's :class:`~beholder_tpu_torch.clients.http.CachingTransport`
        TTL-caches it (``instance.cache.http``)."""
        return self.make_request("get", f"/1/boards/{board_id}")

    def get_card(self, card_id: str) -> HttpResponse:
        """GET /1/cards/<id> — read-only card lookup (same cache tier
        as :meth:`get_board`)."""
        return self.make_request("get", f"/1/cards/{card_id}")
