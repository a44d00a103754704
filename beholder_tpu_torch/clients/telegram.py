"""Telegram Bot API client.

One operation: the "new media deployed" notification (index.js:94-107).
The reference sends a markdown message linking the Kitsu metadata page.

The port's own copy of the reference's ``clients/telegram.py``.
"""

from __future__ import annotations

import os

from .http import HttpResponse, HttpTransport, RequestsTransport

BASE_URL = "https://api.telegram.org"


class TelegramClient:
    def __init__(
        self,
        token: str,
        transport: HttpTransport | None = None,
        base_url: str | None = None,
        deadline_s: float = 10.0,
    ):
        self._token = token
        self._transport = transport or RequestsTransport()
        # TELEGRAM_API_URL lets tests/self-hosted setups redirect traffic
        base_url = base_url or os.environ.get("TELEGRAM_API_URL", BASE_URL)
        self._base_url = base_url.rstrip("/")
        #: per-request time budget handed to the transport (the service
        #: threads ``instance.http.deadline_s`` here)
        self._deadline_s = float(deadline_s)

    def send_message(
        self, chat_id: str, text: str, parse_mode: str = "markdown"
    ) -> HttpResponse:
        resp = self._transport.request(
            "get",  # request-promise-native defaults to GET (index.js:99)
            f"{self._base_url}/bot{self._token}/sendMessage",
            params={"chat_id": chat_id, "text": text, "parse_mode": parse_mode},
            timeout=self._deadline_s,
        )
        resp.raise_for_status()
        return resp

    def notify_deployed(self, chat_id: str, name: str, metadata_id: str) -> HttpResponse:
        """The exact message shape from index.js:103."""
        text = f"*New Anime:* {name}\nKitsu: https://kitsu.io/anime/{metadata_id}"
        return self.send_message(chat_id, text)
