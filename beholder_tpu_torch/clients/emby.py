"""Emby media-server client.

Trigger a library refresh after a deployment (index.js:110-118), and
the read-only library listing.

The port's own copy of the reference's ``clients/emby.py``.
"""

from __future__ import annotations

from .http import HttpResponse, HttpTransport, RequestsTransport


class EmbyClient:
    def __init__(
        self,
        host: str,
        token: str,
        transport: HttpTransport | None = None,
        deadline_s: float = 10.0,
    ):
        self._host = host.rstrip("/")
        self._token = token
        self._transport = transport or RequestsTransport()
        #: per-request time budget handed to the transport (the service
        #: threads ``instance.http.deadline_s`` here)
        self._deadline_s = float(deadline_s)

    def refresh_library(self) -> HttpResponse:
        resp = self._transport.request(
            "get",  # request-promise-native defaults to GET (index.js:112)
            f"{self._host}/emby/library/refresh",
            params={"api_key": self._token},
            timeout=self._deadline_s,
        )
        resp.raise_for_status()
        return resp

    def library_folders(self) -> HttpResponse:
        """GET /emby/Library/VirtualFolders — the read-only library
        listing. Unlike :meth:`refresh_library` (a GET with a side
        effect, never cacheable) this is a pure lookup, TTL-cached by
        the service's :class:`~beholder_tpu_torch.clients.http
        .CachingTransport` (``instance.cache.http``)."""
        resp = self._transport.request(
            "get",
            f"{self._host}/emby/Library/VirtualFolders",
            params={"api_key": self._token},
            timeout=self._deadline_s,
        )
        resp.raise_for_status()
        return resp
