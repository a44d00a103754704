"""Side-effect clients: Trello, Telegram, Emby (the port's own copy of the
reference's ``clients/``).

Each mirrors one network boundary of the reference: Trello card moves and
comments, the Telegram deployment notification, the Emby library refresh.
All share a pluggable HTTP transport so tests can intercept traffic.
"""

from .emby import EmbyClient
from .http import (
    CachingTransport,
    HttpResponse,
    HttpTransport,
    RecordingTransport,
    RequestsTransport,
    TimedTransport,
    read_only_get,
)
from .telegram import TelegramClient
from .trello import TrelloClient

__all__ = [
    "HttpTransport",
    "HttpResponse",
    "RequestsTransport",
    "RecordingTransport",
    "TimedTransport",
    "CachingTransport",
    "read_only_get",
    "TrelloClient",
    "TelegramClient",
    "EmbyClient",
]
