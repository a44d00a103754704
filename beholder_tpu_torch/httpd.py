"""Shared HTTP endpoint plumbing for the metrics and health servers.

The port's own copy of the reference's ``httpd.py``: one copy of the
ThreadingHTTPServer lifecycle (ephemeral-port bind, daemonized
serve_forever thread, silenced request logging, orderly shutdown) so
/metrics and /healthz can't drift apart on bind/shutdown behavior.

:class:`CachedRoute` adds opt-in response caching for READ-ONLY endpoints:
the route's body is memoized for ``max_age_s`` and served with
``Cache-Control: max-age`` and a strong ``ETag``; a client revalidating
with ``If-None-Match`` gets a body-less 304. Under scrape storms the
exposition renders once per window instead of once per request. Plain
callables are untouched: a server with no CachedRoute behaves
byte-identically. A route registered under a key ending in "/" whose
``wants_path`` is truthy serves every path under that prefix (the retention
vault's ``/debug/traces/<id>``).
"""

from __future__ import annotations

import hashlib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs

#: A route handler: () -> (status code, content type, body bytes).
#: A route with a truthy ``wants_query`` attribute is instead called
#: with the parsed query-string dict (``parse_qs``) as its one arg.
#: A route with a truthy ``wants_path`` attribute, registered under a
#: key ending in "/", matches any path under that prefix and is called
#: with the remainder (the /debug/traces/<id> lookups).
Route = Callable[[], tuple[int, str, bytes]]


class CachedRoute:
    """Memoize a read-only route's response with ETag/max-age semantics.

    Only 200 responses are cached (an error must clear on the next
    request, not persist for a window). ``clock`` is injectable for
    deterministic TTL tests. Thread-safe: ThreadingHTTPServer serves
    each request on its own thread."""

    def __init__(
        self,
        route: Route,
        max_age_s: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_age_s <= 0:
            raise ValueError(f"max_age_s must be positive, got {max_age_s}")
        self.route = route
        self.max_age_s = float(max_age_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._cached: tuple[float, str, bytes, str] | None = None
        self.hits = 0
        self.misses = 0

    def _fresh(self) -> tuple[int, str, bytes, str]:
        now = self._clock()
        with self._lock:
            if self._cached is not None:
                stored_at, ctype, body, etag = self._cached
                if now - stored_at < self.max_age_s:
                    self.hits += 1
                    return 200, ctype, body, etag
            self.misses += 1
            code, ctype, body = self.route()
            if code != 200:
                return code, ctype, body, ""
            etag = f'"{hashlib.md5(body).hexdigest()}"'
            self._cached = (now, ctype, body, etag)
            return 200, ctype, body, etag

    def respond(self, headers) -> tuple[int, str, bytes, dict[str, str]]:
        """(code, content type, body, extra headers) for one request;
        honors ``If-None-Match`` with a body-less 304."""
        code, ctype, body, etag = self._fresh()
        if code != 200:
            return code, ctype, body, {}
        extra = {
            "Cache-Control": f"max-age={int(self.max_age_s)}",
            "ETag": etag,
        }
        if headers is not None and headers.get("If-None-Match") == etag:
            return 304, ctype, b"", extra
        return 200, ctype, body, extra

    def __call__(self) -> tuple[int, str, bytes]:
        """Plain-Route compatibility (no conditional-request handling)."""
        code, ctype, body, _ = self._fresh()
        return code, ctype, body

    def invalidate(self) -> None:
        with self._lock:
            self._cached = None


def serve_routes(routes: dict[str, Route], port: int) -> ThreadingHTTPServer:
    """Start an HTTP server for ``routes`` (exact-path GETs) on ``port``
    (0 = ephemeral). Values are plain callables or :class:`CachedRoute`
    instances (which additionally get the request headers, for ETag
    revalidation). Returns the running server; callers own shutdown via
    ``server.shutdown(); server.server_close()``."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            route = routes.get(path)
            subpath = None
            if route is None:
                # longest-prefix fallback for path-parameter routes: keys
                # ending "/" whose route declares wants_path
                prefix = max(
                    (key for key, r in routes.items()
                     if key.endswith("/") and getattr(r, "wants_path", False)
                     and path.startswith(key) and len(path) > len(key)),
                    key=len,
                    default=None,
                )
                if prefix is not None:
                    route = routes[prefix]
                    subpath = path[len(prefix):]
            if route is None:
                self.send_error(404)
                return
            extra: dict[str, str] = {}
            if subpath is not None:
                code, content_type, body = route(subpath)
            elif hasattr(route, "respond"):
                code, content_type, body, extra = route.respond(self.headers)
            elif getattr(route, "wants_query", False):
                # query-aware routes (the /debug/flight poll cursor)
                # receive the parsed query string; everything else keeps
                # the zero-arg Route contract untouched
                code, content_type, body = route(
                    parse_qs(query) if query else {}
                )
            else:
                code, content_type, body = route()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for name, value in extra.items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # structured logs only
            pass

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
