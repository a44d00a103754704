"""Shared HTTP endpoint plumbing for the metrics and health servers.

The port's own copy of the reference's ``httpd.py``: one copy of the
ThreadingHTTPServer lifecycle (ephemeral-port bind, daemonized
serve_forever thread, silenced request logging, orderly shutdown) so
/metrics and /healthz can't drift apart on bind/shutdown behavior. The
reference's response cache, ``CachedRoute``, is not ported.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs

#: A route handler: () -> (status code, content type, body bytes).
#: A route with a truthy ``wants_query`` attribute is instead called
#: with the parsed query-string dict (``parse_qs``) as its one arg.
Route = Callable[[], tuple[int, str, bytes]]


def serve_routes(routes: dict[str, Route], port: int) -> ThreadingHTTPServer:
    """Start an HTTP server for ``routes`` (exact-path GETs) on ``port``
    (0 = ephemeral). Returns the running server; callers own shutdown via
    ``server.shutdown(); server.server_close()``."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            route = routes.get(path)
            if route is None:
                self.send_error(404)
                return
            if getattr(route, "wants_query", False):
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
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # structured logs only
            pass

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
