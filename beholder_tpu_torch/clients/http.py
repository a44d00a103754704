"""Pluggable HTTP transport (the port's own copy of the reference's
``clients/http.py``, with its read-only lookup cache,
:class:`CachingTransport`, and the flight plane's trace-context leg,
:class:`TracingTransport`).

The reference talks to Trello through the ``trello`` npm package and to
Telegram/Emby through raw ``request-promise-native`` calls (index.js:14,
99-118). This rebuild routes all three through one transport interface so
tests can assert on exact requests without network access.
"""

from __future__ import annotations

import abc
import copy
import time
from dataclasses import dataclass
from typing import Any


@dataclass
class HttpResponse:
    status: int
    body: Any = None

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise HttpError(self.status, self.body)


class HttpError(RuntimeError):
    def __init__(self, status: int, body: Any = None):
        super().__init__(f"HTTP {status}")
        self.status = status
        self.body = body


class HttpTransport(abc.ABC):
    @abc.abstractmethod
    def request(
        self,
        method: str,
        url: str,
        *,
        params: dict[str, Any] | None = None,
        json: dict[str, Any] | None = None,
        timeout: float = 10.0,
        headers: dict[str, str] | None = None,
    ) -> HttpResponse:
        """Perform one HTTP request and return the (possibly JSON) response."""


class RequestsTransport(HttpTransport):
    """Production transport backed by ``requests``."""

    def request(self, method, url, *, params=None, json=None, timeout=10.0,
                headers=None):
        import requests

        resp = requests.request(
            method.upper(), url, params=params, json=json, timeout=timeout,
            headers=headers,
        )
        try:
            body = resp.json()
        except ValueError:
            body = resp.text
        return HttpResponse(status=resp.status_code, body=body)


def is_timeout_error(exc: BaseException) -> bool:
    """Transport-agnostic timeout detection: stdlib ``TimeoutError``
    (``socket.timeout`` is its alias since 3.10) plus duck-typing for
    requests' ``Timeout``/``ConnectTimeout``/``ReadTimeout`` — checked
    by class NAME so this module never imports requests."""
    if isinstance(exc, TimeoutError):
        return True
    return any("Timeout" in klass.__name__ for klass in type(exc).__mro__)


class TimedTransport(HttpTransport):
    """Wraps any transport with a request-latency histogram
    (``beholder_http_request_seconds{method,outcome}``). Extension
    surface: nothing is registered unless one is constructed (the
    service wires it behind ``instance.observability.enabled``), so the
    reference exposition stays byte-identical by default. ``outcome``
    is the status class (``2xx``/``4xx``/...), ``timeout`` when the
    transport raised a timeout, or ``error`` for any other raise —
    deadline misses and dependency errors are different failure modes
    and alert differently (a timeout spike says "slow dependency or
    deadline too tight", not "dependency down")."""

    def __init__(self, inner: HttpTransport, registry):
        from beholder_tpu_torch.metrics import get_or_create

        self.inner = inner
        self._hist = get_or_create(
            getattr(registry, "registry", registry),
            "histogram",
            "beholder_http_request_seconds",
            "Outbound HTTP request latency by method and outcome",
            labelnames=["method", "outcome"],
        )

    def request(self, method, url, *, params=None, json=None, timeout=10.0,
                headers=None):
        # headers forwarded only when set: duck-typed transports
        # predating the headers kwarg keep working headerless
        extra = {"headers": headers} if headers is not None else {}
        t0 = time.perf_counter()
        try:
            resp = self.inner.request(
                method, url, params=params, json=json, timeout=timeout,
                **extra,
            )
        except Exception as err:
            self._hist.observe(
                time.perf_counter() - t0, method=method.upper(),
                outcome="timeout" if is_timeout_error(err) else "error",
            )
            raise
        self._hist.observe(
            time.perf_counter() - t0, method=method.upper(),
            outcome=f"{resp.status // 100}xx",
        )
        return resp


class TracingTransport(HttpTransport):
    """Injects the active span's W3C ``traceparent`` header into every
    outbound request: the flight plane's HTTP leg, so an egress call
    (Trello, Telegram, Emby) carries the trace the triggering message
    opened across the process boundary. The service wires it outermost,
    and only when ``instance.observability.flight_plane.*`` is armed: off,
    no wrapper exists and outbound bytes are unchanged. Caller headers win
    on conflict (an explicit traceparent is an explicit parent)."""

    def __init__(self, inner: HttpTransport):
        self.inner = inner

    def request(self, method, url, *, params=None, json=None, timeout=10.0,
                headers=None):
        from beholder_tpu_torch.tracing import active_context, to_traceparent

        ctx = active_context()
        if ctx is not None:
            merged = {"traceparent": to_traceparent(ctx)}
            if headers:
                merged.update(headers)
            headers = merged
        extra = {"headers": headers} if headers is not None else {}
        return self.inner.request(
            method, url, params=params, json=json, timeout=timeout, **extra,
        )


def read_only_get(method: str, url: str) -> bool:
    """The service's default cacheability predicate: ONLY known
    read-only lookups. It must be an allowlist — this stack's
    "request-promise-native defaults to GET" heritage means GETs with
    side effects exist (Telegram ``sendMessage``, Emby
    ``library/refresh``), and caching one would silently swallow the
    side effect on every hit."""
    if method.upper() != "GET":
        return False
    return (
        "/1/boards/" in url          # Trello board lookups
        or "/1/cards/" in url        # Trello card lookups
        or "VirtualFolders" in url   # Emby library listing
    )


class CachingTransport(HttpTransport):
    """TTL response cache for read-only outbound lookups.

    Wraps any transport (the service puts it OUTSIDE
    :class:`~beholder_tpu_torch.reliability.breaker.ResilientTransport`, so a
    hit skips the breaker/retry machinery entirely — cached traffic
    costs the dependency nothing) and serves repeat lookups from a
    :class:`beholder_tpu_torch.cache.KeyedCache` keyed by (method, url,
    params). Singleflight collapses concurrent identical lookups into
    one wire call. Only responses passing ``cacheable`` (default:
    :func:`read_only_get`) with status < 300 are stored; everything
    else — writes, side-effectful GETs, errors — passes straight
    through. Extension surface: nothing registers on the exposition
    unless a registry is handed in."""

    def __init__(
        self,
        inner: HttpTransport,
        ttl_s: float = 5.0,
        max_entries: int = 256,
        cacheable=read_only_get,
        metrics=None,
        clock=None,
    ):
        from beholder_tpu_torch.cache import KeyedCache

        self.inner = inner
        self._cacheable = cacheable
        kwargs = {"clock": clock} if clock is not None else {}
        self._cache = KeyedCache(
            "http.get",
            max_entries=max_entries,
            policy="ttl",
            ttl_s=ttl_s,
            metrics=metrics,
            **kwargs,
        )

    @property
    def cache(self):
        return self._cache

    def request(self, method, url, *, params=None, json=None, timeout=10.0,
                headers=None):
        # headers forwarded only when set: duck-typed transports
        # predating the headers kwarg keep working headerless
        extra = {"headers": headers} if headers is not None else {}
        if json is not None or not self._cacheable(method, url):
            return self.inner.request(
                method, url, params=params, json=json, timeout=timeout,
                **extra,
            )
        # headers are deliberately NOT part of the cache key: trace
        # context varies per request and must not shatter the cache
        key = (method.upper(), url, _freeze(params or {}))

        def load():
            resp = self.inner.request(
                method, url, params=params, json=None, timeout=timeout,
                **extra,
            )
            if resp.status >= 300:
                # an error/redirect must not be replayed for ttl_s; the
                # private raise carries it out of the cache uncached
                raise _Uncached(resp)
            return resp

        # a defensive copy per caller on EVERY exit (hit, fresh load, or
        # error bypass — singleflight can hand one object to several
        # collapsed callers): the body is a mutable parsed-JSON object
        # and one caller's mutation must not poison another's view (same
        # contract as CachingStorage's row clones)
        try:
            resp = self._cache.get_or_load(key, load)
        except _Uncached as bypass:
            resp = bypass.response
        return HttpResponse(resp.status, copy.deepcopy(resp.body))


def _freeze(value):
    """Recursively hashable view of a params structure — list-valued
    query params are legal for the uncached transport, so they must not
    crash the cache-key build."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return frozenset(_freeze(v) for v in value)
    return value


class _Uncached(Exception):
    """Internal: carries a non-cacheable response out of a loader."""

    def __init__(self, response: HttpResponse):
        super().__init__(response.status)
        self.response = response


@dataclass
class _Recorded:
    method: str
    url: str
    params: dict[str, Any] | None
    json: dict[str, Any] | None
    headers: dict[str, str] | None = None


class RecordingTransport(HttpTransport):
    """Test transport: records every request, replies from a scripted queue."""

    def __init__(self):
        self.requests: list[_Recorded] = []
        self.responses: list[HttpResponse] = []
        self.fail_with: Exception | None = None

    def request(self, method, url, *, params=None, json=None, timeout=10.0,
                headers=None):
        self.requests.append(
            _Recorded(method.upper(), url, params, json, headers)
        )
        if self.fail_with is not None:
            raise self.fail_with
        if self.responses:
            return self.responses.pop(0)
        return HttpResponse(status=200, body={})
