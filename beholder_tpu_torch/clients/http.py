"""Pluggable HTTP transport (the port's own copy of the reference's
``clients/http.py``; its response cache, ``CachingTransport``, and the
flight plane's ``TracingTransport`` are not ported).

The reference talks to Trello through the ``trello`` npm package and to
Telegram/Emby through raw ``request-promise-native`` calls (index.js:14,
99-118). This rebuild routes all three through one transport interface so
tests can assert on exact requests without network access.
"""

from __future__ import annotations

import abc
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
