"""Circuit breaker + the resilient HTTP transport it wraps (the port's own
copy of the reference's ``reliability/breaker.py``).

:class:`CircuitBreaker` is the standard three-state machine over a
sliding window of outcomes:

- **closed** — calls flow; outcomes land in the window. When the window
  holds at least ``min_calls`` outcomes and the failure rate reaches
  ``failure_threshold``, the breaker OPENS.
- **open** — calls are rejected instantly (:class:`BreakerOpenError`)
  without touching the sick dependency; after ``reset_timeout_s`` the
  next allowed call transitions to half-open.
- **half-open** — up to ``half_open_probes`` concurrent probe calls are
  let through. ``half_open_successes`` consecutive successes close the
  breaker (window reset); ANY probe failure re-opens it and restarts
  the cooldown.

:class:`ResilientTransport` stacks the whole reliability story onto any
:class:`~beholder_tpu_torch.clients.http.HttpTransport`: breaker admission,
per-attempt timeouts capped by the propagated deadline, retries (with
full jitter + budget) on transport faults and 5xx responses, and the
shared reliability metrics. The service wires it around the outbound
transport behind ``instance.reliability.enabled``, so Trello, Telegram,
and Emby all inherit it (they already share one transport).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from beholder_tpu_torch.clients.http import HttpResponse, HttpTransport
from beholder_tpu_torch.log import get_logger

from .instruments import STATE_VALUES
from .policy import Deadline, RetryPolicy, current_deadline

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class BreakerOpenError(RuntimeError):
    """Fast failure: the breaker is open and the call was not attempted."""

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit breaker {name!r} is open "
            f"(retry in {max(retry_after_s, 0.0):.2f}s)"
        )
        self.breaker = name
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Windowed-failure-rate breaker, thread-safe.

    Use either :meth:`call` (wraps a callable) or the explicit
    :meth:`allow` / :meth:`record_success` / :meth:`record_failure`
    triple when success is decided by inspecting a response."""

    def __init__(
        self,
        name: str = "default",
        window: int = 20,
        min_calls: int = 5,
        failure_threshold: float = 0.5,
        reset_timeout_s: float = 30.0,
        half_open_probes: int = 1,
        half_open_successes: int = 2,
        clock: Callable[[], float] = time.monotonic,
        metrics=None,
        logger=None,
    ):
        if not 0 < failure_threshold <= 1:
            raise ValueError(
                f"failure_threshold must be in (0, 1], got {failure_threshold}"
            )
        self.name = name
        self.window = int(window)
        self.min_calls = int(min_calls)
        self.failure_threshold = float(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = int(half_open_probes)
        self.half_open_successes = int(half_open_successes)
        self._clock = clock
        self._metrics = metrics
        self._log = logger or get_logger("reliability.breaker")
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: deque[bool] = deque(maxlen=self.window)  # True = failure
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probe_successes = 0
        if self._metrics is not None:
            self._metrics.breaker_state.set(STATE_VALUES[CLOSED], breaker=name)

    # -- introspection ------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def failure_rate(self) -> float:
        with self._lock:
            if not self._outcomes:
                return 0.0
            return sum(self._outcomes) / len(self._outcomes)

    # -- state machine (lock held) ------------------------------------------
    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        self._log.warning(f"breaker {self.name!r}: {self._state} -> {state}")
        self._state = state
        if state == OPEN:
            self._opened_at = self._clock()
        if state in (OPEN, CLOSED):
            self._probes_in_flight = 0
            self._probe_successes = 0
        if state == CLOSED:
            self._outcomes.clear()
        if self._metrics is not None:
            self._metrics.breaker_state.set(
                STATE_VALUES[state], breaker=self.name
            )
            self._metrics.breaker_transitions_total.inc(
                breaker=self.name, state=state
            )

    # -- admission + outcomes ----------------------------------------------
    def allow(self) -> bool:
        """May a call proceed right now? (Half-open admissions count as
        probes; callers MUST report the outcome via record_*.)"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    if self._metrics is not None:
                        self._metrics.breaker_rejections_total.inc(
                            breaker=self.name
                        )
                    return False
                self._transition(HALF_OPEN)
            # half-open: admit a bounded number of concurrent probes
            if self._probes_in_flight < self.half_open_probes:
                self._probes_in_flight += 1
                return True
            if self._metrics is not None:
                self._metrics.breaker_rejections_total.inc(breaker=self.name)
            return False

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return self.reset_timeout_s - (self._clock() - self._opened_at)

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(self._probes_in_flight - 1, 0)
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_successes:
                    self._transition(CLOSED)
                return
            self._outcomes.append(False)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # a sick dependency is still sick: back to open, new cooldown
                self._transition(OPEN)
                return
            if self._state == OPEN:
                return
            self._outcomes.append(True)
            if (
                len(self._outcomes) >= self.min_calls
                and sum(self._outcomes) / len(self._outcomes)
                >= self.failure_threshold
            ):
                self._transition(OPEN)

    def call(self, fn: Callable[[], Any]):
        """Run ``fn`` under the breaker: admission, then outcome by
        exception (any exception = failure)."""
        if not self.allow():
            raise BreakerOpenError(self.name, self.retry_after_s())
        try:
            result = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result


class ResilientTransport(HttpTransport):
    """Breaker + retry + deadline wrapper over any transport.

    Per request: admission through ``breaker`` (fail fast when open),
    per-attempt timeout capped to the active deadline (the ``deadline``
    argument of one request is the ambient
    :func:`~.policy.current_deadline`, else ``default_deadline_s``,
    else just the per-attempt ``timeout``), retries via ``retry`` on
    transport faults and 5xx responses. 4xx responses are the server
    SPEAKING — they count as breaker successes and never retry.

    A 5xx that survives all retries is RETURNED (not raised): clients
    own ``raise_for_status``, and swallowing the response body here
    would lose the error detail the reference logs."""

    def __init__(
        self,
        inner: HttpTransport,
        breaker: CircuitBreaker | None = None,
        retry: RetryPolicy | None = None,
        default_deadline_s: float | None = None,
        logger=None,
    ):
        self.inner = inner
        self.breaker = breaker or CircuitBreaker(name="http")
        self.retry = retry or RetryPolicy(
            retry_on=(OSError, ConnectionError, TimeoutError, _Retry5xx)
        )
        self.default_deadline_s = default_deadline_s
        self._log = logger or get_logger("reliability.transport")

    def request(self, method, url, *, params=None, json=None, timeout=10.0,
                headers=None):
        deadline = current_deadline()
        if deadline is None and self.default_deadline_s is not None:
            deadline = Deadline.after(self.default_deadline_s)

        def attempt() -> HttpResponse:
            # deadline BEFORE admission: allow() may hand out a half-open
            # probe slot that only record_* returns — a cap() raise after
            # taking the slot would leak it and wedge the breaker in
            # half-open (no time-based escape) until restart
            per_attempt = deadline.cap(timeout) if deadline is not None else timeout
            if not self.breaker.allow():
                raise BreakerOpenError(
                    self.breaker.name, self.breaker.retry_after_s()
                )
            # headers forwarded only when set: duck-typed transports
            # predating the headers kwarg keep working headerless
            extra = {"headers": headers} if headers is not None else {}
            try:
                resp = self.inner.request(
                    method, url, params=params, json=json,
                    timeout=per_attempt, **extra,
                )
            except BaseException:
                self.breaker.record_failure()
                raise
            if resp.status >= 500:
                # the dependency is erroring: a breaker failure AND
                # retryable (the carried response is returned on give-up)
                self.breaker.record_failure()
                raise _Retry5xx(resp)
            self.breaker.record_success()
            return resp

        def should_retry(err: BaseException) -> bool:
            # an open breaker or a spent deadline is a decision, not a
            # transient fault — retrying would just burn the backoff
            return not isinstance(err, BreakerOpenError)

        try:
            return self.retry.call(
                attempt,
                op=f"http.{method.lower()}",
                deadline=deadline,
                should_retry=should_retry,
            )
        except _Retry5xx as err:
            return err.response


class _Retry5xx(RuntimeError):
    """Internal marker: a 5xx response riding the retry loop."""

    def __init__(self, response: HttpResponse):
        super().__init__(f"HTTP {response.status}")
        self.response = response
