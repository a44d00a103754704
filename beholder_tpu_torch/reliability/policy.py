"""Deadline propagation and bounded retries (the port's copy of the
reference's ``reliability/policy.py``).

- A :class:`Deadline` is an absolute time budget for one logical
  operation, carried down through nested calls on a contextvar by
  :func:`deadline_scope`, so no layer can grant itself more time than its
  caller allowed. A :class:`~beholder_tpu_torch.models.serving.Request` may
  carry one: the batcher then retires it with an explicit
  ``DeadlineExceededResult`` once the budget runs out.
- :class:`RetryBudget` is a token bucket shared across call sites: each
  first attempt earns a fraction of a retry token, each retry spends one,
  so a sustained outage cannot multiply the offered load.
- :class:`RetryPolicy` is bounded exponential backoff with full jitter,
  composed with the budget and the deadline. The cluster's page transfer
  engine retries every hop through one
  (:class:`~beholder_tpu_torch.cluster.transfer.PageTransferEngine`), and
the service's outbound HTTP retries through one
(:class:`~beholder_tpu_torch.reliability.breaker.ResilientTransport`),
counted on the :mod:`~beholder_tpu_torch.reliability.instruments` catalog.
"""

from __future__ import annotations

import contextvars
import logging
import random
import threading
import time
from contextlib import contextmanager
from typing import Callable


class DeadlineExceeded(RuntimeError):
    """The operation's time budget ran out."""


class Deadline:
    """An absolute expiry on the monotonic clock. Construct it once at the
    edge (``Deadline.after(seconds)``) and pass it down: every layer
    measures the remaining budget instead of applying a full timeout of
    its own."""

    __slots__ = ("expires_at", "_clock")

    def __init__(self, expires_at: float, clock: Callable[[], float] = time.monotonic):
        self.expires_at = expires_at
        self._clock = clock

    @classmethod
    def after(cls, seconds: float, clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + float(seconds), clock)

    def remaining(self) -> float:
        """Seconds left; negative when already expired."""
        return self.expires_at - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def cap(self, timeout_s: float) -> float:
        """``timeout_s`` clipped to the remaining budget. Raises
        :class:`DeadlineExceeded` when nothing remains."""
        remaining = self.remaining()
        if remaining <= 0:
            raise DeadlineExceeded(f"deadline exceeded ({-remaining:.3f}s past expiry)")
        return min(float(timeout_s), remaining)

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


_current_deadline: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "beholder_torch_deadline", default=None
)


def current_deadline() -> Deadline | None:
    """The innermost active :func:`deadline_scope` deadline, if any."""
    return _current_deadline.get()


@contextmanager
def deadline_scope(deadline: Deadline | float):
    """Propagate ``deadline`` (a :class:`Deadline` or seconds from now) to
    everything called inside the block. Nested scopes keep the tighter
    deadline: an inner layer may shrink the budget, never extend it."""
    if not isinstance(deadline, Deadline):
        deadline = Deadline.after(float(deadline))
    outer = _current_deadline.get()
    if outer is not None and outer.expires_at <= deadline.expires_at:
        deadline = outer
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)


class RetryBudget:
    """Token-bucket retry budget shared across call sites. Each first
    attempt deposits ``deposit_per_call`` tokens (clipped at ``capacity``);
    each retry spends one, and is denied when the bucket is empty."""

    def __init__(self, capacity: float = 10.0, deposit_per_call: float = 0.1):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = float(capacity)
        self.deposit_per_call = float(deposit_per_call)
        self._tokens = float(capacity)  # start full: cold starts may retry
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def record_call(self) -> None:
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + self.deposit_per_call)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class RetryPolicy:
    """Bounded exponential backoff with full jitter, a budget and a deadline.

    ``call(fn, op=...)`` runs ``fn`` up to ``max_attempts`` times. It retries
    only when the exception is an instance of ``retry_on`` and passes
    ``should_retry`` (if given), attempts remain, the shared ``budget`` (if
    any) grants a token, and the active deadline (the argument, else
    :func:`current_deadline`) has room for the backoff sleep. A give-up
    re-raises the last exception. Inject ``sleep`` and ``rng`` (uniform on
    [0, 1)) for deterministic tests."""

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        multiplier: float = 2.0,
        retry_on: tuple[type[BaseException], ...] = (Exception,),
        budget: RetryBudget | None = None,
        metrics=None,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[], float] = random.random,
        logger=None,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.retry_on = retry_on
        self.budget = budget
        self._metrics = metrics
        self._sleep = sleep
        self._rng = rng
        self._log = logger or logging.getLogger("beholder_tpu_torch.reliability.retry")

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter backoff before retry number ``attempt`` (1-based):
        uniform over [0, min(max_delay, base * multiplier**(attempt-1)))."""
        cap = min(self.max_delay_s, self.base_delay_s * self.multiplier ** max(attempt - 1, 0))
        return self._rng() * cap

    def _give_up(self, op: str, reason: str) -> None:
        if self._metrics is not None:
            self._metrics.retry_give_ups_total.inc(op=op, reason=reason)

    def call(
        self,
        fn: Callable[[], object],
        *,
        op: str = "call",
        deadline: Deadline | None = None,
        should_retry: Callable[[BaseException], bool] | None = None,
    ):
        deadline = deadline or current_deadline()
        if self.budget is not None:
            self.budget.record_call()
        attempt = 1
        while True:
            if deadline is not None and deadline.expired:
                self._give_up(op, "deadline")
                raise DeadlineExceeded(f"{op}: deadline exceeded before attempt {attempt}")
            try:
                return fn()
            except self.retry_on as err:
                if should_retry is not None and not should_retry(err):
                    raise
                if attempt >= self.max_attempts:
                    self._give_up(op, "attempts")
                    raise
                if self.budget is not None and not self.budget.try_spend():
                    self._give_up(op, "budget")
                    raise
                delay = self.backoff_s(attempt)
                if deadline is not None and deadline.remaining() <= delay:
                    # sleeping past the deadline only delays the failure
                    self._give_up(op, "deadline")
                    raise
                if self._metrics is not None:
                    self._metrics.retry_attempts_total.inc(op=op)
                self._log.warning(
                    f"{op}: attempt {attempt}/{self.max_attempts} failed "
                    f"({err!r}); retrying in {delay * 1e3:.0f}ms"
                )
                self._sleep(delay)
                attempt += 1
