"""Deadline propagation (the deadline half of the reference's
``reliability/policy.py``).

A :class:`Deadline` is an absolute time budget for one logical operation,
carried down through nested calls on a contextvar by
:func:`deadline_scope`, so no layer can grant itself more time than its
caller allowed. A :class:`~beholder_tpu_torch.models.serving.Request` may
carry one: the batcher then retires it with an explicit
``DeadlineExceededResult`` once the budget runs out.

Not ported: ``RetryBudget`` and ``RetryPolicy`` (they serve the HTTP
transport).
"""

from __future__ import annotations

import contextvars
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
