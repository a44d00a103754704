"""The autoscaler's clock: a periodic evaluator (the port's own copy of
the reference's ``control/evaluator.py``).

:meth:`~beholder_tpu_torch.control.policy.ControlPlane.evaluate_scaling`
fires only where something calls it: the cluster router at ``run_pending``
boundaries, the replay harness between bursts. :class:`ScalingEvaluator`
is a clock, not a second policy: one ``evaluate_scaling`` call per tick,
so a router-driven and an evaluator-driven plane make the same decisions
from the same signals.

**On the card, evaluate only between serves, on the serving thread**
(:meth:`ScalingEvaluator.poll_once`). A background thread that drains a
shard while the main thread serves would race it, and its current CUDA
stream is not the one serving uses: the decode combine's tickets are kept
per stream (``ops/paged_attention.py``, ``_split_counters``). The threaded
mode (:meth:`ScalingEvaluator.start`) is tested on the CPU only.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class ScalingEvaluator:
    """Periodically drive ``plane.evaluate_scaling(scheduler)`` (see the
    module docstring: on the card call :meth:`poll_once` between serves on
    the serving thread; the thread of :meth:`start` is for the CPU).

    ``wait`` is the blocking primitive between evaluations —
    ``fn(timeout_s) -> bool`` returning True to stop (the default is
    the stop event's own ``wait``, so :meth:`stop` wakes the thread
    immediately instead of sleeping out the interval; tests inject a
    counting fake to step the loop deterministically)."""

    def __init__(
        self,
        plane,
        scheduler,
        interval_s: float,
        *,
        wait: Callable[[float], bool] | None = None,
        logger=None,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.plane = plane
        self.scheduler = scheduler
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._wait = wait or self._stop.wait
        self._thread: threading.Thread | None = None
        self._log = logger
        #: evidence counters (tests and /control debugging)
        self.evaluations = 0
        self.errors = 0

    def poll_once(self) -> dict[str, Any] | None:
        """One evaluation tick — the thread body's unit, callable
        directly (deterministic tests; a daemon embedding its own
        loop). A failing evaluation is COUNTED and logged, never
        raised: the evaluator may not take the process down, and the
        next tick retries against fresh signals."""
        self.evaluations += 1
        try:
            return self.plane.evaluate_scaling(self.scheduler)
        except Exception:
            self.errors += 1
            if self._log is not None:
                self._log.exception("scaling evaluation failed")
            return None

    def _run(self) -> None:
        while not self._wait(self.interval_s):
            self.poll_once()

    def start(self) -> "ScalingEvaluator":
        """Start the daemon thread (idempotent while running)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="beholder-scaling-evaluator",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Signal the thread and join it (idempotent; a no-op before
        :meth:`start`)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
