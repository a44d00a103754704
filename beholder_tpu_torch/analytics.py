"""Batch-analytics sink for the progress stream, aggregating on the card.

Counterpart of the reference's ``analytics.py``: the progress consumer
records each observation (``record(status, progress)``); every
``flush_every`` observations the buffered batch is aggregated in one
launch of the aggregation kernel (``ops.aggregate_telemetry``) and the
summary is logged as a structured record: per lowercase status name with a
count above 0, its ``count``, ``mean_progress`` rounded to 2 places and
``max_progress``.

Each flush moves its batch to the device as int32 through pinned memory
and reads the four ``(S,)`` results back in one copy, so a synchronous
flush synchronises once (the reference reads each value on its own).
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from .device import resolve_device, to_device
from .ops import NUM_STATUSES, STATUS_NAMES, aggregate_telemetry


class AnalyticsSink:
    """Buffers observations; aggregates full batches on the card.

    ``async_flush=True`` (what a message consumer uses) hands the batch to
    a single background worker thread, so device work never stalls the
    consumer's hot path; the worker logs a warning on a failed aggregation
    and stays alive. Synchronous mode is for direct use and tests.
    ``device=None`` means the card (and raises when there is none); pass
    ``device="cpu"`` for the plain PyTorch path.
    """

    def __init__(self, flush_every: int = 4096, logger=None, async_flush: bool = False,
                 *, device=None):
        if flush_every <= 0:
            raise ValueError("flush_every must be positive")
        self.flush_every = flush_every
        self.device = resolve_device(device)
        self._statuses: list[int] = []
        self._progress: list[int] = []
        self._log = logger or logging.getLogger("analytics")
        self._executor = None
        if async_flush:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="analytics")

    def record(self, status: int, progress: int) -> dict[str, Any] | None:
        """Buffer one observation; flush when the batch is full.

        Returns the flushed summary when a synchronous flush happened,
        else None (async flushes log their summary from the worker).
        """
        self._statuses.append(int(status))
        self._progress.append(int(progress))
        if len(self._statuses) >= self.flush_every:
            return self.flush()
        return None

    @property
    def buffered(self) -> int:
        return len(self._statuses)

    def flush(self) -> dict[str, Any] | None:
        """Aggregate the buffer (inline, or on the worker in async mode)."""
        if not self._statuses:
            return None
        batch_s, self._statuses = self._statuses, []
        batch_p, self._progress = self._progress, []
        if self._executor is not None:
            self._executor.submit(self._aggregate_safe, batch_s, batch_p)
            return None
        return self._aggregate(batch_s, batch_p)

    def drain(self, timeout: float = 30.0) -> None:
        """Block until pending async flushes complete (shutdown/tests)."""
        if self._executor is not None:
            # the worker is single-threaded, so a sentinel task completing
            # means everything submitted before it has finished
            self._executor.submit(lambda: None).result(timeout=timeout)

    def _aggregate_safe(self, statuses: list[int], progress: list[int]) -> None:
        try:
            self._aggregate(statuses, progress)
        except Exception as err:  # noqa: BLE001 - worker must not die silently
            self._log.warning(f"analytics aggregation failed: {err!r}")

    def _aggregate(self, statuses: list[int], progress: list[int]) -> dict[str, Any]:
        out = aggregate_telemetry(
            to_device(np.asarray(statuses, np.int32), self.device),
            to_device(np.asarray(progress, np.int32), self.device),
        )
        # one readback: the int32 counts travel as their bits beside the f32 rows
        packed = torch.stack([out["count"].view(torch.float32), out["mean_progress"],
                              out["max_progress"]]).cpu()
        counts = packed[0].view(torch.int32).tolist()
        means, maxes = packed[1].tolist(), packed[2].tolist()
        summary = {
            STATUS_NAMES[s].lower(): {
                "count": counts[s],
                "mean_progress": round(means[s], 2),
                "max_progress": maxes[s],
            }
            for s in range(NUM_STATUSES)
            if counts[s] > 0
        }
        self._log.info("telemetry aggregate", extra={"fields": {"aggregate": summary}})
        return summary
