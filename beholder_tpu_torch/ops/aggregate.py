"""Batched telemetry aggregation: per-status counts and progress statistics.

Counterpart of the reference's ``ops/aggregate.py``:

- :func:`status_counts` — ``(B,)`` statuses -> ``(S,)`` int32 counts;
- :func:`aggregate_telemetry` — per-status ``count`` (int32) and
  ``mean_progress``, ``max_progress``, ``min_progress`` (f32; max and min
  are 0 where the count is 0). On CUDA tensors it launches the hand-written
  kernel (:mod:`beholder_tpu_torch.ops.fused_aggregate`, one launch per
  batch); on CPU tensors it runs :func:`aggregate_telemetry_reference`, the
  reference's one-hot formulation in plain torch;
- :func:`ewma` — the f32 recurrence the reference runs under ``lax.scan``.

Statuses outside ``[0, S)`` contribute nothing, as ``jax.nn.one_hot``
gives them a zero row. ``torch.nn.functional.one_hot`` and
``torch.bincount`` raise on such values, so the plain versions compare
against the class indices instead. Counts are int32; progress sums are f32
and taken in another order than XLA's one-hot product, which moves the
mean by f32 rounding only (exactly nothing for integer progress whose
per-status sum stays below 2**24).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import NUM_STATUSES
from .fused_aggregate import aggregate_telemetry_fused, check_batch

#: the reference's initial max/min (``ops/aggregate.py:63``)
_BIG = 1e9


def _one_hot(statuses: torch.Tensor, num_statuses: int) -> torch.Tensor:
    """(B, S) bool; an out-of-range status gives a row of False."""
    classes = torch.arange(num_statuses, device=statuses.device)
    return statuses.reshape(-1)[:, None] == classes


def status_counts(statuses: torch.Tensor, num_statuses: int = NUM_STATUSES) -> torch.Tensor:
    """Count observations per status. (B,) int -> (S,) int32."""
    return _one_hot(statuses, num_statuses).sum(dim=0, dtype=torch.int32)


def aggregate_telemetry_reference(
    statuses: torch.Tensor, progress: torch.Tensor, num_statuses: int = NUM_STATUSES
) -> dict[str, torch.Tensor]:
    """The plain PyTorch version of the aggregation kernel: the reference's
    one-hot formulation on any device."""
    one_hot = _one_hot(statuses, num_statuses)  # (B, S)
    progress = progress.reshape(-1).float()[:, None]
    counts_i = one_hot.sum(dim=0, dtype=torch.int32)
    present = counts_i > 0
    counts = counts_i.float()
    zero = torch.zeros((), device=progress.device)
    sums = torch.where(one_hot, progress, zero).sum(dim=0)
    mean = torch.where(present, sums / counts.clamp_min(1.0), zero)
    if one_hot.shape[0] == 0:  # torch's max/min refuse an empty dim
        return {"count": counts_i, "mean_progress": mean,
                "max_progress": torch.zeros_like(mean), "min_progress": torch.zeros_like(mean)}
    maxes = torch.where(one_hot, progress, -_BIG).amax(dim=0)
    mins = torch.where(one_hot, progress, _BIG).amin(dim=0)
    return {
        "count": counts_i,
        "mean_progress": mean,
        "max_progress": torch.where(present, maxes, zero),
        "min_progress": torch.where(present, mins, zero),
    }


def aggregate_telemetry(
    statuses, progress, num_statuses: int = NUM_STATUSES, *, device=None
) -> dict[str, torch.Tensor]:
    """Per-status counts and progress statistics of a ``(B,)`` batch.

    Tensors run where they are; arrays (numpy, lists) go to ``device``
    first (``None`` means the card, and raises when there is none). CUDA tensors
    launch the aggregation kernel (each launch adds one to
    ``aggregate_telemetry_fused.launches``); CPU tensors run
    :func:`aggregate_telemetry_reference`; any other device raises.

    Returns a dict of ``(S,)`` tensors: ``count`` (int32),
    ``mean_progress``, ``max_progress``, ``min_progress`` (f32, 0 where the
    count is 0).
    """
    if not (torch.is_tensor(statuses) and torch.is_tensor(progress)):
        dev = resolve_device(device)
        statuses = torch.as_tensor(np.asarray(statuses), device=dev)
        progress = torch.as_tensor(np.asarray(progress), device=dev)
    check_batch(statuses, progress)
    if statuses.is_cuda:
        if num_statuses != NUM_STATUSES:
            raise ValueError(
                f"the aggregation kernel is built for {NUM_STATUSES} statuses, got {num_statuses}"
            )
        return aggregate_telemetry_fused(statuses, progress)
    if statuses.device.type != "cpu":
        raise ValueError(
            f"aggregate_telemetry runs on CUDA tensors (the kernel) or CPU tensors "
            f"(the plain version), got {statuses.device}"
        )
    return aggregate_telemetry_reference(statuses, progress, num_statuses)


def ewma(series, alpha: float = 0.1) -> torch.Tensor:
    """Exponentially weighted moving average over the leading axis, in f32:
    ``carry = alpha * x + (1 - alpha) * carry`` from ``carry = series[0]``,
    step by step in the reference's order (plain torch; off the sink's
    path)."""
    series = torch.as_tensor(series).float()
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=series.device)
    keep = 1.0 - alpha
    carry = series[0]
    out = []
    for x in series.unbind(0):
        carry = alpha * x + keep * carry
        out.append(carry)
    return torch.stack(out)
