"""Fault injection for the serving layer (the allocator trip of the
reference's ``reliability/chaos.py``; the rest of its harness serves the
broker and the HTTP transport and is not ported)."""

from __future__ import annotations

import torch


def trip_allocator(batcher) -> None:
    """Force the paged pool's sticky ``alloc_failed`` flag on a
    :class:`~beholder_tpu_torch.models.serving.ContinuousBatcher`: the next
    checked scheduler call must surface the allocator error instead of
    returning silently wrong results."""
    batcher.state = batcher.state._replace(
        alloc_failed=torch.ones((), dtype=torch.bool, device=batcher.device)
    )
