"""The sharded KV pool: per-shard page accounting and placement.

A shard's device-side pool IS a
:class:`~beholder_tpu_torch.models.serving.PagedKVState` (its own free
stack, its own refcounts), so every allocator invariant the serving tests
pin holds per shard. This module adds the host half the router schedules
on:

- :class:`ShardPool`: one shard's worst-case page arithmetic
  (``committed`` is what the shard batcher's own headroom would compute:
  the worst cases of its queued and in-flight requests; the device
  allocator stays the safety net), its device and its name;
- :class:`ShardedPoolView`: the aggregate the router routes over;
  ``least_pressure`` picks the shard with the most free pages, ties to the
  lowest id, so a replayed stream routes the same way.

Placement comes from :func:`beholder_tpu_torch.parallel.mesh.
serving_shard_devices`: one device per shard, cycling over the cards.
"""

from __future__ import annotations


class ShardPool:
    """Host-side view of one decode shard's paged pool."""

    def __init__(self, shard_id: int, num_pages: int, device=None):
        self.shard_id = shard_id
        self.name = f"decode-{shard_id}"
        self.num_pages = int(num_pages)
        self.device = device
        #: worst-case pages reserved by queued and in-flight requests (host
        #: arithmetic, never a device read)
        self.committed = 0

    @property
    def free(self) -> int:
        return self.num_pages - self.committed

    def reserve(self, pages: int) -> None:
        self.committed += int(pages)

    def release(self, pages: int) -> None:
        self.committed -= int(pages)
        if self.committed < 0:  # defensive: accounting must never wedge
            self.committed = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ShardPool({self.name}, free={self.free}/{self.num_pages})"


class ShardedPoolView:
    """The router's aggregate over every shard's page arithmetic."""

    def __init__(self, shards: list[ShardPool]):
        if not shards:
            raise ValueError("a cluster needs at least one shard pool")
        self.shards = shards

    @property
    def total_pages(self) -> int:
        return sum(s.num_pages for s in self.shards)

    @property
    def total_free(self) -> int:
        return sum(s.free for s in self.shards)

    def least_pressure(self, pools: list[ShardPool] | None = None) -> ShardPool:
        """The shard with the most free pages, over every shard or the
        ``pools`` subset (failover routes over up shards only). Ties break
        to the lowest shard id; routing and drain both come through here,
        so their tie-breaks cannot diverge."""
        return max(
            self.shards if pools is None else pools,
            key=lambda s: (s.free, -s.shard_id),
        )

    def refresh_gauges(self, instruments) -> None:
        """Export every shard's free and committed pages on the labelled
        cluster gauges (nothing without instruments)."""
        if instruments is None:
            return
        for shard in self.shards:
            instruments.set_shard_pool(str(shard.shard_id), shard.free, shard.committed)


def place_paged_state(state, device):
    """``state`` (a ``PagedKVState``, a ``QuantizedPool``, a tensor, or any
    nesting of tuples of them) on ``device``; ``None`` leaves it where it
    is. A tensor already there comes back as the same tensor, as
    ``Tensor.to`` does: on one card a move copies nothing."""
    if device is None or state is None:
        return state
    if isinstance(state, tuple):
        moved = [place_paged_state(x, device) for x in state]
        return type(state)(*moved) if hasattr(state, "_fields") else tuple(moved)
    return state.to(device)
