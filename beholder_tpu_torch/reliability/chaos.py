"""Fault injection for the serving layer: the allocator trip and the
cluster's worker faults of the reference's ``reliability/chaos.py`` (the
rest of its harness serves the broker and the HTTP transport and is not
ported)."""

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


#: cluster worker-fault kinds
WORKER_KILL = "kill"
WORKER_HANG = "hang"
WORKER_TRANSFER_CORRUPTION = "transfer_corruption"


class WorkerFault:
    """A declarative, deterministic cluster worker fault.

    - ``kill``: the worker's dispatch entry point (the decode shard's tick
      chunk, the prefill worker's forward) raises a typed ``WorkerKilled``
      after ``after_dispatches`` successful calls: a death mid-stream;
    - ``hang``: the worker's heartbeats freeze, and the failover monitor's
      next sweep marks it down;
    - ``transfer_corruption``: the next ``transfer_failures`` page
      transfers to the worker fail. Below the retry budget the hop heals;
      at or above it the terminal ``TransferFailed`` drives recovery.
    """

    def __init__(
        self,
        worker: str,
        kind: str = WORKER_KILL,
        after_dispatches: int = 0,
        transfer_failures: int = 3,
    ):
        if kind not in (WORKER_KILL, WORKER_HANG, WORKER_TRANSFER_CORRUPTION):
            raise ValueError(f"unknown worker-fault kind {kind!r}")
        self.worker = worker
        self.kind = kind
        self.after_dispatches = int(after_dispatches)
        self.transfer_failures = int(transfer_failures)


def inject_worker_fault(scheduler, fault: WorkerFault) -> None:
    """Arm ``fault`` on a failover-enabled
    :class:`~beholder_tpu_torch.cluster.router.ClusterScheduler`. Raises
    unless the cluster has failover: without it a faulted cluster just
    dies."""
    engine = getattr(scheduler, "failover", None)
    if engine is None:
        raise RuntimeError(
            "worker faults need a failover-armed cluster — build the "
            "ClusterScheduler with ClusterConfig(failover="
            "FailoverConfig(...))"
        )
    engine.inject_fault(fault)
