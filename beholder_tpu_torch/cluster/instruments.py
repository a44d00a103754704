"""The cluster subsystem's metric catalog (the port's copy of the
reference's ``cluster/instruments.py``).

Nothing is registered unless a cluster scheduler is handed a registry, so
the default exposition stays as it was. Every series uses
:func:`~beholder_tpu_torch.metrics.get_or_create`, so a replacement
scheduler re-attaches instead of tripping the duplicate guard.

Catalog (all appear only when a cluster scheduler gets a registry):

- ``beholder_cluster_shards`` — gauge: decode shards in this cluster
- ``beholder_cluster_pool_pages_free{shard}`` — gauge: each shard's
  free KV pages by the router's host arithmetic (the per-shard twin of
  the unlabelled ``beholder_serving_pool_pages_free``, which N shard
  batchers would otherwise overwrite)
- ``beholder_cluster_pool_pages_committed{shard}`` — gauge: worst-case
  pages committed to each shard's queued + in-flight requests
- ``beholder_cluster_transfers_total`` — counter: prefill->decode KV
  handoffs completed
- ``beholder_cluster_transferred_pages_total`` — counter: live KV
  pages moved by those handoffs
- ``beholder_cluster_transferred_bytes_total`` — counter: live KV
  bytes moved (page bytes x layers x k+v, at the transfer dtype)
- ``beholder_cluster_transfer_failed_total`` — counter: transfers
  that failed terminally (bounded retry exhausted)
- ``beholder_cluster_routes_total{reason}`` — counter: routing
  decisions by reason (``pressure`` / ``round_robin`` / ``only_shard``
  / ``rebalance``, and with a control plane ``control_tail_avoid`` /
  ``control_deadline``)
- ``beholder_cluster_requests_total{shard}`` — counter: requests fully
  served, attributed to the shard that decoded them

Shed attribution lives on the intake side:
``beholder_intake_shed_total{queue, reason}`` (see
:class:`~beholder_tpu_torch.reliability.shed.IntakeQueue`: the router
names each shard's queue uniquely, so sheds chart per shard).
"""

from __future__ import annotations

from beholder_tpu_torch.metrics import get_or_create


class ClusterMetrics:
    """The series above, find-or-registered on a shared registry (a
    :class:`~beholder_tpu_torch.metrics.Registry`, or any object whose
    ``.registry`` is one)."""

    def __init__(self, registry):
        registry = getattr(registry, "registry", registry)
        self.registry = registry
        self.shards = get_or_create(
            registry, "gauge",
            "beholder_cluster_shards",
            "Decode shards (per-shard paged KV pools) in this cluster",
        )
        self.pool_pages_free = get_or_create(
            registry, "gauge",
            "beholder_cluster_pool_pages_free",
            "Free KV pages per decode shard (router host arithmetic)",
            labelnames=["shard"],
        )
        self.pool_pages_committed = get_or_create(
            registry, "gauge",
            "beholder_cluster_pool_pages_committed",
            "Worst-case KV pages committed to queued + in-flight "
            "requests per decode shard",
            labelnames=["shard"],
        )
        self.transfers_total = get_or_create(
            registry, "counter",
            "beholder_cluster_transfers_total",
            "Prefill->decode page-granular KV handoffs completed",
        )
        self.transferred_pages_total = get_or_create(
            registry, "counter",
            "beholder_cluster_transferred_pages_total",
            "Live KV pages moved by prefill->decode handoffs",
        )
        self.transferred_bytes_total = get_or_create(
            registry, "counter",
            "beholder_cluster_transferred_bytes_total",
            "Live KV bytes moved by prefill->decode handoffs",
        )
        self.transfer_failed_total = get_or_create(
            registry, "counter",
            "beholder_cluster_transfer_failed_total",
            "Page transfers that failed terminally (bounded retry "
            "exhausted; surfaced to the router as TransferFailed)",
        )
        self.routes_total = get_or_create(
            registry, "counter",
            "beholder_cluster_routes_total",
            "Cluster routing decisions by reason",
            labelnames=["reason"],
        )
        self.requests_total = get_or_create(
            registry, "counter",
            "beholder_cluster_requests_total",
            "Requests fully served, by the decode shard that served them",
            labelnames=["shard"],
        )

    def observe_transfer(self, pages: int, nbytes: int) -> None:
        """Record one completed prefill->decode handoff."""
        self.transfers_total.inc()
        self.transferred_pages_total.inc(pages)
        self.transferred_bytes_total.inc(nbytes)

    def set_shard_pool(self, shard: str, free: int, committed: int) -> None:
        self.pool_pages_free.set(free, shard=shard)
        self.pool_pages_committed.set(committed, shard=shard)


class FailoverMetrics:
    """The ``beholder_failover_*`` catalog, registered only when a
    failover-armed cluster scheduler gets a registry (same on-demand
    contract as every other subsystem catalog — default exposition
    stays byte-identical):

    - ``beholder_failover_worker_up{worker}`` — gauge: 1 while a
      decode shard / prefill worker routes traffic, 0 once down or
      drained
    - ``beholder_failover_worker_failures_total{worker, kind}`` —
      counter: detected worker failures (``kill`` / ``hang`` /
      ``transfer_failed``)
    - ``beholder_failover_recoveries_total{reason}`` — counter:
      in-flight requests re-admitted on surviving shards
    - ``beholder_failover_dropped_total{reason}`` — counter: requests
      resolved to an explicit Dropped outcome (``shard_down`` /
      ``recovery_limit``)
    - ``beholder_failover_drains_total`` — counter: graceful shard
      decommissions completed
    - ``beholder_failover_migrated_pages_total`` — counter: resident
      KV pages moved byte-identically by drains
    - ``beholder_failover_deadline_exceeded_total`` — counter:
      requests retired with an expired deadline (the serving layer
      registers the same series lazily on first expiry)
    """

    def __init__(self, registry):
        registry = getattr(registry, "registry", registry)
        self.registry = registry
        self.worker_up = get_or_create(
            registry, "gauge",
            "beholder_failover_worker_up",
            "1 while the worker routes traffic, 0 once down or drained",
            labelnames=["worker"],
        )
        self.worker_failures_total = get_or_create(
            registry, "counter",
            "beholder_failover_worker_failures_total",
            "Detected worker failures by worker and kind",
            labelnames=["worker", "kind"],
        )
        self.recoveries_total = get_or_create(
            registry, "counter",
            "beholder_failover_recoveries_total",
            "In-flight requests recovered onto surviving shards, by "
            "failure reason",
            labelnames=["reason"],
        )
        self.dropped_total = get_or_create(
            registry, "counter",
            "beholder_failover_dropped_total",
            "Requests resolved to an explicit Dropped outcome, by reason",
            labelnames=["reason"],
        )
        self.drains_total = get_or_create(
            registry, "counter",
            "beholder_failover_drains_total",
            "Graceful shard decommissions completed",
        )
        self.migrated_pages_total = get_or_create(
            registry, "counter",
            "beholder_failover_migrated_pages_total",
            "Resident KV pages migrated byte-identically by drains",
        )
        self.deadline_exceeded_total = get_or_create(
            registry, "counter",
            "beholder_failover_deadline_exceeded_total",
            "Requests retired with an expired deadline (explicit "
            "deadline_exceeded outcome instead of a wedged slot)",
        )
