"""Cluster serving: the paged KV pool sharded across workers, and prefill
split from decode.

The port's copy of the reference's ``cluster/`` core. One
:class:`~beholder_tpu_torch.cluster.router.ClusterScheduler` owns N decode
shards, each a :class:`~beholder_tpu_torch.models.serving.ContinuousBatcher`
over its own paged pool, and optionally M prefill workers:

- **Sharded KV pool** (:mod:`.pool`): each shard's pool is a
  ``PagedKVState`` with its own free stack and refcounts, so every
  allocator invariant holds per shard. Capacity grows with the shard count.
- **Prefill/decode disaggregation** (:mod:`.transfer`): a prefill worker
  runs the prefill forward off-pool
  (:func:`~beholder_tpu_torch.models.serving.kv_prefill_chunks`) and hands
  the kv to the owning shard page by page
  (:func:`~beholder_tpu_torch.models.serving.paged_adopt_chunks`).
- **Routing** (:mod:`.router`): by pool pressure or round robin, per-shard
  bounded intakes with labelled shed attribution, rebalance of queued work
  at drain time.
- **Fault tolerance** (:mod:`.failover`, off by default: the cluster is
  then fail-stop): heartbeats and injected faults, recovery of in-flight
  requests on surviving shards, graceful drain with a byte-identical page
  migration, deadline-aware retirement.
- **Memory fabric** (:mod:`.fabric`, off by default): a cluster-wide
  prefix index, so a prefix cached on one shard admits as a hit on
  another after a verbatim page fetch, and a dark standby that mirrors the
  cached pages and is promoted when a worker dies.
- **Group-parallel decode** (:mod:`.group`, off by default): a decode
  shard served by a group of devices, its pool split by kv head.

**Placement.** The cluster is single-controller, as the reference's is: one
process drives every worker, and each worker is placed on a torch device by
:func:`~beholder_tpu_torch.parallel.mesh.serving_shard_devices`, cycling
over the visible cards. On one card every shard and prefill worker shares
it, and a handoff is a same-device hop that the transfer counters still
count.

**Exactness.** Under exact greedy the cluster emits the streams of the
port's single :class:`~beholder_tpu_torch.models.serving.ContinuousBatcher`
on the same requests: a slot's decode reads only its own pages, and the
handoff writes pool content and carry seeds through the same casts. Routing
and disaggregation change where work runs, never what it computes.

This module imports no torch; the device half lives in :mod:`.pool`,
:mod:`.transfer`, :mod:`.router`, :mod:`.failover`, :mod:`.fabric` and
:mod:`.group`. Not ported yet: the control plane (``control_plane=``).
"""

from __future__ import annotations

from dataclasses import dataclass

#: routing policies
ROUTE_PRESSURE = "pressure"
ROUTE_ROUND_ROBIN = "round_robin"


@dataclass
class FailoverConfig:
    """Fault-tolerance knobs (``instance.cluster.failover.*``).

    None on :class:`ClusterConfig` (the default) means fail-stop: a
    worker failure raises, exactly the pre-failover cluster. Set, the
    router arms a :class:`~beholder_tpu_torch.cluster.failover.
    FailoverEngine`: per-worker heartbeats + failure detection,
    in-flight request recovery onto surviving shards, graceful drain,
    and deadline-aware retirement — all invisible to callers (recovered
    exact-greedy streams stay bitwise-identical to an uninterrupted
    run; pinned by ``tests/test_torch_failover.py``)."""

    #: heartbeat staleness unit: a watched worker whose last beat is
    #: older than ``heartbeat_interval_s * miss_threshold`` is marked
    #: down (hang detection)
    heartbeat_interval_s: float = 5.0
    miss_threshold: int = 3
    #: recovery cap per request: a request re-admitted more times than
    #: this (pathological cascades) resolves to an explicit ``Dropped``
    #: outcome instead of looping forever
    max_recoveries_per_request: int = 2
    #: the service's ``close()`` (SIGTERM) drains every shard before exiting:
    #: ``ClusterScheduler.shutdown(drain=True)``
    drain_on_sigterm: bool = True

    def __post_init__(self):
        if self.heartbeat_interval_s <= 0:
            raise ValueError(
                f"heartbeat_interval_s must be > 0, "
                f"got {self.heartbeat_interval_s}"
            )
        if self.miss_threshold < 1:
            raise ValueError(
                f"miss_threshold must be >= 1, got {self.miss_threshold}"
            )
        if self.max_recoveries_per_request < 0:
            raise ValueError(
                f"max_recoveries_per_request must be >= 0, "
                f"got {self.max_recoveries_per_request}"
            )


@dataclass
class FabricConfig:
    """Cluster-memory-fabric knobs (``instance.cluster.fabric.*``).

    None on :class:`ClusterConfig` (the default) keeps each shard's
    prefix cache private and failover on the replay path. Set, the router
    arms a :class:`~beholder_tpu_torch.cluster.fabric.engine.FabricEngine`:
    a cluster-wide prefix index and, with ``standby``, a dark standby
    shard."""

    #: cross-shard hit count at/past which a fetched chain stays
    #: cached on the borrowing shard as a durable replica; below it
    #: the borrow is transient and dropped after the serve (hot
    #: prefixes replicate, cold ones never accumulate copies)
    replicate_after: int = 2
    #: keep one dark standby shard mirroring live pages; on a worker
    #: death the standby is promoted in place of the replay path
    standby: bool = False

    def __post_init__(self):
        if self.replicate_after < 1:
            raise ValueError(
                f"replicate_after must be >= 1, got {self.replicate_after}"
            )


@dataclass
class GroupConfig:
    """Group-parallel-decode knobs (``instance.cluster.group.*``).

    None on :class:`ClusterConfig` (the default) keeps every decode
    shard single-device: serving output, handoff wire bytes, and the
    /metrics exposition byte-identical to the pre-group cluster. Set,
    each decode shard is a :class:`~beholder_tpu_torch.cluster.group.
    engine.GroupBatcher`: one logical shard over ``size`` devices, the
    pool partitioned by KV head."""

    #: devices per decode group (>= 2 — a group of 1 IS the plain
    #: single-device shard, so asking for it is a config error, not a
    #: silent no-op); must divide the model's KV-head count and the
    #: mesh's device count
    size: int = 2
    #: the reference's mesh-axis name for the group (its params' tp axis);
    #: parsed and kept on the port's ``GroupSpec``, where one controller
    #: drives every member and no collective runs over it
    axis: str = "tp"
    #: pool-partition policy. Only ``"kv_head"`` exists: member m owns
    #: heads [m*Hkv/size, (m+1)*Hkv/size) of every page, which is what
    #: keeps every allocator invariant member-local by construction.
    #: The field is explicit (not implied) so a future page-partition
    #: policy is a VALUE, not a schema change.
    head_partition: str = "kv_head"

    def __post_init__(self):
        if self.size < 2:
            raise ValueError(
                f"group size must be >= 2, got {self.size} (size 1 is "
                "the plain single-device shard — disable the group "
                "block instead)"
            )
        if not str(self.axis).isidentifier():
            raise ValueError(
                f"group axis must be a mesh-axis identifier, "
                f"got {self.axis!r}"
            )
        if self.head_partition != "kv_head":
            raise ValueError(
                f"head_partition must be 'kv_head', "
                f"got {self.head_partition!r}"
            )


@dataclass
class ClusterConfig:
    """Cluster-serving knobs (``instance.cluster.*``).

    ``n_prefill_workers == 0`` is the COLOCATED cluster: requests
    route to decode shards that prefill and decode on their own pool
    (capacity scaling without disaggregation). ``>= 1`` arms the
    disaggregated path: prefill runs on dedicated workers and the KV
    hands off page-granularly to the owning decode shard."""

    n_decode_workers: int = 2
    n_prefill_workers: int = 0
    route_policy: str = ROUTE_PRESSURE   # pressure | round_robin
    #: per-shard intake bounds (the admission-control front door; the
    #: page-cost bound defaults to the shard's own pool size so a
    #: shard sheds when its queued worst-case pages exceed what it
    #: can ever hold)
    max_pending_per_shard: int = 16
    max_pending_pages_per_shard: int | None = None
    #: fault tolerance: None (the default) keeps the fail-stop cluster
    failover: FailoverConfig | None = None
    #: cluster memory fabric: None (the default) keeps per-shard
    #: prefix caches private and failover on the replay path
    fabric: FabricConfig | None = None
    #: group-parallel decode: None (the default) keeps decode shards
    #: single-device
    group: GroupConfig | None = None

    def __post_init__(self):
        if self.n_decode_workers < 1:
            raise ValueError(
                f"n_decode_workers must be >= 1, got {self.n_decode_workers}"
            )
        if self.n_prefill_workers < 0:
            raise ValueError(
                f"n_prefill_workers must be >= 0, "
                f"got {self.n_prefill_workers}"
            )
        if self.route_policy not in (ROUTE_PRESSURE, ROUTE_ROUND_ROBIN):
            raise ValueError(
                f"route_policy must be {ROUTE_PRESSURE!r}|"
                f"{ROUTE_ROUND_ROBIN!r}, got {self.route_policy!r}"
            )
        if self.max_pending_per_shard < 1:
            raise ValueError(
                f"max_pending_per_shard must be >= 1, "
                f"got {self.max_pending_per_shard}"
            )


def cluster_from_config(config) -> ClusterConfig | None:
    """Parse ``instance.cluster.*`` into a :class:`ClusterConfig`;
    None unless ``instance.cluster.enabled`` — the same off-by-default
    contract as the cache/spec/flight-recorder subsystems (disabled
    means byte-identical behavior and exposition)."""
    if not bool(config.get("instance.cluster.enabled")):
        return None
    max_pages = config.get("instance.cluster.max_pending_pages_per_shard")
    failover = None
    if bool(config.get("instance.cluster.failover.enabled")):
        fo = "instance.cluster.failover"
        failover = FailoverConfig(
            heartbeat_interval_s=float(
                config.get(f"{fo}.heartbeat_interval_s", 5.0)
            ),
            miss_threshold=int(config.get(f"{fo}.miss_threshold", 3)),
            max_recoveries_per_request=int(
                config.get(f"{fo}.max_recoveries_per_request", 2)
            ),
            drain_on_sigterm=bool(
                config.get(f"{fo}.drain_on_sigterm", True)
            ),
        )
    fabric = None
    if bool(config.get("instance.cluster.fabric.enabled")):
        fb = "instance.cluster.fabric"
        fabric = FabricConfig(
            replicate_after=int(config.get(f"{fb}.replicate_after", 2)),
            standby=bool(config.get(f"{fb}.standby", False)),
        )
    group = None
    if bool(config.get("instance.cluster.group.enabled")):
        gp = "instance.cluster.group"
        group = GroupConfig(
            size=int(config.get(f"{gp}.size", 2)),
            axis=str(config.get(f"{gp}.axis", "tp")),
            head_partition=str(
                config.get(f"{gp}.head_partition", "kv_head")
            ),
        )
    return ClusterConfig(
        n_decode_workers=int(
            config.get("instance.cluster.n_decode_workers", 2)
        ),
        n_prefill_workers=int(
            config.get("instance.cluster.n_prefill_workers", 0)
        ),
        route_policy=str(
            config.get("instance.cluster.route_policy", ROUTE_PRESSURE)
        ),
        max_pending_per_shard=int(
            config.get("instance.cluster.max_pending_per_shard", 16)
        ),
        max_pending_pages_per_shard=(
            int(max_pages) if max_pages is not None else None
        ),
        failover=failover,
        fabric=fabric,
        group=group,
    )


__all__ = [
    "ClusterConfig",
    "FabricConfig",
    "FailoverConfig",
    "GroupConfig",
    "ROUTE_PRESSURE",
    "ROUTE_ROUND_ROBIN",
    "cluster_from_config",
]
