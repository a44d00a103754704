"""The SLO-acting control plane (the port's own copy of the reference's
``control/``): it closes the loop from the SLO tracker's burn to action.

Four actuators and one policy engine, all host-side Python:

- **Tenant-fair admission** (:mod:`.admission`): :class:`TenantFairQueue`,
  a drop-in :class:`~beholder_tpu_torch.reliability.shed.IntakeQueue`,
  drains in weighted deficit-round-robin order, enforces per-tenant quotas
  and, under pressure, preempts the most over-share tenant's newest queued
  request (an explicit :class:`Preempted` outcome).
- **SLO-aware speculation** (:meth:`ControlPlane.spec_k_cap`): under
  fast-window burn the adaptive-k controller's draft length is capped.
- **Deadline- and burn-aware routing** (:meth:`ControlPlane.route_shard`):
  the cluster router avoids shards whose per-worker TTFT tail detaches
  from its median, and sends a request inside its deadline slack to the
  shallowest intake.
- **The autoscaler** (:meth:`ControlPlane.evaluate_scaling`): sustained
  burn and pool pressure spawn a decode shard; sustained calm drains one
  through the failover engine's lossless migration.

The replay harness (:mod:`.replay`) drives deterministic adversarial
traces through any engine with ``submit`` / ``run_pending``.

Everything is off unless built: :func:`control_from_config` returns None
unless ``instance.control.enabled``, and with no plane serving and the
exposition stay byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TenantPolicy:
    """One tenant's declared share of the intake: ``weight`` scales its
    deficit-round-robin quantum; ``quota`` caps its queued requests (None =
    bounded only by the queue)."""

    weight: float = 1.0
    quota: int | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.quota is not None and self.quota < 1:
            raise ValueError(f"quota must be >= 1, got {self.quota}")


@dataclass
class SpecShedConfig:
    """SLO-aware speculation (``instance.control.spec.*``): while the
    tracker's fast-window burn exceeds ``burn_threshold`` the adaptive-k
    controller's draft length is capped at ``shed_to``."""

    burn_threshold: float = 2.0
    shed_to: int = 0

    def __post_init__(self):
        if self.burn_threshold <= 0:
            raise ValueError(f"burn_threshold must be > 0, got {self.burn_threshold}")
        if self.shed_to < 0:
            raise ValueError(f"shed_to must be >= 0, got {self.shed_to}")


@dataclass
class RoutingConfig:
    """Deadline- and burn-aware routing (``instance.control.routing.*``): a
    shard whose per-worker TTFT tail ratio (p95/p50) exceeds
    ``tail_threshold`` is avoided while a calm shard remains; a request
    whose deadline slack is under ``deadline_slack_s`` routes to the
    shallowest intake."""

    tail_threshold: float = 3.0
    deadline_slack_s: float = 1.0

    def __post_init__(self):
        if self.tail_threshold <= 1.0:
            raise ValueError(f"tail_threshold must be > 1, got {self.tail_threshold}")
        if self.deadline_slack_s < 0:
            raise ValueError(f"deadline_slack_s must be >= 0, got {self.deadline_slack_s}")


@dataclass
class AutoscaleConfig:
    """The autoscaler (``instance.control.autoscale.*``).

    Scale up when fast-window burn > ``up_burn`` and pool pressure
    (committed / total pages) > ``up_pressure`` for ``sustain_s``; scale
    down (a lossless drain) when burn < ``down_burn`` and pressure <
    ``down_pressure`` as long. The shard count stays within
    [``min_shards``, ``max_shards``], and actuations are at least
    ``cooldown_s`` apart. ``evaluator_interval_s`` is the cadence of a
    :class:`~beholder_tpu_torch.control.evaluator.ScalingEvaluator` (None:
    evaluation only at ``run_pending`` boundaries)."""

    min_shards: int = 1
    max_shards: int = 4
    up_burn: float = 2.0
    up_pressure: float = 0.75
    down_burn: float = 0.5
    down_pressure: float = 0.25
    sustain_s: float = 10.0
    cooldown_s: float = 30.0
    evaluator_interval_s: float | None = None

    def __post_init__(self):
        if self.min_shards < 1:
            raise ValueError(f"min_shards must be >= 1, got {self.min_shards}")
        if self.max_shards < self.min_shards:
            raise ValueError(
                f"max_shards {self.max_shards} < min_shards {self.min_shards}"
            )
        if not 0.0 <= self.down_pressure <= self.up_pressure <= 1.0:
            raise ValueError(
                "need 0 <= down_pressure <= up_pressure <= 1, got "
                f"{self.down_pressure}/{self.up_pressure}"
            )
        if self.down_burn >= self.up_burn:
            raise ValueError(
                f"down_burn {self.down_burn} must be < up_burn {self.up_burn} (hysteresis)"
            )
        if self.sustain_s < 0 or self.cooldown_s < 0:
            raise ValueError("sustain_s/cooldown_s must be >= 0")
        if self.evaluator_interval_s is not None and self.evaluator_interval_s <= 0:
            raise ValueError(
                f"evaluator_interval_s must be > 0, got {self.evaluator_interval_s}"
            )


@dataclass
class ControlConfig:
    """The control plane's declared policy (``instance.control.*``):
    per-tenant policies (tenants without an entry, and untenanted requests,
    bucketed under ``DEFAULT_TENANT``, get ``default_weight`` /
    ``default_quota``); ``spec`` / ``routing`` / ``autoscale`` arm their
    actuators when set."""

    tenants: dict[str, TenantPolicy] = field(default_factory=dict)
    default_weight: float = 1.0
    default_quota: int | None = None
    spec: SpecShedConfig | None = None
    routing: RoutingConfig | None = None
    autoscale: AutoscaleConfig | None = None

    def __post_init__(self):
        if self.default_weight <= 0:
            raise ValueError(f"default_weight must be > 0, got {self.default_weight}")
        if self.default_quota is not None and self.default_quota < 1:
            raise ValueError(f"default_quota must be >= 1, got {self.default_quota}")

    def policy_for(self, tenant: str | None) -> TenantPolicy:
        if tenant is not None and tenant in self.tenants:
            return self.tenants[tenant]
        return TenantPolicy(weight=self.default_weight, quota=self.default_quota)


#: the bucket untenanted requests fall into: an untenanted fleet is one
#: tenant, so deficit round robin degrades to plain FIFO
DEFAULT_TENANT = "default"


def control_from_config(config) -> ControlConfig | None:
    """Parse ``instance.control.*`` into a :class:`ControlConfig`; None
    unless ``instance.control.enabled``.

    ``config`` is any object with the reference ``ConfigNode``'s
    interface: a dotted ``get(key, default)`` that returns a node for a
    subtree, and iteration over a node's keys (the tenant ids). Keys:
    ``enabled``; ``tenants.<id>.{weight, quota}``; ``default_weight`` /
    ``default_quota``; ``spec.{enabled, burn_threshold, shed_to}``;
    ``routing.{enabled, tail_threshold, deadline_slack_s}``;
    ``autoscale.{enabled, min_shards, max_shards, up_burn, up_pressure,
    down_burn, down_pressure, sustain_s, cooldown_s,
    evaluator_interval_s}``."""
    node = config.get("instance.control")
    if node is None or not node.get("enabled"):
        return None
    tenants: dict[str, TenantPolicy] = {}
    tenant_node = node.get("tenants")
    if tenant_node:
        for tenant in tenant_node:
            quota = node.get(f"tenants.{tenant}.quota")
            tenants[str(tenant)] = TenantPolicy(
                weight=float(node.get(f"tenants.{tenant}.weight", 1.0)),
                quota=int(quota) if quota is not None else None,
            )
    spec = None
    if bool(node.get("spec.enabled")):
        spec = SpecShedConfig(
            burn_threshold=float(node.get("spec.burn_threshold", 2.0)),
            shed_to=int(node.get("spec.shed_to", 0)),
        )
    routing = None
    if bool(node.get("routing.enabled")):
        routing = RoutingConfig(
            tail_threshold=float(node.get("routing.tail_threshold", 3.0)),
            deadline_slack_s=float(node.get("routing.deadline_slack_s", 1.0)),
        )
    autoscale = None
    if bool(node.get("autoscale.enabled")):
        interval = node.get("autoscale.evaluator_interval_s")
        autoscale = AutoscaleConfig(
            min_shards=int(node.get("autoscale.min_shards", 1)),
            max_shards=int(node.get("autoscale.max_shards", 4)),
            up_burn=float(node.get("autoscale.up_burn", 2.0)),
            up_pressure=float(node.get("autoscale.up_pressure", 0.75)),
            down_burn=float(node.get("autoscale.down_burn", 0.5)),
            down_pressure=float(node.get("autoscale.down_pressure", 0.25)),
            sustain_s=float(node.get("autoscale.sustain_s", 10.0)),
            cooldown_s=float(node.get("autoscale.cooldown_s", 30.0)),
            evaluator_interval_s=float(interval) if interval is not None else None,
        )
    default_quota = node.get("default_quota")
    return ControlConfig(
        tenants=tenants,
        default_weight=float(node.get("default_weight", 1.0)),
        default_quota=int(default_quota) if default_quota is not None else None,
        spec=spec,
        routing=routing,
        autoscale=autoscale,
    )


from .admission import (  # noqa: E402 - admission reads the names above
    SHED_TENANT_PREEMPTED,
    SHED_TENANT_QUOTA,
    Preempted,
    TenantFairQueue,
    default_tenant_of,
)
from .evaluator import ScalingEvaluator  # noqa: E402
from .instruments import ControlMetrics  # noqa: E402
from .policy import ControlPlane  # noqa: E402
from .replay import SCENARIOS, Scenario  # noqa: E402

__all__ = [
    "AutoscaleConfig",
    "ControlConfig",
    "ControlMetrics",
    "ControlPlane",
    "DEFAULT_TENANT",
    "Preempted",
    "RoutingConfig",
    "SCENARIOS",
    "SHED_TENANT_PREEMPTED",
    "SHED_TENANT_QUOTA",
    "ScalingEvaluator",
    "Scenario",
    "SpecShedConfig",
    "TenantFairQueue",
    "TenantPolicy",
    "control_from_config",
    "default_tenant_of",
]
