"""Tenant-fair admission (the intake half of the reference's ``control/``).

The port's own copy, trimmed to what :class:`~.admission.TenantFairQueue`
reads: :class:`TenantPolicy` (weight and quota), :class:`ControlConfig`
(per-tenant policies and the defaults) and ``DEFAULT_TENANT``.

Not ported: ``ControlConfig``'s ``spec``/``routing``/``autoscale``
actuators (``SpecShedConfig``, ``RoutingConfig``, ``AutoscaleConfig``),
``control_from_config``, the ``ControlPlane`` policy engine, its metric
catalog (``ControlMetrics``; :class:`~.admission.TenantFairQueue` still
takes any object with ``admitted_total``/``shed_total`` counters as
``control_metrics``), the scaling evaluator and the replay harness.
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
class ControlConfig:
    """Per-tenant policies; tenants without an entry (and untenanted
    requests, bucketed under ``DEFAULT_TENANT``) get ``default_weight`` /
    ``default_quota``."""

    tenants: dict[str, TenantPolicy] = field(default_factory=dict)
    default_weight: float = 1.0
    default_quota: int | None = None

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

from .admission import (  # noqa: E402 - admission reads the names above
    SHED_TENANT_PREEMPTED,
    SHED_TENANT_QUOTA,
    Preempted,
    TenantFairQueue,
    default_tenant_of,
)

__all__ = [
    "ControlConfig",
    "DEFAULT_TENANT",
    "Preempted",
    "SHED_TENANT_PREEMPTED",
    "SHED_TENANT_QUOTA",
    "TenantFairQueue",
    "TenantPolicy",
    "default_tenant_of",
]
