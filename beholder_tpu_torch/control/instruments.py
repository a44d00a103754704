"""The control subsystem's metric catalog (the port's own copy of the
reference's ``control/instruments.py``).

Nothing registers unless a control plane (or a
:class:`~beholder_tpu_torch.control.admission.TenantFairQueue`) is handed a
registry, so the default exposition stays byte-identical. Every series
uses :func:`~beholder_tpu_torch.metrics.get_or_create`, so a replacement
plane re-attaches instead of tripping the duplicate guard.

- ``beholder_control_admitted_total{tenant}`` (counter): requests admitted
  through a tenant-fair intake
- ``beholder_control_shed_total{tenant, reason}`` (counter): requests shed
  by the fair-admission policy
- ``beholder_control_tenant_quota{tenant}``,
  ``beholder_control_tenant_weight{tenant}`` (gauges): the declared policy
- ``beholder_control_k_shed_total`` (counter): draft-length choices capped
  under burn; ``beholder_control_k_cap`` (gauge): the cap applied now (-1 =
  uncapped)
- ``beholder_control_scale_events_total{direction}`` (counter): autoscaler
  actuations (``up`` / ``down``)
- ``beholder_control_route_overrides_total{reason}`` (counter): routing
  decisions where the control policy overrode plain pressure
  (``tail_avoid`` / ``deadline``)
"""

from __future__ import annotations

from beholder_tpu_torch.metrics import get_or_create


class ControlMetrics:
    """The series above, find-or-registered on a shared registry (a
    :class:`~beholder_tpu_torch.metrics.Registry`, or any object whose
    ``registry`` attribute is one)."""

    def __init__(self, registry):
        registry = getattr(registry, "registry", registry)
        self.registry = registry
        self.admitted_total = get_or_create(
            registry, "counter",
            "beholder_control_admitted_total",
            "Requests admitted through a tenant-fair intake, by tenant",
            labelnames=["tenant"],
        )
        self.shed_total = get_or_create(
            registry, "counter",
            "beholder_control_shed_total",
            "Requests shed by the tenant-fair admission policy, by "
            "tenant and reason",
            labelnames=["tenant", "reason"],
        )
        self.tenant_quota = get_or_create(
            registry, "gauge",
            "beholder_control_tenant_quota",
            "Declared per-tenant queued-request quota (-1 = unbounded)",
            labelnames=["tenant"],
        )
        self.tenant_weight = get_or_create(
            registry, "gauge",
            "beholder_control_tenant_weight",
            "Declared per-tenant deficit-round-robin weight",
            labelnames=["tenant"],
        )
        self.k_shed_total = get_or_create(
            registry, "counter",
            "beholder_control_k_shed_total",
            "Adaptive-k draft choices capped by fast-window TTFT-tail "
            "burn (speculation shed under SLO pressure)",
        )
        self.k_cap = get_or_create(
            registry, "gauge",
            "beholder_control_k_cap",
            "Draft-length cap the control plane currently applies to "
            "the adaptive-k controller (-1 = uncapped)",
        )
        self.k_cap.set(-1)
        self.scale_events_total = get_or_create(
            registry, "counter",
            "beholder_control_scale_events_total",
            "Autoscaler actuations by direction (up = shard spawned, "
            "down = shard drained byte-identically)",
            labelnames=["direction"],
        )
        self.route_overrides_total = get_or_create(
            registry, "counter",
            "beholder_control_route_overrides_total",
            "Routing decisions where control policy overrode plain "
            "pool pressure, by reason",
            labelnames=["reason"],
        )

    def export_policy(self, control) -> None:
        """Make the declared policy scrapeable: one quota/weight gauge
        per configured tenant (plus the default bucket)."""
        from . import DEFAULT_TENANT

        for tenant, policy in control.tenants.items():
            self.tenant_quota.set(
                policy.quota if policy.quota is not None else -1,
                tenant=tenant,
            )
            self.tenant_weight.set(policy.weight, tenant=tenant)
        self.tenant_quota.set(
            (
                control.default_quota
                if control.default_quota is not None
                else -1
            ),
            tenant=DEFAULT_TENANT,
        )
        self.tenant_weight.set(
            control.default_weight, tenant=DEFAULT_TENANT
        )
