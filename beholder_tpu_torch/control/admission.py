"""Tenant-fair admission: weighted deficit round robin and quotas over the
bounded intake.

The port's own copy of the reference's ``control/admission.py`` (host-side
list arithmetic under the queue's lock; it never touches the device).
:class:`TenantFairQueue` is a drop-in
:class:`~beholder_tpu_torch.reliability.shed.IntakeQueue`:

- **service order** (:meth:`TenantFairQueue.drain_all`): the drained batch
  comes back in weighted deficit-round-robin order — each cycle credits
  every backlogged tenant ``quantum x weight`` and pops head-of-line
  requests while the credit covers their page cost, FIFO within a tenant;
- **admission under pressure** (:meth:`TenantFairQueue.offer`): a
  per-tenant ``quota`` caps queued requests (``tenant_quota`` sheds), and
  when the queue is full an under-share tenant's offer preempts the most
  over-share tenant's newest queued request. A preempted request resolves
  to an explicit :class:`Preempted` outcome, which
  ``ContinuousBatcher.run_pending`` appends to its results.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable

from beholder_tpu_torch.reliability.shed import (
    SHED_COST_BACKLOG,
    SHED_OVERSIZED,
    SHED_QUEUE_FULL,
    Admission,
    IntakeQueue,
)

from . import DEFAULT_TENANT, ControlConfig

#: shed reasons the control plane adds to the intake vocabulary
SHED_TENANT_QUOTA = "tenant_quota"
SHED_TENANT_PREEMPTED = "tenant_preempted"


class Preempted:
    """Explicit terminal outcome for a queued request preempted by the
    fair-admission policy (its tenant was the most over-share when an
    under-share tenant's offer found the queue full). Delivered in the
    request's result position — an accepted-then-preempted request is
    never silently lost."""

    __slots__ = ("tenant",)
    outcome = "preempted"
    reason = SHED_TENANT_PREEMPTED

    def __init__(self, tenant: str | None = None):
        self.tenant = tenant

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Preempted(tenant={self.tenant!r})"


def default_tenant_of(item: Any) -> str | None:
    """Resolve an intake item's tenant id: a bare
    :class:`~beholder_tpu_torch.models.serving.Request`'s ``tenant`` field,
    unwrapping the cluster router's ``(submit_seq, request)`` pairs."""
    if (
        isinstance(item, tuple)
        and len(item) == 2
        and isinstance(item[0], int)
    ):
        item = item[1]
    return getattr(item, "tenant", None)


class TenantFairQueue(IntakeQueue):
    """A bounded intake whose service order and pressure behavior honor
    per-tenant weights and quotas (see the module docstring).

    ``control`` declares the policy
    (:class:`~beholder_tpu_torch.control.ControlConfig` — weights, quotas,
    defaults); ``tenant_of`` maps an intake item to its tenant id
    (:func:`default_tenant_of` handles bare requests and the router's
    ``(seq, request)`` pairs); ``on_preempt`` is called (outside the
    lock) once per preempted item so the embedder can resolve its
    explicit outcome; ``control_metrics`` (a
    control metric catalog: any object with ``admitted_total`` and
    ``shed_total`` counters labelled by tenant)
    attributes admissions and sheds per tenant on the
    ``beholder_control_*`` catalog. Every other knob is the base
    :class:`~beholder_tpu_torch.reliability.shed.IntakeQueue`'s."""

    def __init__(
        self,
        max_depth: int,
        control: ControlConfig | None = None,
        *,
        tenant_of: Callable[[Any], str | None] = default_tenant_of,
        on_preempt: Callable[[Any, str | None], None] | None = None,
        control_metrics=None,
        **kwargs,
    ):
        super().__init__(max_depth, **kwargs)
        self.control = control or ControlConfig()
        self._tenant_of = tenant_of
        self._on_preempt = on_preempt
        self._control_metrics = control_metrics
        #: items preempted since the last :meth:`take_preempted` —
        #: (item, tenant) pairs the embedder resolves to outcomes
        self._preempted: list[tuple[Any, str | None]] = []

    # -- tenant arithmetic ------------------------------------------------

    def _tenant_key(self, item: Any) -> str:
        tenant = self._tenant_of(item)
        return tenant if tenant is not None else DEFAULT_TENANT

    def _pending_by_tenant(self) -> dict[str, int]:
        """Queued-request count per tenant (called under the lock;
        O(depth), and depth is bounded by construction)."""
        counts: dict[str, int] = {}
        for item in self._pending:
            key = self._tenant_key(item)
            counts[key] = counts.get(key, 0) + 1
        return counts

    def _weight(self, tenant: str) -> float:
        return self.control.policy_for(
            None if tenant == DEFAULT_TENANT else tenant
        ).weight

    def _item_cost(self, item: Any) -> float:
        return (
            float(self.cost_fn(item)) if self.cost_fn is not None else 1.0
        )

    # -- admission --------------------------------------------------------

    def offer(self, item: Any, cost: float | None = None) -> Admission:
        """Quota-checked, preemption-capable :meth:`IntakeQueue.offer`
        (same non-blocking O(depth) contract)."""
        if cost is None:
            cost = (
                float(self.cost_fn(item))
                if self.cost_fn is not None
                else 0.0
            )
        tenant = self._tenant_of(item)
        key = tenant if tenant is not None else DEFAULT_TENANT
        policy = self.control.policy_for(tenant)
        preempted: list[tuple[Any, str | None]] = []
        with self._lock:
            if self.max_cost is not None and cost > self.max_cost:
                return self._shed(SHED_OVERSIZED)
            counts = self._pending_by_tenant()
            if (
                policy.quota is not None
                and counts.get(key, 0) >= policy.quota
            ):
                return self._record_tenant_shed(key, SHED_TENANT_QUOTA)
            # pressure: preempt the most over-share tenants' NEWEST
            # queued items (they waited least) so this offer fits —
            # the newcomer's claim to a slot is its UNDER-share, so an
            # equally- or less-loaded tenant is never preempted. The
            # selection is TRANSACTIONAL: victims are chosen against a
            # simulated queue first and evicted only once the offer is
            # known to fit — an offer that would still shed must not
            # destroy already-admitted work on the way to rejection.
            victims: list[int] | None = []
            sim_counts = dict(counts)
            sim_depth = len(self._pending)
            sim_cost = self._pending_cost
            while (
                sim_depth >= self.max_depth
                or (
                    self.max_cost is not None
                    and sim_cost + cost > self.max_cost
                )
            ):
                idx = self._pick_victim(
                    key, sim_counts, exclude=frozenset(victims)
                )
                if idx is None:
                    victims = None
                    break
                victims.append(idx)
                victim_key = self._tenant_key(self._pending[idx])
                sim_counts[victim_key] -= 1
                sim_depth -= 1
                sim_cost -= self._item_cost(self._pending[idx])
            if victims is None:
                reason = (
                    SHED_QUEUE_FULL
                    if len(self._pending) >= self.max_depth
                    else SHED_COST_BACKLOG
                )
                out = self._record_tenant_shed(key, reason)
            else:
                for idx in sorted(victims, reverse=True):
                    victim = self._pending.pop(idx)
                    self._enqueued_at.pop(idx)
                    self._pending_cost -= self._item_cost(victim)
                    self._record_tenant_shed(
                        self._tenant_key(victim), SHED_TENANT_PREEMPTED
                    )
                    preempted.append(
                        (victim, self._tenant_of(victim))
                    )
                self._pending.append(item)
                self._enqueued_at.append(self._clock())
                self._pending_cost += cost
                if self._admitted_total is not None:
                    self._admitted_total.inc()
                if self._control_metrics is not None:
                    self._control_metrics.admitted_total.inc(tenant=key)
                if self._depth_gauge is not None:
                    self._depth_gauge.set(len(self._pending))
                if self._labelled_depth is not None:
                    self._labelled_depth.set(
                        len(self._pending), queue=self.name
                    )
                out = Admission(True)
            if self._on_preempt is None:
                # no resolution callback: retain the victims for
                # take_preempted() (the single-engine run_pending path).
                # With a callback the EMBEDDER owns resolution — also
                # retaining here would both leak on a long-lived router
                # (nothing ever drains the list) and re-emit duplicate
                # outcomes if the shard batcher's own run_pending runs.
                self._preempted.extend(preempted)
        if self._on_preempt is not None:
            for victim, victim_tenant in preempted:
                self._on_preempt(victim, victim_tenant)
        return out

    def _record_tenant_shed(self, tenant: str, reason: str) -> Admission:
        if self._control_metrics is not None:
            self._control_metrics.shed_total.inc(
                tenant=tenant, reason=reason
            )
        return self._shed(reason)

    def _pick_victim(
        self,
        offering: str,
        counts: dict[str, int],
        exclude: frozenset[int] = frozenset(),
    ) -> int | None:
        """Index (in ``_pending``) of the next preemption victim: the
        newest not-yet-``exclude``-d item of the tenant with the
        highest weighted share, provided that share strictly exceeds
        what the offering tenant's would be AFTER admission — fairness
        never preempts an equally-loaded peer. None when no such
        tenant exists (the offer sheds as the base queue would).
        ``counts``/``exclude`` let the transactional selection in
        :meth:`offer` walk a SIMULATED queue without mutating it."""
        offer_share = (counts.get(offering, 0) + 1) / self._weight(
            offering
        )
        worst_key, worst_share = None, offer_share
        for key, count in counts.items():
            if key == offering or count <= 0:
                continue
            share = count / self._weight(key)
            if share > worst_share or (
                share == worst_share
                and worst_key is not None
                and key < worst_key
            ):
                worst_key, worst_share = key, share
        if worst_key is None:
            return None
        for idx in range(len(self._pending) - 1, -1, -1):
            if (
                idx not in exclude
                and self._tenant_key(self._pending[idx]) == worst_key
            ):
                return idx
        return None  # pragma: no cover - counts said it exists

    def take_preempted(self) -> list[tuple[Any, str | None]]:
        """Drain the preempted-items list (item, tenant) — the embedder
        resolves each to an explicit :class:`Preempted` outcome in the
        request's result position."""
        with self._lock:
            out, self._preempted = self._preempted, []
            return out

    # -- service order ----------------------------------------------------

    def drain_all(
        self, record_waits: bool = True
    ) -> tuple[list, list[float], list[float]]:
        """Base :meth:`~beholder_tpu_torch.reliability.shed.IntakeQueue.
        drain_all`, with the pending list re-ordered into weighted
        deficit-round-robin order first — the claim loop consumes the
        drained batch head-first, so DRR order IS the service order.
        Waits and stamps stay item-parallel through the reorder."""
        with self._lock:
            order = self._drr_order()
            self._pending = [self._pending[i] for i in order]
            self._enqueued_at = [self._enqueued_at[i] for i in order]
        return super().drain_all(record_waits=record_waits)

    def _drr_order(self) -> list[int]:
        """The DRR permutation of the current pending indices (called
        under the lock). Quantum = the smallest pending cost, so every
        cycle lets a weight-1.0 tenant afford at least its cheapest
        request; deficits reset when a tenant's queue empties (no
        banking idle credit — the classic algorithm)."""
        if len(self._pending) <= 1:
            return list(range(len(self._pending)))
        queues: dict[str, deque[int]] = {}
        tenant_order: list[str] = []
        costs: list[float] = []
        for idx, item in enumerate(self._pending):
            key = self._tenant_key(item)
            if key not in queues:
                queues[key] = deque()
                tenant_order.append(key)
            queues[key].append(idx)
            costs.append(max(self._item_cost(item), 1e-9))
        if len(queues) == 1:
            return list(range(len(self._pending)))
        quantum = min(costs)
        deficits = {key: 0.0 for key in queues}
        out: list[int] = []
        while queues:
            for key in tenant_order:
                q = queues.get(key)
                if q is None:
                    continue
                deficits[key] += quantum * self._weight(key)
                while q and costs[q[0]] <= deficits[key]:
                    idx = q.popleft()
                    deficits[key] -= costs[idx]
                    out.append(idx)
                if not q:
                    del queues[key]
                    deficits[key] = 0.0
        return out
