"""The bursty and adversarial replay harness (the port's own copy of the
reference's ``control/replay.py``).

Deterministic request traces (every generator is seeded, so a replayed
scenario is the same workload every run) driven through any engine with
the ``submit`` / ``run_pending`` contract (a
:class:`~beholder_tpu_torch.models.serving.ContinuousBatcher` or a
:class:`~beholder_tpu_torch.cluster.router.ClusterScheduler`):

- :func:`flash_crowd`: everyone arrives at once;
- :func:`shared_prefix_storm`: one hot prefix, many requests;
- :func:`tenant_skew`: one tenant floods the intake before a small
  "victim" tenant submits (under FIFO the victim waits behind the flood;
  under deficit round robin it claims near the front);
- :func:`mixed_prefill_decode`: long-prefix/short-horizon against
  short-prefix/long-horizon;
- :func:`recovery_storm`: decode-heavy traffic for a replay against a
  failover-armed cluster with an injected worker kill.

:func:`replay` drives a scenario in arrival-order bursts (submit a burst,
then ``run_pending``) and folds per-tenant admissions, sheds, outcomes
and, with a tracker or a recorder, per-tenant latency. Bursts, not
wall-clock sleeps: the scenarios encode order and pressure.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


@dataclass
class TimedRequest:
    """One arrival: burst index (arrivals with the same ``burst``
    submit together, bursts replay in order), the request, and its
    tenant (mirrored from ``request.tenant`` for report folding)."""

    burst: int
    request: Any
    tenant: str | None = None


@dataclass
class Scenario:
    """One adversarial trace: named, deterministic, replayable."""

    name: str
    arrivals: list[TimedRequest]
    note: str = ""
    #: tenants the fairness report contrasts (skewed = the flooding
    #: tenant, victim = the minority one), when the scenario has them
    skewed_tenant: str | None = None
    victim_tenant: str | None = None


def make_request(
    seed: int,
    prefix_t: int = 8,
    horizon: int = 16,
    tenant: str | None = None,
    deadline=None,
    prefix_seed: int | None = None,
):
    """One deterministic serving request: the progress curve derives
    from ``prefix_seed`` (defaults to ``seed``; a SHARED prefix_seed
    gives byte-identical prefixes — the shared-prefix storm's whole
    point), statuses ride CONVERTING like the bench mixes."""
    from beholder_tpu_torch.models.serving import Request
    from beholder_tpu_torch.ops import STATUS_NAMES

    rng = np.random.default_rng(
        7000 + (prefix_seed if prefix_seed is not None else seed)
    )
    progress = np.cumsum(1.0 + rng.normal(0.0, 0.05, prefix_t + 1))
    statuses = np.full(len(progress), STATUS_NAMES.index("CONVERTING"))
    return Request(
        progress, statuses, horizon, deadline=deadline, tenant=tenant
    )


# -- scenario generators ------------------------------------------------


def flash_crowd(
    n: int = 24,
    tenants: tuple[str, ...] = ("a", "b", "c"),
    prefix_t: int = 8,
    horizon: int = 12,
) -> Scenario:
    """Everyone at once: ``n`` requests round-robined over ``tenants``
    land in ONE burst — the bounded intake and the fair-admission
    pressure policy are the only things standing."""
    arrivals = [
        TimedRequest(
            0,
            make_request(
                i, prefix_t, horizon, tenant=tenants[i % len(tenants)]
            ),
            tenants[i % len(tenants)],
        )
        for i in range(n)
    ]
    return Scenario(
        "flash_crowd", arrivals,
        note=f"{n} requests, one burst, {len(tenants)} tenants",
    )


def shared_prefix_storm(
    n: int = 16,
    tenants: tuple[str, ...] = ("a", "b"),
    prefix_t: int = 16,
    horizon: int = 8,
) -> Scenario:
    """One hot prefix, many requests: every request shares the SAME
    progress prefix (prefix_seed pinned), so a prefix cache collapses
    the prefill while fairness schedules the decode."""
    arrivals = [
        TimedRequest(
            i // 8,
            make_request(
                i, prefix_t, horizon,
                tenant=tenants[i % len(tenants)], prefix_seed=1,
            ),
            tenants[i % len(tenants)],
        )
        for i in range(n)
    ]
    return Scenario(
        "shared_prefix_storm", arrivals,
        note=f"{n} requests over one shared {prefix_t}-token prefix",
    )


def tenant_skew(
    heavy_n: int = 16,
    victim_n: int = 2,
    prefix_t: int = 8,
    horizon: int = 16,
    heavy: str = "flood",
    victim: str = "victim",
) -> Scenario:
    """The headline fairness scenario: the heavy tenant submits its
    whole flood FIRST, the victim's few requests arrive at the back of
    the same burst — exactly where FIFO buries them and DRR does not."""
    arrivals = [
        TimedRequest(
            0, make_request(i, prefix_t, horizon, tenant=heavy), heavy
        )
        for i in range(heavy_n)
    ] + [
        TimedRequest(
            0,
            make_request(
                1000 + i, prefix_t, horizon, tenant=victim
            ),
            victim,
        )
        for i in range(victim_n)
    ]
    return Scenario(
        "tenant_skew", arrivals,
        note=(
            f"{heavy_n}-request flood from {heavy!r} ahead of "
            f"{victim_n} from {victim!r}, one burst"
        ),
        skewed_tenant=heavy,
        victim_tenant=victim,
    )


def mixed_prefill_decode(
    n: int = 12,
    prefix_long: int = 32,
    prefix_short: int = 4,
    horizon_long: int = 24,
    horizon_short: int = 4,
) -> Scenario:
    """Prefill-heavy against decode-heavy: even indices are long-prefix
    short-horizon (prefill load), odd are short-prefix long-horizon
    (decode load) — the routing pressure shape where one resource
    figure (free pages) misdescribes the other (tick cadence)."""
    arrivals = []
    for i in range(n):
        heavy_prefill = i % 2 == 0
        arrivals.append(
            TimedRequest(
                i // 6,
                make_request(
                    i,
                    prefix_long if heavy_prefill else prefix_short,
                    horizon_short if heavy_prefill else horizon_long,
                    tenant="prefill" if heavy_prefill else "decode",
                ),
                "prefill" if heavy_prefill else "decode",
            )
        )
    return Scenario(
        "mixed_prefill_decode", arrivals,
        note=f"{n} alternating prefill-heavy/decode-heavy requests",
    )


def recovery_storm(
    n: int = 8,
    prefix_t: int = 8,
    horizon: int = 24,
    deadline_s: float | None = None,
) -> Scenario:
    """Decode-heavy traffic to replay against a failover-armed cluster
    with an injected mid-stream worker kill (the caller arms the
    chaos) — recovery re-admission and
    deadline expiry under load. ``deadline_s`` attaches a deadline to
    every request (None = none)."""
    from beholder_tpu_torch.reliability.policy import Deadline

    arrivals = [
        TimedRequest(
            0,
            make_request(
                i, prefix_t, horizon,
                tenant="storm",
                deadline=(
                    Deadline.after(deadline_s)
                    if deadline_s is not None
                    else None
                ),
            ),
            "storm",
        )
        for i in range(n)
    ]
    return Scenario(
        "recovery_storm", arrivals,
        note=f"{n} decode-heavy requests for a kill-mid-stream replay",
    )


#: name -> zero-arg default construction, the bench/CLI surface
SCENARIOS: dict[str, Callable[[], Scenario]] = {
    "flash_crowd": flash_crowd,
    "shared_prefix_storm": shared_prefix_storm,
    "tenant_skew": tenant_skew,
    "mixed_prefill_decode": mixed_prefill_decode,
    "recovery_storm": recovery_storm,
}


# -- the replay driver --------------------------------------------------


@dataclass
class ReplayReport:
    """One replay's evidence: admissions/sheds/outcomes per tenant,
    wall, (tracker-attached) per-tenant digests, and — when a flight
    recorder rode the replay — per-tenant CLAIM-RELATIVE latency.

    The claim-relative fold is the fairness figure: a request's
    latency is measured from the replay's FIRST claim to the request's
    own first token (claim offset + TTFT), so a request parked behind
    a flood pays its queue position — exactly what the per-request
    TTFT digest (anchored at the request's OWN claim) cannot see.
    Host-speed divides out of the victim/flood ratio: both tenants'
    claims ride the same rounds of the same run."""

    scenario: str
    results: list = field(default_factory=list)
    admitted: dict[str, int] = field(default_factory=dict)
    shed: dict[str, dict[str, int]] = field(default_factory=dict)
    outcomes: dict[str, dict[str, int]] = field(default_factory=dict)
    wall_s: float = 0.0
    tenants: dict[str, Any] = field(default_factory=dict)
    #: tenant -> {p50_ms, p95_ms, count} of claim-relative first-token
    #: latency (recorder-armed replays only)
    tenant_latency: dict[str, dict[str, float]] = field(
        default_factory=dict
    )

    def tenant_p95_ms(self, tenant: str) -> float:
        stats = self.tenant_latency.get(tenant)
        return float(stats["p95_ms"]) if stats else 0.0

    def fairness_ratio(self, victim: str, skewed: str) -> float | None:
        """victim p95 / flooding-tenant p95 of claim-relative
        first-token latency — small when fairness protects the
        minority tenant (its claims land near the front), rising
        toward (or past) 1.0 as the victim is buried behind the flood.
        None until both tenants have folded latencies."""
        v = self.tenant_p95_ms(victim)
        s = self.tenant_p95_ms(skewed)
        if v <= 0.0 or s <= 0.0:
            return None
        return v / s

    def to_dict(self) -> dict[str, Any]:
        return {
            "scenario": self.scenario,
            "admitted": dict(self.admitted),
            "shed": {k: dict(v) for k, v in self.shed.items()},
            "outcomes": {k: dict(v) for k, v in self.outcomes.items()},
            "wall_s": round(self.wall_s, 4),
            "tenants": self.tenants,
            "tenant_latency": {
                k: dict(v) for k, v in self.tenant_latency.items()
            },
        }


def fold_tenant_latency(events) -> dict[str, dict[str, float]]:
    """Fold one flight-recorder event stream into per-tenant
    claim-relative first-token latency quantiles (exact percentiles —
    replay populations are small; the P² digests stay the streaming
    path). The origin is the stream's FIRST claim, so a replayed
    burst's queue-position cost is on every later request's number."""
    from beholder_tpu_torch.obs.timeline import build_timelines

    report = build_timelines(events)
    origin = min(
        (t.legs[0].claim_us for t in report.timelines if t.legs),
        default=0,
    )
    samples: dict[str, list[float]] = {}
    for timeline in report.timelines:
        if not timeline.legs or timeline.ttft_s is None:
            continue
        rel_s = (
            (timeline.legs[0].claim_us - origin) / 1e6
            + timeline.ttft_s
        )
        samples.setdefault(
            timeline.tenant or "default", []
        ).append(rel_s)
    return {
        tenant: {
            "p50_ms": round(
                float(np.percentile(values, 50)) * 1e3, 4
            ),
            "p95_ms": round(
                float(np.percentile(values, 95)) * 1e3, 4
            ),
            "count": len(values),
        }
        for tenant, values in sorted(samples.items())
    }


def replay(
    engine,
    scenario: Scenario,
    tracker=None,
    recorder=None,
    run_pending_kwargs: dict | None = None,
    between_bursts: Callable[[int], None] | None = None,
) -> ReplayReport:
    """Drive ``scenario`` through ``engine`` (anything with the
    ``submit``/``run_pending`` contract) burst by burst: submit every
    arrival of a burst, ``run_pending`` once, move on — the
    compressed-time replay (order and pressure are what the scenarios
    encode; wall-clock gaps would only add host noise).

    ``between_bursts(i)`` runs after burst ``i`` completes — the chaos
    hook (inject a worker kill, flip a knob) the recovery-storm
    scenario exists for. ``tracker`` folds per-tenant digests into the
    report; ``recorder`` (a ring the CALLER cleared after warming the
    jits — compile walls must not masquerade as scheduling) folds the
    claim-relative per-tenant latency quantiles, the fairness figure.
    Results collect in burst order; outcome classes (ndarray = served,
    everything else by its ``outcome`` attr) count per tenant in
    submission order per burst."""
    import time as _time

    report = ReplayReport(scenario=scenario.name)
    kwargs = run_pending_kwargs or {}
    by_burst: dict[int, list[TimedRequest]] = {}
    for arrival in scenario.arrivals:
        by_burst.setdefault(arrival.burst, []).append(arrival)

    t0 = _time.perf_counter()
    for burst in sorted(by_burst):
        submitted: list[TimedRequest] = []
        for arrival in by_burst[burst]:
            tenant = arrival.tenant or "default"
            admission = engine.submit(arrival.request)
            if admission.accepted:
                report.admitted[tenant] = (
                    report.admitted.get(tenant, 0) + 1
                )
                submitted.append(arrival)
            else:
                by_reason = report.shed.setdefault(tenant, {})
                by_reason[admission.reason] = (
                    by_reason.get(admission.reason, 0) + 1
                )
        results = engine.run_pending(**kwargs)
        report.results.extend(results)
        # outcome folding WITHOUT positional alignment: result ORDER is
        # engine-specific (the cluster returns admission order, the
        # single-engine batcher returns DRR claim order with preempted
        # outcomes appended), so a zip against submission order would
        # misattribute. Instead: explicit outcome objects (Preempted /
        # Dropped / DeadlineExceededResult) count by their OWN tenant
        # when they carry one (preemptions do; tenant-less engine
        # outcomes land in "unknown"), and each tenant's remaining
        # admissions this burst count ok — every admitted request
        # either served or resolved explicitly, so the accounting is
        # exact wherever outcomes carry their tenant.
        admitted_burst: dict[str, int] = {}
        for arrival in submitted:
            tenant = arrival.tenant or "default"
            admitted_burst[tenant] = admitted_burst.get(tenant, 0) + 1
        explicit_by_tenant: dict[str, int] = {}
        for res in results:
            if isinstance(res, np.ndarray):
                continue
            outcome = getattr(res, "outcome", type(res).__name__)
            tenant = getattr(res, "tenant", None) or "unknown"
            by_outcome = report.outcomes.setdefault(tenant, {})
            by_outcome[outcome] = by_outcome.get(outcome, 0) + 1
            explicit_by_tenant[tenant] = (
                explicit_by_tenant.get(tenant, 0) + 1
            )
        for tenant, admitted in admitted_burst.items():
            ok = admitted - explicit_by_tenant.get(tenant, 0)
            if ok > 0:
                by_outcome = report.outcomes.setdefault(tenant, {})
                by_outcome["ok"] = by_outcome.get("ok", 0) + ok
        if between_bursts is not None:
            between_bursts(burst)
    report.wall_s = _time.perf_counter() - t0
    if tracker is not None:
        report.tenants = tracker.tenant_stats()
    if recorder is not None:
        report.tenant_latency = fold_tenant_latency(recorder.events())
    return report
