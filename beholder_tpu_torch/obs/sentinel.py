"""Online regression sentinel: perf_explain's verdict, live on the daemon.

The port's own copy of the reference's ``obs/sentinel.py`` (host-side
Python, no device work). :mod:`beholder_tpu_torch.tools.perf_explain` ranks
phase-attributed regressions between two finished runs; this module runs
the same attribution continuously. A flight-recorder listener folds every
complete slice into event-time buckets per ``phase@worker`` and per kernel
family, and every ``check_every`` events compares a fast window (the last
few buckets) against a slow baseline (the span before), per second. When
the top-ranked regressor's fast rate exceeds ``growth_threshold`` times its
baseline rate, and clears the absolute ``min_rate`` floor, the check
breaches, with :func:`~beholder_tpu_torch.tools.perf_explain.explain`'s
ranking attached ("``decode_step on decode-1 +62% of the regression``").

Verdicts are hysteretic: ``open_after`` consecutive breaching checks open
one, ``close_after`` consecutive clean checks close it. An open verdict
(and, on its own, a fast burn probed from the linked SLO tracker) opens an
incident on the linked :class:`~beholder_tpu_torch.obs.retention.
TraceVault`, which keeps every trace until its budget is spent.

Surfaces: the ``beholder_sentinel_*`` series (registered only with a
registry), ``GET /debug/sentinel`` (the snapshot with the ranked
explanation) and a ``/healthz`` check beside the SLO burn check. Off by
default (``instance.observability.sentinel.*``,
:func:`beholder_tpu_torch.obs.sentinel_from_config`).

Windows are event time (bucketed on ``ts_us``), not wall clock, so the fold
is deterministic under replay: a recorded run with an injected phase
slowdown gives the same verdict every time.
"""

from __future__ import annotations

import json
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Any

from .timeline import _NESTED_SLICES


@dataclass
class SentinelConfig:
    """Declarative sentinel policy (``instance.observability.
    sentinel.*``).

    - ``bucket_s``: event-time bucket width;
    - ``fast_buckets`` / ``baseline_buckets``: the fast window and the
      slow baseline it is compared against, in buckets;
    - ``growth_threshold``: fast rate must exceed this multiple of the
      baseline rate to count as a breach;
    - ``min_rate``: absolute floor (seconds of attributed time per
      second) below which a ratio is noise, not a regression;
    - ``open_after`` / ``close_after``: hysteresis — consecutive
      breaching checks to open a verdict, consecutive clean checks to
      close it;
    - ``check_every``: run the comparison every N folded events (the
      fold itself is O(1) per event; the check is the heavier part).
    """

    bucket_s: float = 10.0
    fast_buckets: int = 3
    baseline_buckets: int = 30
    growth_threshold: float = 1.5
    min_rate: float = 0.01
    open_after: int = 2
    close_after: int = 3
    check_every: int = 256

    def __post_init__(self):
        if self.bucket_s <= 0:
            raise ValueError(f"bucket_s must be > 0, got {self.bucket_s}")
        if self.fast_buckets < 1 or self.baseline_buckets < 1:
            raise ValueError("fast_buckets and baseline_buckets must be >= 1")
        if self.growth_threshold <= 1.0:
            raise ValueError(
                "growth_threshold must be > 1.0, got "
                f"{self.growth_threshold}"
            )
        if self.open_after < 1 or self.close_after < 1:
            raise ValueError("open_after and close_after must be >= 1")


class Sentinel:
    """The online regression detector: fold slices into event-time
    buckets, periodically diff fast-vs-baseline with perf_explain's
    ranking, raise hysteretic verdicts, and open incidents on the
    linked vault.

    ``slo`` arms the independent fast-burn incident trigger;
    ``vault`` receives :meth:`~beholder_tpu_torch.obs.retention.TraceVault.
    open_incident` / ``close_incident`` calls; ``registry`` arms the
    ``beholder_sentinel_*`` catalog (lazy — absent until a sentinel
    exists, keeping the default exposition byte-identical).
    """

    def __init__(
        self,
        config: SentinelConfig | None = None,
        slo=None,
        vault=None,
        registry=None,
    ):
        self.config = config or SentinelConfig()
        self.slo = slo
        self.vault = vault
        self._lock = threading.RLock()
        self._bucket_us = int(self.config.bucket_s * 1e6)
        #: bucket index -> {"phases": {phase@worker: s},
        #:                  "families": {family@worker: s}}
        self._buckets: dict[int, dict[str, dict[str, float]]] = {}
        self._latest_bucket: int | None = None
        self._events_since_check = 0
        self.checks = 0
        self.breaches = 0
        #: hysteresis state
        self._breach_streak = 0
        self._clean_streak = 0
        self.active: dict[str, Any] | None = None
        self.last_check: dict[str, Any] | None = None
        self._burn_incident = False
        self._metrics = None
        if registry is not None:
            from beholder_tpu_torch.metrics import get_or_create

            registry = getattr(registry, "registry", registry)
            self._metrics = {
                "checks": get_or_create(
                    registry, "counter",
                    "beholder_sentinel_checks_total",
                    "Fast-vs-baseline attribution comparisons run by "
                    "the regression sentinel",
                ),
                "breaches": get_or_create(
                    registry, "counter",
                    "beholder_sentinel_breaches_total",
                    "Sentinel checks whose top-ranked phase breached "
                    "the growth threshold",
                ),
                "active": get_or_create(
                    registry, "gauge",
                    "beholder_sentinel_active",
                    "1 while a sentinel regression verdict is open "
                    "(hysteresis applied), else 0",
                ),
                "ratio": get_or_create(
                    registry, "gauge",
                    "beholder_sentinel_regression_ratio",
                    "Fast-window / baseline attributed-time ratio of "
                    "the top-ranked phase at the last check",
                ),
            }

    # -- the streaming fold (flight-recorder listener) -------------------

    def on_event(self, event: dict[str, Any]) -> None:
        """Fold one flight-recorder event: complete slices only
        (``ph == "X"``), skipping nested slices so a round's time is
        charged once — the same classification as
        :func:`~beholder_tpu_torch.obs.timeline.phase_walls`."""
        if event.get("ph") != "X":
            with self._lock:
                self._maybe_check()
            return
        name = event.get("name")
        if name in _NESTED_SLICES:
            return
        args = event.get("args", {}) or {}
        worker = args.get("worker") or "all"
        dur_s = float(event.get("dur_us", 0) or 0) / 1e6
        ts_us = int(event.get("ts_us", 0) or 0)
        idx = ts_us // self._bucket_us
        with self._lock:
            bucket = self._buckets.get(idx)
            if bucket is None:
                bucket = self._buckets[idx] = {
                    "phases": defaultdict(float),
                    "families": defaultdict(float),
                }
                if (
                    self._latest_bucket is None
                    or idx > self._latest_bucket
                ):
                    self._latest_bucket = idx
                    self._prune()
            bucket["phases"][f"{name}@{worker}"] += dur_s
            family = args.get("family")
            if family:
                bucket["families"][f"{family}@{worker}"] += dur_s
            self._maybe_check()

    def _prune(self) -> None:
        """Drop buckets older than the baseline span — bounded memory,
        same contract as every other streaming fold."""
        horizon = (
            self._latest_bucket
            - self.config.fast_buckets
            - self.config.baseline_buckets
        )
        for idx in [i for i in self._buckets if i < horizon]:
            del self._buckets[idx]

    def _maybe_check(self) -> None:
        self._events_since_check += 1
        if self._events_since_check >= self.config.check_every:
            self._events_since_check = 0
            self._check_locked()

    # -- the comparison ---------------------------------------------------

    def check(self) -> dict[str, Any] | None:
        """Run the fast-vs-baseline comparison now (tests and the
        bench replay call this directly; live traffic goes through the
        ``check_every`` cadence). Returns the check record, or None if
        the baseline has no coverage yet."""
        with self._lock:
            return self._check_locked()

    def _windows(self) -> tuple[dict, dict, int] | None:
        if self._latest_bucket is None:
            return None
        fast_lo = self._latest_bucket - self.config.fast_buckets + 1
        base_lo = fast_lo - self.config.baseline_buckets
        fast = {"phases": defaultdict(float), "families": defaultdict(float)}
        base = {"phases": defaultdict(float), "families": defaultdict(float)}
        base_n = 0
        for idx, bucket in self._buckets.items():
            dst = None
            if idx >= fast_lo:
                dst = fast
            elif idx >= base_lo:
                dst = base
                base_n += 1
            if dst is None:
                continue
            for kind in ("phases", "families"):
                for key, s in bucket[kind].items():
                    dst[kind][key] += s
        if base_n == 0:
            return None
        return fast, base, base_n

    def _check_locked(self) -> dict[str, Any] | None:
        windows = self._windows()
        self.checks += 1
        if self._metrics is not None:
            self._metrics["checks"].inc()
        if windows is None:
            return None
        fast, base, base_n = windows
        fast_span_s = self.config.fast_buckets * self.config.bucket_s
        base_span_s = base_n * self.config.bucket_s
        # per-second normalize so a 30-bucket baseline and a 3-bucket
        # fast window compare rate against rate, then hand perf_explain
        # the same {"phases", "families"} walls shape it ranks in CI
        base_walls = {
            kind: {k: s / base_span_s for k, s in base[kind].items()}
            for kind in ("phases", "families")
        }
        fast_walls = {
            kind: {k: s / fast_span_s for k, s in fast[kind].items()}
            for kind in ("phases", "families")
        }
        from beholder_tpu_torch.tools.perf_explain import explain

        explanation = explain(base_walls, fast_walls)
        top = explanation["ranked"][0] if explanation["ranked"] else None
        ratio = 0.0
        breach = False
        if top is not None:
            baseline_rate = top["baseline"]
            current_rate = top["current"]
            ratio = (
                current_rate / baseline_rate
                if baseline_rate > 0
                else float("inf") if current_rate > 0 else 0.0
            )
            breach = (
                current_rate >= self.config.min_rate
                and baseline_rate >= 0.0
                and current_rate
                >= self.config.growth_threshold * max(baseline_rate, 0.0)
                and ratio >= self.config.growth_threshold
            )
        record = {
            "check": self.checks,
            "breach": breach,
            "ratio": (
                round(ratio, 4) if ratio != float("inf") else "inf"
            ),
            "verdict": explanation["verdict"] if breach else None,
            "top": top,
            "ranked": explanation["ranked"][:5],
            "baseline_buckets": base_n,
        }
        self.last_check = record
        if self._metrics is not None and ratio != float("inf"):
            self._metrics["ratio"].set(round(ratio, 6))
        if breach:
            self.breaches += 1
            self._breach_streak += 1
            self._clean_streak = 0
            if self._metrics is not None:
                self._metrics["breaches"].inc()
            if (
                self.active is None
                and self._breach_streak >= self.config.open_after
            ):
                self.active = {
                    "verdict": explanation["verdict"],
                    "top": top,
                    "ranked": explanation["ranked"][:5],
                    "opened_check": self.checks,
                }
                if self._metrics is not None:
                    self._metrics["active"].set(1.0)
                if self.vault is not None:
                    incident = self.vault.open_incident(
                        f"sentinel: {explanation['verdict']}",
                        explanation={
                            "verdict": explanation["verdict"],
                            "ranked": explanation["ranked"][:5],
                        },
                    )
                    self.active["incident"] = incident["id"]
        else:
            self._clean_streak += 1
            self._breach_streak = 0
            if (
                self.active is not None
                and self._clean_streak >= self.config.close_after
            ):
                self.active = None
                if self._metrics is not None:
                    self._metrics["active"].set(0.0)
                if self.vault is not None and not self._burn_incident:
                    self.vault.close_incident()
        self._check_burn()
        return record

    def _check_burn(self) -> None:
        """The independent fast-burn trigger: an SLO fast-window burn
        above threshold opens an incident even when no phase regressed
        (capacity loss looks like queueing, not kernel time)."""
        if self.slo is None or self.vault is None:
            return
        try:
            burn = self.slo.burn_rate("fast")
            threshold = self.slo.config.fast_burn_threshold
        except Exception:
            return
        if burn > threshold:
            if not self._burn_incident:
                self._burn_incident = True
                self.vault.open_incident(
                    f"fast burn {burn:.1f}x > {threshold:.1f}x",
                    explanation=(
                        {
                            "verdict": self.active["verdict"],
                            "ranked": self.active["ranked"],
                        }
                        if self.active
                        else None
                    ),
                )
        elif self._burn_incident:
            self._burn_incident = False
            if self.active is None:
                self.vault.close_incident()

    # -- surfaces ---------------------------------------------------------

    def health(self) -> tuple[bool, str]:
        """The ``/healthz`` leg beside the SLO burn check: degraded
        while a regression verdict is open."""
        with self._lock:
            if self.active is not None:
                return False, f"regression: {self.active['verdict']}"
            return True, f"ok ({self.checks} checks, {self.breaches} breaches)"

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "schema": "beholder-sentinel",
                "checks": self.checks,
                "breaches": self.breaches,
                "active": dict(self.active) if self.active else None,
                "last_check": (
                    dict(self.last_check) if self.last_check else None
                ),
                "burn_incident": self._burn_incident,
                "buckets": len(self._buckets),
                "config": {
                    "bucket_s": self.config.bucket_s,
                    "fast_buckets": self.config.fast_buckets,
                    "baseline_buckets": self.config.baseline_buckets,
                    "growth_threshold": self.config.growth_threshold,
                    "min_rate": self.config.min_rate,
                    "open_after": self.config.open_after,
                    "close_after": self.config.close_after,
                },
            }

    def route(self):
        """httpd Route for ``GET /debug/sentinel``."""

        def sentinel_route():
            return (
                200,
                "application/json",
                json.dumps(self.snapshot()).encode(),
            )

        return sentinel_route
