"""Schema-versioned raw-timing artifacts, and their validator.

The port's own copy of the reference's ``artifact.py`` (host-side Python;
the port imports nothing of the JAX package). A profiling or bench run
writes ``<name>.json`` with the RAW per-rep timings behind each headline
figure (:meth:`ArtifactRecorder.record_raw`, or the module-level
:func:`record_raw` through the current recorder), each section's result
with optional metrics-exposition snapshots around it, the run's counter
blocks, and enough provenance to read the numbers later. The artifact is
written EVEN WHEN the run errors or sections are skipped (``outcome``
says which).

The schema is the reference's, version for version: an artifact written
here validates under the reference's :func:`validate`, and the reverse.
:func:`validate` is the authoritative checker::

    {
      "schema": "beholder-bench-artifact",
      "schema_version": 16,
      "name": "...",
      "created_unix_s": 1700000000.0,
      "wall_s": 12.3,
      "outcome": "ok" | "error" | "partial",
      "error": null | "...",
      "skipped": [...],
      "provenance": {"python": ..., "platform": ..., ...},
      "sections": {"<section>": {"result": {...},
                                  "metrics_before": null | "<exposition>",
                                  "metrics_after": null | "<exposition>"}},
      "raw_timings": [{"label": ..., "method": ..., "samples_s": [...],
                       ...extra}],
      "reliability": {...},   # v2: retries, sheds, dead-lettered
      "cache": {...},         # v3: prefix-cache and keyed-cache counters
      "spec": {...},          # v4: speculative decoding, mean_accept_len
      "attribution": {...},   # v5: flight-recorder roofline summary
      "cluster": {...},       # v6: shards, handoffs, routes, per-shard sheds
      "failover": {...},      # v7: recoveries, migrated pages, deadlines
      "slo": {...},           # v8: request-level latency digests
      "kernel": {...},        # v9: fused paged-kernel evidence
      "ingest": {...},        # v10: batched wire ingest
      "control": {...},       # v11: control-plane fairness
      "flight_plane": {...},  # v12: cluster-wide ring merge
      "retention": {...},     # v13: tail-based retention
      "capacity": {...},      # v14: KV capacity per chip
      "fabric": {...},        # v15: cluster memory fabric
      "group": {...}          # v16: group-parallel decode
    }

Each versioned block's keys are the ``*_COUNTERS`` maps and ``EMPTY_*``
blocks below; an artifact of version ``v`` must carry every block of
version ``<= v``, so older artifacts stay valid. Counter blocks
ACCUMULATE across the registries handed to ``record_*`` (a registry
without a series contributes zero); summary blocks are last-writer-wins.

Differences from the reference, forced by the framework:

- :func:`provenance` probes torch, not jax: ``torch`` and ``cuda``
  (``torch.version.cuda``), ``device`` as ``{"platform": "gpu" | "cpu",
  "kind", "count"}`` (the card's name from ``torch.cuda.get_device_name``),
  and ``power_limit_w`` from ``nvidia-smi`` (a card may be capped below its
  maximum and then runs slower under load);
- :data:`DEFAULT_DIR` is ``<repo>/chiprun_out/artifacts``, not
  ``<repo>/artifacts`` (that directory holds the reference's committed
  artifacts); ``$BENCH_ARTIFACT_DIR`` overrides it, as in the reference.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any

SCHEMA = "beholder-bench-artifact"
SCHEMA_VERSION = 16

#: v5: the attribution block's required shape (an empty summary is
#: valid — a run that never armed the flight recorder still writes a
#: v5 artifact)
EMPTY_ATTRIBUTION = {
    "phase_ms_pcts": {},
    "kernel_ceiling_fracs": {},
    "stall_pct": 0.0,
}

#: artifact key -> the counter family summed into it (across labels)
RELIABILITY_COUNTERS = {
    "retries": "beholder_retry_attempts_total",
    "sheds": "beholder_serving_shed_total",
    "dead_lettered": "beholder_dead_lettered_total",
}

#: v3: artifact key -> the cache counter family summed into it. The
#: prefix-cache eviction and core-cache eviction series both fold into
#: ``evictions`` (one "pages/entries dropped under pressure" figure).
CACHE_COUNTERS = {
    "prefix_hits": ("beholder_prefix_cache_hits_total",),
    "prefix_misses": ("beholder_prefix_cache_misses_total",),
    "evictions": (
        "beholder_prefix_cache_evictions_total",
        "beholder_cache_evictions_total",
    ),
    "singleflight_collapsed": (
        "beholder_cache_singleflight_collapsed_total",
    ),
}

#: v3: the snapshot gauge — pages resident in the prefix cache when the
#: registry was recorded (latest snapshot wins, not a sum)
CACHE_PAGES_GAUGE = "beholder_prefix_cache_cached_pages"

#: v4: artifact key -> the speculative-decoding counter summed into it
SPEC_COUNTERS = {
    "drafted": "beholder_spec_drafted_tokens_total",
    "accepted": "beholder_spec_accepted_tokens_total",
    "rejected": "beholder_spec_rejected_tokens_total",
    "rollbacks": "beholder_spec_rollbacks_total",
}

#: v4: the two series ``mean_accept_len`` derives from (emitted tokens
#: per verify slot-step)
SPEC_EMITTED_COUNTER = "beholder_spec_emitted_tokens_total"
SPEC_STEPS_COUNTER = "beholder_spec_verify_steps_total"

#: v6: artifact key -> the cluster counter summed into it
CLUSTER_COUNTERS = {
    "transfers": "beholder_cluster_transfers_total",
    "transferred_pages": "beholder_cluster_transferred_pages_total",
    "routed": "beholder_cluster_routes_total",
}

#: v6: the snapshot gauge — decode shards in the cluster when the
#: registry was recorded (latest snapshot wins, not a sum)
CLUSTER_SHARDS_GAUGE = "beholder_cluster_shards"

#: v6: per-shard shed attribution (the labelled intake twin); totals
#: fold by the ``queue`` label into ``sheds_by_shard``
CLUSTER_SHED_COUNTER = "beholder_intake_shed_total"

#: v7: artifact key -> the failover counter summed into it
FAILOVER_COUNTERS = {
    "recoveries": "beholder_failover_recoveries_total",
    "migrated_pages": "beholder_failover_migrated_pages_total",
    "deadline_exceeded": "beholder_failover_deadline_exceeded_total",
}

#: v8: the slo block's required shape (an empty block is valid — a run
#: that never armed an SLO tracker still writes a v8 artifact)
EMPTY_SLO = {
    "ttft_p50_ms": 0.0,
    "ttft_p95_ms": 0.0,
    "tpot_p50_ms": 0.0,
    "attainment": 0.0,
    "worst_request": {},
}

#: v9: the kernel block's required shape (an empty block is valid — a
#: run that never timed the fused kernel still writes a v9 artifact)
EMPTY_KERNEL = {
    "fused_verify_ratio": 0.0,
    "fused_verify_wall_s": 0.0,
    "dense_verify_wall_s": 0.0,
    "autotuned": {},
}

#: v10: the ingest block's required shape (an empty block is valid — a
#: run that never drove the batched wire still writes a v10 artifact)
EMPTY_INGEST = {
    "wire_ingest_ratio": 0.0,
    "native_msgs_per_sec": 0.0,
    "python_msgs_per_sec": 0.0,
    "mean_batch_size": 0.0,
    "batched_msgs": 0.0,
}

#: v11: the control block's required shape (an empty block is valid —
#: a run that never replayed the control scenarios still writes a v11
#: artifact)
EMPTY_CONTROL = {
    "victim_ttft_ratio": 0.0,
    "tail_fairness_ratio": 0.0,
    "uncontrolled_fairness_ratio": 0.0,
    "admitted_by_tenant": {},
    "shed_by_tenant": {},
    "k_shed_events": 0.0,
    "scale_events": 0.0,
}

#: v12: the flight-plane block's required shape (an empty block is
#: valid — a run that never armed the plane still writes a v12
#: artifact)
EMPTY_FLIGHT_PLANE = {
    "workers": 0.0,
    "merged_events": 0.0,
    "flow_edges": 0.0,
    "max_abs_skew_us": 0.0,
}

#: v13: the retention block's required shape (an empty block is valid
#: — a run that never armed the trace vault still writes a v13
#: artifact)
EMPTY_RETENTION = {
    "kept": 0.0,
    "evaluated": 0.0,
    "keep_rate": 0.0,
    "overhead_ratio": 0.0,
    "incidents": 0.0,
}

#: v14: the capacity block's required shape (an empty block is valid —
#: a run that never ran the capacity scenario still writes a v14
#: artifact)
EMPTY_CAPACITY = {
    "admitted_bf16": 0.0,
    "admitted_int8": 0.0,
    "admitted_fp8": 0.0,
    "capacity_admitted_ratio": 0.0,
    "fused_wave_ratio": 0.0,
    "budget_mib": 0.0,
}

#: v15: the fabric block's required shape (an empty block is valid —
#: a run that never armed the cluster memory fabric still writes a
#: v15 artifact)
EMPTY_FABRIC = {
    "cross_shard_lookups": 0.0,
    "cross_shard_hits": 0.0,
    "cross_shard_prefix_hit_ratio": 0.0,
    "pages_fetched": 0.0,
    "mirrored_pages": 0.0,
    "replayed_recovery_ms": 0.0,
    "replica_recovery_ms": 0.0,
    "replica_recovery_ratio": 0.0,
}

#: v16: the group-decode block's required shape (an empty block is
#: valid — a run that never built a group shard still writes a v16
#: artifact)
EMPTY_GROUP = {
    "group_size": 0.0,
    "decode_ticks": 0.0,
    "single_decode_ms_per_tok": 0.0,
    "group_decode_ms_per_tok": 0.0,
    "group_decode_latency_ratio": 0.0,
}

#: the repository root, independent of the working directory
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: default artifact directory: <repo root>/chiprun_out/artifacts
DEFAULT_DIR = os.path.join(REPO_ROOT, "chiprun_out", "artifacts")


def _power_limit_w() -> float | None:
    """The first card's power limit in watts, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10,
    ).stdout.strip().splitlines()
    return float(out[0].rsplit(",", 1)[1].split()[0]) if out else None


def provenance() -> dict[str, Any]:
    """Where/what produced this artifact. Every probe is best-effort — a
    missing toolchain degrades a field to None, never kills the run."""
    import platform
    import sys

    out: dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": platform.node(),
        "torch": None,
        "cuda": None,
        "device": None,
        "power_limit_w": None,
        "git_commit": None,
    }
    try:
        import torch

        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            out["device"] = {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            }
        else:
            out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1}
    except Exception:  # noqa: BLE001 - no torch is fine
        pass
    if out["device"] is not None and out["device"]["platform"] == "gpu":
        try:
            out["power_limit_w"] = _power_limit_w()
        except Exception:  # noqa: BLE001 - no nvidia-smi is fine
            pass
    try:
        import subprocess

        out["git_commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True,
            text=True,
            timeout=10,
            cwd=REPO_ROOT,
        ).stdout.strip() or None
    except Exception:  # noqa: BLE001
        pass
    return out


class ArtifactRecorder:
    """Accumulates one run's sections + raw timings, then writes the
    artifact. Timing helpers feed :func:`record_raw` through the
    module-level current recorder so they need no plumbing."""

    def __init__(self, name: str):
        self.name = name
        self.created_unix_s = time.time()
        self._t0 = time.perf_counter()
        self.sections: dict[str, dict[str, Any]] = {}
        self.raw: list[dict[str, Any]] = []
        self.error: str | None = None
        self.skipped: list[str] = []
        self.reliability: dict[str, float] = {
            key: 0.0 for key in RELIABILITY_COUNTERS
        }
        self.cache: dict[str, float] = {
            key: 0.0 for key in CACHE_COUNTERS
        }
        self.cache["cached_pages"] = 0.0
        self.spec: dict[str, float] = {key: 0.0 for key in SPEC_COUNTERS}
        self._spec_emitted = 0.0
        self._spec_steps = 0.0
        self.attribution: dict[str, Any] = copy.deepcopy(EMPTY_ATTRIBUTION)
        self.cluster: dict[str, Any] = {
            key: 0.0 for key in CLUSTER_COUNTERS
        }
        self.cluster["shards"] = 0.0
        self.cluster["sheds_by_shard"] = {}
        self.failover: dict[str, float] = {
            key: 0.0 for key in FAILOVER_COUNTERS
        }
        self.slo: dict[str, Any] = copy.deepcopy(EMPTY_SLO)
        self.kernel: dict[str, Any] = copy.deepcopy(EMPTY_KERNEL)
        self.ingest: dict[str, float] = dict(EMPTY_INGEST)
        self.control: dict[str, Any] = copy.deepcopy(EMPTY_CONTROL)
        self.flight_plane: dict[str, float] = dict(EMPTY_FLIGHT_PLANE)
        self.retention: dict[str, float] = dict(EMPTY_RETENTION)
        self.capacity: dict[str, float] = dict(EMPTY_CAPACITY)
        self.fabric: dict[str, float] = dict(EMPTY_FABRIC)
        self.group: dict[str, float] = dict(EMPTY_GROUP)
        from beholder_tpu_torch.ops import autotune

        #: chunk launches before this mark belong to an earlier run
        self._autotune_mark = autotune.launch_mark()

    def section(
        self,
        name: str,
        result: Any,
        metrics_before: str | None = None,
        metrics_after: str | None = None,
    ) -> Any:
        """Record one section's headline result (returned unchanged, so
        call sites stay expressions) plus optional exposition snapshots
        bracketing the measured workload. The stored copy is deep — call
        sites keep mutating the returned dict (``accel["flash"] = ...``)
        and those later additions must not leak into this section."""
        self.sections[name] = {
            "result": copy.deepcopy(result),
            "metrics_before": metrics_before,
            "metrics_after": metrics_after,
        }
        return result

    def record_raw(
        self, label: str, method: str, samples_s: list[float], **extra: Any
    ) -> None:
        self.raw.append(
            {
                "label": label,
                "method": method,
                "samples_s": [float(s) for s in samples_s],
                **extra,
            }
        )

    def skip(self, name: str, reason: str) -> None:
        self.skipped.append(name)
        self.section(name, {"skipped": reason})

    def record_reliability(self, registry) -> None:
        """Accumulate one registry's reliability counters (retries,
        sheds, dead-lettered) into the artifact. Benches build a fresh
        registry per section, so sums ACCUMULATE across calls; a
        registry without the series contributes zero."""
        find = getattr(registry, "find", None)
        if find is None:  # a Metrics wrapper
            registry = getattr(registry, "registry", None)
            find = getattr(registry, "find", None)
            if find is None:
                return
        for key, name in RELIABILITY_COUNTERS.items():
            counter = find(name)
            if counter is not None:
                self.reliability[key] += float(counter.total())

    def record_cache(self, registry) -> None:
        """Accumulate one registry's cache counters (prefix hits/misses,
        evictions, singleflight collapses; ``cached_pages`` takes the
        registry's current gauge value — a snapshot, not a sum). Same
        accumulate-across-registries contract as
        :meth:`record_reliability`."""
        find = getattr(registry, "find", None)
        if find is None:  # a Metrics wrapper
            registry = getattr(registry, "registry", None)
            find = getattr(registry, "find", None)
            if find is None:
                return
        for key, names in CACHE_COUNTERS.items():
            for name in names:
                counter = find(name)
                if counter is not None:
                    self.cache[key] += float(counter.total())
        gauge = find(CACHE_PAGES_GAUGE)
        if gauge is not None:
            self.cache["cached_pages"] = float(gauge.value())

    def record_spec(self, registry) -> None:
        """Accumulate one registry's speculative-decoding counters
        (drafted/accepted/rejected tokens, rollbacks; emitted tokens
        and verify slot-steps feed the derived ``mean_accept_len``).
        Same accumulate-across-registries contract as
        :meth:`record_reliability`."""
        find = getattr(registry, "find", None)
        if find is None:  # a Metrics wrapper
            registry = getattr(registry, "registry", None)
            find = getattr(registry, "find", None)
            if find is None:
                return
        for key, name in SPEC_COUNTERS.items():
            counter = find(name)
            if counter is not None:
                self.spec[key] += float(counter.total())
        for attr, name in (
            ("_spec_emitted", SPEC_EMITTED_COUNTER),
            ("_spec_steps", SPEC_STEPS_COUNTER),
        ):
            counter = find(name)
            if counter is not None:
                setattr(self, attr, getattr(self, attr) + float(counter.total()))

    def record_cluster(self, registry) -> None:
        """Accumulate one registry's cluster counters (KV handoffs,
        transferred pages, routing decisions; ``shards`` takes the
        registry's current gauge value — a snapshot, not a sum;
        ``sheds_by_shard`` folds the labelled intake shed counter by
        its ``queue`` label). Same accumulate-across-registries
        contract as :meth:`record_reliability`."""
        find = getattr(registry, "find", None)
        if find is None:  # a Metrics wrapper
            registry = getattr(registry, "registry", None)
            find = getattr(registry, "find", None)
            if find is None:
                return
        for key, name in CLUSTER_COUNTERS.items():
            counter = find(name)
            if counter is not None:
                self.cluster[key] += float(counter.total())
        gauge = find(CLUSTER_SHARDS_GAUGE)
        if gauge is not None:
            self.cluster["shards"] = float(gauge.value())
        sheds = find(CLUSTER_SHED_COUNTER)
        if sheds is not None and "queue" in sheds.labelnames:
            qi = sheds.labelnames.index("queue")
            by_shard = self.cluster["sheds_by_shard"]
            for key, value in sheds.items():
                queue = key[qi]
                by_shard[queue] = by_shard.get(queue, 0.0) + float(value)

    def record_failover(self, registry) -> None:
        """Accumulate one registry's failover counters (requests
        recovered onto surviving shards, pages migrated by graceful
        drains, deadline-exceeded retirements). Same
        accumulate-across-registries contract as
        :meth:`record_reliability`."""
        find = getattr(registry, "find", None)
        if find is None:  # a Metrics wrapper
            registry = getattr(registry, "registry", None)
            find = getattr(registry, "find", None)
            if find is None:
                return
        for key, name in FAILOVER_COUNTERS.items():
            counter = find(name)
            if counter is not None:
                self.failover[key] += float(counter.total())

    def record_slo(self, summary: dict[str, Any]) -> None:
        """Adopt one SLO tracker summary
        (the reference's ``SLOTracker.artifact_summary``; the port has
        no SLO tracker yet) as
        the run's v8 ``slo`` block. Last writer wins — a bench records
        its headline serving scenario's digests (quantiles don't sum
        across scenarios)."""
        for key in EMPTY_SLO:
            if key not in summary:
                raise ValueError(f"slo summary missing {key!r}")
        self.slo = copy.deepcopy({key: summary[key] for key in EMPTY_SLO})

    def record_kernel(self, summary: dict[str, Any]) -> None:
        """Adopt one fused-kernel bench summary as the run's v9
        ``kernel`` block. Last writer wins — the block carries the
        HEADLINE shape's slope-timed ratio (walls don't sum across
        shapes); per-shape detail lives in the bench section + raw
        timings."""
        for key in EMPTY_KERNEL:
            if key not in summary:
                raise ValueError(f"kernel summary missing {key!r}")
        self.kernel = copy.deepcopy(
            {key: summary[key] for key in EMPTY_KERNEL}
        )

    def record_ingest(self, summary: dict[str, Any]) -> None:
        """Adopt one batched-ingest bench summary as the run's v10
        ``ingest`` block. Last writer wins — the block carries the
        HEADLINE interleaved ratio (walls don't sum across scenarios);
        per-scenario detail lives in the bench section + raw timings."""
        for key in EMPTY_INGEST:
            if key not in summary:
                raise ValueError(f"ingest summary missing {key!r}")
        self.ingest = {key: float(summary[key]) for key in EMPTY_INGEST}

    def record_control(self, summary: dict[str, Any]) -> None:
        """Adopt one control-plane replay summary as the run's v11
        ``control`` block. Last writer wins — the block carries the
        HEADLINE tenant-skew replay's fairness ratios (quantile ratios
        don't sum across scenarios); per-scenario detail lives in the
        bench section + raw timings."""
        for key in EMPTY_CONTROL:
            if key not in summary:
                raise ValueError(f"control summary missing {key!r}")
        self.control = copy.deepcopy(
            {key: summary[key] for key in EMPTY_CONTROL}
        )

    def record_flight_plane(self, summary: dict[str, Any]) -> None:
        """Adopt one flight-plane merge summary
        (the reference's ``MergedTimeline.summary``) as the
        run's v12 ``flight_plane`` block. Last writer wins — the block
        carries the HEADLINE merged-cluster run (ring folds don't sum
        across scenarios)."""
        for key in EMPTY_FLIGHT_PLANE:
            if key not in summary:
                raise ValueError(f"flight_plane summary missing {key!r}")
        self.flight_plane = {
            key: float(summary[key]) for key in EMPTY_FLIGHT_PLANE
        }

    def record_retention(self, summary: dict[str, Any]) -> None:
        """Adopt one tail-based retention summary
        (the reference's ``TraceVault.artifact_summary``
        plus the bench's interleaved ``overhead_ratio``) as the run's
        v13 ``retention`` block. Last writer wins — the block carries
        the HEADLINE armed-vs-plain serving comparison."""
        for key in EMPTY_RETENTION:
            if key not in summary:
                raise ValueError(f"retention summary missing {key!r}")
        self.retention = {
            key: float(summary[key]) for key in EMPTY_RETENTION
        }

    def record_capacity(self, summary: dict[str, Any]) -> None:
        """Adopt one capacity-per-chip summary (bench_capacity's
        matched-HBM-budget admission counts plus the fused-wave wall
        ratio) as the run's v14 ``capacity`` block. Last writer wins —
        the block carries the HEADLINE fp8-vs-int8 admission comparison
        on pools holding the same byte budget."""
        for key in EMPTY_CAPACITY:
            if key not in summary:
                raise ValueError(f"capacity summary missing {key!r}")
        self.capacity = {
            key: float(summary[key]) for key in EMPTY_CAPACITY
        }

    def record_fabric(self, summary: dict[str, Any]) -> None:
        """Adopt one cluster-memory-fabric summary (bench_fabric's
        cross-shard hit counters plus the interleaved replay-vs-replica
        recovery walls) as the run's v15 ``fabric`` block. Last writer
        wins — the block carries the HEADLINE warm-anywhere admission
        and promotion-vs-replay comparison, both after bitwise stream
        asserts."""
        for key in EMPTY_FABRIC:
            if key not in summary:
                raise ValueError(f"fabric summary missing {key!r}")
        self.fabric = {
            key: float(summary[key]) for key in EMPTY_FABRIC
        }

    def record_group(self, summary: dict[str, Any]) -> None:
        """Adopt one group-parallel-decode summary (bench_group's
        interleaved group-vs-single per-token decode walls, measured
        after the streams are asserted bitwise-identical) as the run's
        v16 ``group`` block. Last writer wins — the block carries the
        HEADLINE collective-tax comparison for the group tick."""
        for key in EMPTY_GROUP:
            if key not in summary:
                raise ValueError(f"group summary missing {key!r}")
        self.group = {
            key: float(summary[key]) for key in EMPTY_GROUP
        }

    def record_attribution(self, summary: dict[str, Any]) -> None:
        """Adopt one flight-recorder roofline summary
        (:func:`beholder_tpu_torch.obs.attribution_summary`) as the run's v5
        ``attribution`` block. Last writer wins — a bench records the
        summary of its headline serving scenario, not a sum (phase
        percentages don't add across scenarios)."""
        for key in EMPTY_ATTRIBUTION:
            if key not in summary:
                raise ValueError(f"attribution summary missing {key!r}")
        self.attribution = copy.deepcopy(
            {key: summary[key] for key in EMPTY_ATTRIBUTION}
        )

    def to_dict(self) -> dict[str, Any]:
        outcome = "ok"
        if self.error is not None:
            outcome = "error"
        elif self.skipped:
            outcome = "partial"
        return {
            "schema": SCHEMA,
            "schema_version": SCHEMA_VERSION,
            "name": self.name,
            "created_unix_s": self.created_unix_s,
            "wall_s": round(time.perf_counter() - self._t0, 3),
            "outcome": outcome,
            "error": self.error,
            "skipped": self.skipped,
            "provenance": provenance(),
            "sections": self.sections,
            "raw_timings": self.raw,
            "reliability": dict(self.reliability),
            "cache": dict(self.cache),
            "spec": {
                **self.spec,
                "mean_accept_len": (
                    round(self._spec_emitted / self._spec_steps, 4)
                    if self._spec_steps
                    else 0.0
                ),
            },
            "attribution": copy.deepcopy(self.attribution),
            "cluster": copy.deepcopy(self.cluster),
            "failover": dict(self.failover),
            "slo": copy.deepcopy(self.slo),
            "kernel": self._kernel_block(),
            "ingest": dict(self.ingest),
            "control": copy.deepcopy(self.control),
            "flight_plane": dict(self.flight_plane),
            "retention": dict(self.retention),
            "capacity": dict(self.capacity),
            "fabric": dict(self.fabric),
            "group": dict(self.group),
        }

    def _kernel_block(self) -> dict[str, Any]:
        """The kernel block, its ``autotuned`` map joined by the config each
        chunk-kernel shape this run launched used (by full shape key)."""
        from beholder_tpu_torch.ops import autotune

        kernel = copy.deepcopy(self.kernel)
        kernel["autotuned"] = {
            **kernel["autotuned"], **autotune.used_configs(since=self._autotune_mark),
        }
        return kernel

    def write(self, path: str | None = None) -> str:
        """Write the artifact JSON; returns the path. Default location is
        ``$BENCH_ARTIFACT_DIR`` (or :data:`DEFAULT_DIR`)/``<name>.json``."""
        if path is None:
            directory = os.environ.get("BENCH_ARTIFACT_DIR") or DEFAULT_DIR
            path = os.path.join(directory, f"{self.name}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path


# -- current-recorder plumbing ----------------------------------------------

_CURRENT: ArtifactRecorder | None = None


def set_current(recorder: ArtifactRecorder | None) -> None:
    global _CURRENT
    _CURRENT = recorder


def current() -> ArtifactRecorder | None:
    return _CURRENT


def record_raw(
    label: str, method: str, samples_s: list[float], **extra: Any
) -> None:
    """Record raw samples into the active recorder; no-op without one,
    so timing helpers can call it unconditionally."""
    if _CURRENT is not None:
        _CURRENT.record_raw(label, method, samples_s, **extra)


def record_reliability(registry) -> None:
    """Accumulate a registry's reliability counters into the active
    recorder; no-op without one (same contract as :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_reliability(registry)


def record_cache(registry) -> None:
    """Accumulate a registry's cache counters into the active recorder;
    no-op without one (same contract as :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_cache(registry)


def record_spec(registry) -> None:
    """Accumulate a registry's speculative-decoding counters into the
    active recorder; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_spec(registry)


def record_ingest(summary: dict) -> None:
    """Adopt a batched-ingest bench summary into the active recorder's
    v10 ``ingest`` block; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_ingest(summary)


def record_attribution(summary: dict) -> None:
    """Adopt a flight-recorder roofline summary into the active
    recorder's v5 ``attribution`` block; no-op without one (same
    contract as :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_attribution(summary)


def record_cluster(registry) -> None:
    """Accumulate a registry's cluster counters into the active
    recorder's v6 ``cluster`` block; no-op without one (same contract
    as :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_cluster(registry)


def record_failover(registry) -> None:
    """Accumulate a registry's failover counters into the active
    recorder's v7 ``failover`` block; no-op without one (same contract
    as :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_failover(registry)


def record_slo(summary: dict) -> None:
    """Adopt an SLO tracker summary into the active recorder's v8
    ``slo`` block; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_slo(summary)


def record_kernel(summary: dict) -> None:
    """Adopt a fused-kernel bench summary into the active recorder's
    v9 ``kernel`` block; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_kernel(summary)


def record_control(summary: dict) -> None:
    """Adopt a control-plane replay summary into the active recorder's
    v11 ``control`` block; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_control(summary)


def record_flight_plane(summary: dict) -> None:
    """Adopt a flight-plane merge summary into the active recorder's
    v12 ``flight_plane`` block; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_flight_plane(summary)


def record_retention(summary: dict) -> None:
    """Adopt a tail-based retention summary into the active recorder's
    v13 ``retention`` block; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_retention(summary)


def record_capacity(summary: dict) -> None:
    """Adopt a capacity-per-chip summary into the active recorder's
    v14 ``capacity`` block; no-op without one (same contract as
    :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_capacity(summary)


def record_fabric(summary: dict) -> None:
    """Adopt a cluster-memory-fabric summary into the active
    recorder's v15 ``fabric`` block; no-op without one (same contract
    as :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_fabric(summary)


def record_group(summary: dict) -> None:
    """Adopt a group-parallel-decode summary into the active
    recorder's v16 ``group`` block; no-op without one (same contract
    as :func:`record_raw`)."""
    if _CURRENT is not None:
        _CURRENT.record_group(summary)


# -- validation ---------------------------------------------------------------


def validate(obj: Any) -> None:
    """Raise ``ValueError`` (listing every problem) unless ``obj`` is a
    well-formed artifact dict — the test suite's and CI's schema gate."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        raise ValueError(f"artifact must be a dict, got {type(obj).__name__}")
    if obj.get("schema") != SCHEMA:
        problems.append(f"schema must be {SCHEMA!r}, got {obj.get('schema')!r}")
    version = obj.get("schema_version")
    if not isinstance(version, int) or version < 1:
        problems.append(f"schema_version must be an int >= 1, got {version!r}")
    if not isinstance(obj.get("name"), str) or not obj.get("name"):
        problems.append("name must be a non-empty string")
    for key in ("created_unix_s", "wall_s"):
        if not isinstance(obj.get(key), (int, float)):
            problems.append(f"{key} must be a number, got {obj.get(key)!r}")
    if obj.get("outcome") not in ("ok", "error", "partial"):
        problems.append(f"outcome must be ok/error/partial, got {obj.get('outcome')!r}")
    if obj.get("outcome") == "error" and not obj.get("error"):
        problems.append("outcome=error requires a non-empty error message")
    prov = obj.get("provenance")
    if not isinstance(prov, dict):
        problems.append("provenance must be a dict")
    else:
        for key in ("python", "platform"):
            if not isinstance(prov.get(key), str):
                problems.append(f"provenance.{key} must be a string")
    sections = obj.get("sections")
    if not isinstance(sections, dict):
        problems.append("sections must be a dict")
    else:
        for name, section in sections.items():
            if not isinstance(section, dict) or "result" not in section:
                problems.append(f"section {name!r} must be a dict with 'result'")
    if isinstance(version, int) and version >= 2:
        # v2: reliability counters are part of the evidence
        rel = obj.get("reliability")
        if not isinstance(rel, dict):
            problems.append("reliability must be a dict (schema v2+)")
        else:
            for key in RELIABILITY_COUNTERS:
                if not isinstance(rel.get(key), (int, float)):
                    problems.append(
                        f"reliability.{key} must be a number, "
                        f"got {rel.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 3:
        # v3: cache counters are part of the evidence
        cache = obj.get("cache")
        if not isinstance(cache, dict):
            problems.append("cache must be a dict (schema v3+)")
        else:
            for key in (*CACHE_COUNTERS, "cached_pages"):
                if not isinstance(cache.get(key), (int, float)):
                    problems.append(
                        f"cache.{key} must be a number, "
                        f"got {cache.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 4:
        # v4: speculative-decoding counters are part of the evidence
        spec = obj.get("spec")
        if not isinstance(spec, dict):
            problems.append("spec must be a dict (schema v4+)")
        else:
            for key in (*SPEC_COUNTERS, "mean_accept_len"):
                if not isinstance(spec.get(key), (int, float)):
                    problems.append(
                        f"spec.{key} must be a number, "
                        f"got {spec.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 5:
        # v5: flight-recorder roofline attribution is part of the
        # evidence (the ratios the perf gate compares)
        attribution = obj.get("attribution")
        if not isinstance(attribution, dict):
            problems.append("attribution must be a dict (schema v5+)")
        else:
            for key in ("phase_ms_pcts", "kernel_ceiling_fracs"):
                section = attribution.get(key)
                if not isinstance(section, dict) or not all(
                    isinstance(v, (int, float)) for v in section.values()
                ):
                    problems.append(
                        f"attribution.{key} must be a dict of numbers, "
                        f"got {section!r}"
                    )
            if not isinstance(attribution.get("stall_pct"), (int, float)):
                problems.append(
                    "attribution.stall_pct must be a number, "
                    f"got {attribution.get('stall_pct')!r}"
                )
    if isinstance(version, int) and version >= 6:
        # v6: cluster-serving counters are part of the evidence
        cluster = obj.get("cluster")
        if not isinstance(cluster, dict):
            problems.append("cluster must be a dict (schema v6+)")
        else:
            for key in (*CLUSTER_COUNTERS, "shards"):
                if not isinstance(cluster.get(key), (int, float)):
                    problems.append(
                        f"cluster.{key} must be a number, "
                        f"got {cluster.get(key)!r}"
                    )
            sheds = cluster.get("sheds_by_shard")
            if not isinstance(sheds, dict) or not all(
                isinstance(v, (int, float)) for v in sheds.values()
            ):
                problems.append(
                    "cluster.sheds_by_shard must be a dict of numbers, "
                    f"got {sheds!r}"
                )
    if isinstance(version, int) and version >= 7:
        # v7: fault-tolerance counters are part of the evidence
        failover = obj.get("failover")
        if not isinstance(failover, dict):
            problems.append("failover must be a dict (schema v7+)")
        else:
            for key in FAILOVER_COUNTERS:
                if not isinstance(failover.get(key), (int, float)):
                    problems.append(
                        f"failover.{key} must be a number, "
                        f"got {failover.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 8:
        # v8: request-level SLO digests are part of the evidence
        slo = obj.get("slo")
        if not isinstance(slo, dict):
            problems.append("slo must be a dict (schema v8+)")
        else:
            for key in EMPTY_SLO:
                if key == "worst_request":
                    continue
                if not isinstance(slo.get(key), (int, float)):
                    problems.append(
                        f"slo.{key} must be a number, got {slo.get(key)!r}"
                    )
            if not isinstance(slo.get("worst_request"), dict):
                problems.append(
                    "slo.worst_request must be a dict, "
                    f"got {slo.get('worst_request')!r}"
                )
    if isinstance(version, int) and version >= 9:
        # v9: fused paged-kernel evidence is part of the evidence
        kernel = obj.get("kernel")
        if not isinstance(kernel, dict):
            problems.append("kernel must be a dict (schema v9+)")
        else:
            for key in EMPTY_KERNEL:
                if key == "autotuned":
                    continue
                if not isinstance(kernel.get(key), (int, float)):
                    problems.append(
                        f"kernel.{key} must be a number, "
                        f"got {kernel.get(key)!r}"
                    )
            if not isinstance(kernel.get("autotuned"), dict):
                problems.append(
                    "kernel.autotuned must be a dict, "
                    f"got {kernel.get('autotuned')!r}"
                )
    if isinstance(version, int) and version >= 10:
        # v10: batched-ingest wire evidence is part of the evidence
        ingest = obj.get("ingest")
        if not isinstance(ingest, dict):
            problems.append("ingest must be a dict (schema v10+)")
        else:
            for key in EMPTY_INGEST:
                if not isinstance(ingest.get(key), (int, float)):
                    problems.append(
                        f"ingest.{key} must be a number, "
                        f"got {ingest.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 11:
        # v11: control-plane fairness/actuation evidence
        control = obj.get("control")
        if not isinstance(control, dict):
            problems.append("control must be a dict (schema v11+)")
        else:
            for key in EMPTY_CONTROL:
                if key in ("admitted_by_tenant", "shed_by_tenant"):
                    if not isinstance(control.get(key), dict):
                        problems.append(
                            f"control.{key} must be a dict, "
                            f"got {control.get(key)!r}"
                        )
                elif not isinstance(control.get(key), (int, float)):
                    problems.append(
                        f"control.{key} must be a number, "
                        f"got {control.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 12:
        # v12: flight-plane cluster-merge evidence
        plane = obj.get("flight_plane")
        if not isinstance(plane, dict):
            problems.append("flight_plane must be a dict (schema v12+)")
        else:
            for key in EMPTY_FLIGHT_PLANE:
                if not isinstance(plane.get(key), (int, float)):
                    problems.append(
                        f"flight_plane.{key} must be a number, "
                        f"got {plane.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 13:
        # v13: tail-based retention evidence
        retention = obj.get("retention")
        if not isinstance(retention, dict):
            problems.append("retention must be a dict (schema v13+)")
        else:
            for key in EMPTY_RETENTION:
                if not isinstance(retention.get(key), (int, float)):
                    problems.append(
                        f"retention.{key} must be a number, "
                        f"got {retention.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 14:
        # v14: capacity-per-chip evidence
        capacity = obj.get("capacity")
        if not isinstance(capacity, dict):
            problems.append("capacity must be a dict (schema v14+)")
        else:
            for key in EMPTY_CAPACITY:
                if not isinstance(capacity.get(key), (int, float)):
                    problems.append(
                        f"capacity.{key} must be a number, "
                        f"got {capacity.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 15:
        # v15: cluster-memory-fabric evidence
        fabric = obj.get("fabric")
        if not isinstance(fabric, dict):
            problems.append("fabric must be a dict (schema v15+)")
        else:
            for key in EMPTY_FABRIC:
                if not isinstance(fabric.get(key), (int, float)):
                    problems.append(
                        f"fabric.{key} must be a number, "
                        f"got {fabric.get(key)!r}"
                    )
    if isinstance(version, int) and version >= 16:
        # v16: group-parallel-decode evidence
        group = obj.get("group")
        if not isinstance(group, dict):
            problems.append("group must be a dict (schema v16+)")
        else:
            for key in EMPTY_GROUP:
                if not isinstance(group.get(key), (int, float)):
                    problems.append(
                        f"group.{key} must be a number, "
                        f"got {group.get(key)!r}"
                    )
    raw = obj.get("raw_timings")
    if not isinstance(raw, list):
        problems.append("raw_timings must be a list")
    else:
        for i, rec in enumerate(raw):
            if not isinstance(rec, dict):
                problems.append(f"raw_timings[{i}] must be a dict")
                continue
            if not isinstance(rec.get("label"), str):
                problems.append(f"raw_timings[{i}].label must be a string")
            if not isinstance(rec.get("method"), str):
                problems.append(f"raw_timings[{i}].method must be a string")
            samples = rec.get("samples_s")
            if not isinstance(samples, list) or not all(
                isinstance(s, (int, float)) for s in samples
            ):
                problems.append(
                    f"raw_timings[{i}].samples_s must be a list of numbers"
                )
    if problems:
        raise ValueError("invalid bench artifact: " + "; ".join(problems))


def validate_file(path: str) -> dict:
    """Load + validate one artifact file; returns the parsed dict."""
    with open(path) as f:
        obj = json.load(f)
    validate(obj)
    return obj
