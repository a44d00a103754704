"""Explain a perf regression phase by phase, per worker and kernel family.

The port's own copy of the reference's ``tools/perf_explain.py``. It diffs
two runs, either two recorder or flight-plane timelines
(``MergedTimeline.jsonl`` / ``FlightRecorder.dump`` files) or two bench
artifacts' attribution blocks, and emits a ranked machine-readable
verdict::

    {"schema": "beholder-perf-explain",
     "regressed": true,
     "totals": {"baseline": ..., "current": ..., "delta": ...},
     "ranked": [{"kind": "phase", "phase": "readback",
                 "worker": "decode-1", "baseline": ..., "current": ...,
                 "delta": ..., "share_of_regression": 0.38}, ...],
     "families": [... the same shape, kind="family" ...],
     "verdict": "readback on decode-1 +38% of the regression"}

``share_of_regression`` divides each positive phase delta by the sum of
positive deltas, so it reads the same on absolute walls (timelines,
seconds) and on an artifact's ``phase_ms_pcts`` (percentage points), and
on runs where some phases got faster while others regressed. The online
:class:`~beholder_tpu_torch.obs.sentinel.Sentinel` ranks its windows with
:func:`explain`.

CLI::

    python -m beholder_tpu_torch.tools.perf_explain baseline current -o out.json
"""

from __future__ import annotations

import json
from typing import Any

SCHEMA = "beholder-perf-explain"


def walls_from_events(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Phase and family walls of one merged (or plain) recorder event
    stream: :func:`beholder_tpu_torch.obs.timeline.phase_walls`."""
    from beholder_tpu_torch.obs.timeline import phase_walls

    return phase_walls(events)


def walls_from_artifact(artifact: dict[str, Any]) -> dict[str, Any]:
    """Phase and family walls from a bench artifact's attribution block
    (``phase_ms_pcts`` and ``kernel_ceiling_fracs``). Worker identity does
    not survive into the artifact's aggregate block, so everything keys
    under ``all``."""
    attribution = artifact.get("attribution", {}) or {}
    phases = {
        f"{phase}@all": float(pct)
        for phase, pct in (attribution.get("phase_ms_pcts") or {}).items()
    }
    # a family that achieves less of the measured ceiling got slower, so
    # its figure here is the lost fraction (1 - frac): a drop in achieved
    # fraction shows as a positive delta, as a phase that grew does
    families = {
        f"{family}@all": 1.0 - float(frac)
        for family, frac in (attribution.get("kernel_ceiling_fracs") or {}).items()
    }
    return {"phases": phases, "families": families}


def load_walls(path: str) -> dict[str, Any]:
    """Read either kind of input: a JSON object with a ``schema_version``
    (a bench artifact) goes through :func:`walls_from_artifact`; anything
    else is read as recorder or merged JSONL (header lines skipped) through
    :func:`walls_from_events`."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            try:
                obj = json.load(f)
                if isinstance(obj, dict) and "schema_version" in obj:
                    return walls_from_artifact(obj)
            except json.JSONDecodeError:
                f.seek(0)
        events = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(obj, dict) or obj.get("ph") == "M":
                continue
            if "name" in obj:
                events.append(obj)
    return walls_from_events(events)


def _rank(baseline: dict[str, float], current: dict[str, float], kind: str) -> list[dict[str, Any]]:
    deltas = {
        key: float(current.get(key, 0.0)) - float(baseline.get(key, 0.0))
        for key in sorted(baseline.keys() | current.keys())
    }
    pos_sum = sum(d for d in deltas.values() if d > 0)
    ranked = []
    for key, delta in deltas.items():
        name, _, worker = key.partition("@")
        ranked.append({
            "kind": kind,
            "key": key,
            kind: name,
            "worker": worker or "all",
            "baseline": float(baseline.get(key, 0.0)),
            "current": float(current.get(key, 0.0)),
            "delta": delta,
            "share_of_regression": delta / pos_sum if pos_sum > 0 and delta > 0 else 0.0,
        })
    ranked.sort(key=lambda r: (-r["delta"], r["key"]))
    return ranked


def explain(baseline: dict[str, Any], current: dict[str, Any]) -> dict[str, Any]:
    """Diff two phase-wall aggregates (``walls_from_*`` output) into the
    ranked verdict. Deterministic: ties break on key order."""
    ranked = _rank(baseline.get("phases", {}), current.get("phases", {}), "phase")
    families = _rank(baseline.get("families", {}), current.get("families", {}), "family")
    base_total = sum(baseline.get("phases", {}).values())
    cur_total = sum(current.get("phases", {}).values())
    regressed = any(r["delta"] > 0 for r in ranked)
    if regressed:
        top = ranked[0]
        verdict = (f"{top['phase']} on {top['worker']} "
                   f"+{top['share_of_regression'] * 100:.0f}% of the regression")
    else:
        verdict = "no phase regressed"
    return {
        "schema": SCHEMA,
        "regressed": regressed,
        "totals": {"baseline": base_total, "current": cur_total, "delta": cur_total - base_total},
        "ranked": ranked,
        "families": families,
        "verdict": verdict,
    }


def explain_artifacts(baseline: dict[str, Any], current: dict[str, Any]) -> dict[str, Any]:
    """:func:`explain` between two loaded bench artifacts."""
    return explain(walls_from_artifact(baseline), walls_from_artifact(current))


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description=(
            "Diff two runs (merged flight-plane timelines or bench "
            "artifacts) phase-by-phase and rank what moved"
        )
    )
    parser.add_argument("baseline", help="baseline timeline JSONL or artifact JSON")
    parser.add_argument("current", help="current timeline JSONL or artifact JSON")
    parser.add_argument("-o", "--out", default=None,
                        help="write the explanation JSON here (default: stdout only)")
    args = parser.parse_args(argv)
    result = explain(load_walls(args.baseline), load_walls(args.current))
    rendered = json.dumps(result, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(rendered + "\n")
    print(result["verdict"])
    if not args.out:
        print(rendered)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
