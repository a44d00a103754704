"""The port's ratio-only perf gate (``beholder_tpu_torch.tools.perf_gate``)
against the reference's on the CPU.

Artifact pairs are built with the port's ``ArtifactRecorder``; both gates
judge the same pair and must give the same verdict, check for check. One
case per gated metric planted worse (it alone fails) and planted better
(it passes), then the counterparts of the reference's gate tests (``tests/
test_flight_recorder.py``): identical artifacts pass, degraded ratios fail,
a small phase growing fails, absolutes are never gated, improvements pass,
the CLI on written artifacts, a pre-v5 artifact refused. A failed verdict's
``explanation`` comes from the port's ``perf_explain``."""

import copy
import json

import pytest
import torch

import beholder_tpu.tools.perf_gate as ref_gate
from beholder_tpu_torch import artifact
from beholder_tpu_torch.tools import perf_explain, perf_gate

torch.set_num_threads(1)

#: every gated ratio: (the leaf that moves it, its value in the baseline)
METRIC_LEAVES = {
    "mfu_vs_measured_matmul": (("sections", "accel", "result", "flash",
                                "mfu_vs_measured_matmul"), 0.4),
    "native_speedup": (("sections", "wire_native", "result", "rate"), 1100.0),
    "warm_cold_prefill_ratio": (("sections", "prefix_cache", "result", "value"), 0.2),
    "mean_accept_len": (("spec", "mean_accept_len"), 1.5),
    "cluster_decode_latency_ratio": (("sections", "cluster", "result", "value"), 1.1),
    "failover_recovery_overhead_ratio": (("sections", "failover", "result", "value"), 1.5),
    "ttft_tail_ratio": (("slo", "ttft_p95_ms"), 20.0),
    "slo_attainment": (("slo", "attainment"), 0.9),
    "fused_verify_ratio": (("kernel", "fused_verify_ratio"), 0.8),
    "wire_ingest_ratio": (("ingest", "wire_ingest_ratio"), 3.0),
    "control_victim_ttft_ratio": (("control", "victim_ttft_ratio"), 0.1),
    "control_tail_fairness_ratio": (("control", "tail_fairness_ratio"), 0.2),
    "retention_overhead_ratio": (("retention", "overhead_ratio"), 1.02),
    "capacity_admitted_ratio": (("capacity", "capacity_admitted_ratio"), 1.3),
    "fused_wave_ratio": (("capacity", "fused_wave_ratio"), 0.8),
    "fabric_cross_shard_hit_ratio": (("fabric", "cross_shard_prefix_hit_ratio"), 0.9),
    "replica_recovery_ratio": (("fabric", "replica_recovery_ratio"), 2.0),
    "group_decode_latency_ratio": (("group", "group_decode_latency_ratio"), 1.2),
}
DIRECTIONS = {metric: direction for metric, _, direction in perf_gate.RATIO_CHECKS}


def _doc(mean_accept_len=1.5, warm_cold=0.2, native=1100.0, python=1000.0, phases=None,
         stall=10.0, msgs=100_000.0, fracs=None):
    """A port artifact with every gated ratio present."""
    rec = artifact.ArtifactRecorder("bench_e2e")
    rec.section("service", {"value": msgs})
    rec.section("wire_native", {"rate": native})
    rec.section("wire_python", {"rate": python})
    rec.section("prefix_cache", {"value": warm_cold})
    rec.section("accel", {"flash": {"mfu_vs_measured_matmul": 0.4, "value": 120.0}})
    rec.section("cluster", {"value": 1.1})
    rec.section("failover", {"value": 1.5, "recovery_latency_ms": 30.0})
    rec.record_attribution({
        "phase_ms_pcts": phases if phases is not None
        else {"admit": 50.0, "verify": 40.0, "claim": 1.0},
        "kernel_ceiling_fracs": fracs if fracs is not None else {"flash": 0.4},
        "stall_pct": stall,
    })
    rec.record_slo({"ttft_p50_ms": 10.0, "ttft_p95_ms": 20.0, "tpot_p50_ms": 1.0,
                    "attainment": 0.9, "worst_request": {}})
    rec.record_kernel({"fused_verify_ratio": 0.8, "fused_verify_wall_s": 0.002,
                       "dense_verify_wall_s": 0.0025, "autotuned": {}})
    rec.record_ingest({**artifact.EMPTY_INGEST, "wire_ingest_ratio": 3.0})
    rec.record_control({**artifact.EMPTY_CONTROL, "victim_ttft_ratio": 0.1,
                        "tail_fairness_ratio": 0.2})
    rec.record_retention({**artifact.EMPTY_RETENTION, "overhead_ratio": 1.02})
    rec.record_capacity({**artifact.EMPTY_CAPACITY, "capacity_admitted_ratio": 1.3,
                         "fused_wave_ratio": 0.8})
    rec.record_fabric({**artifact.EMPTY_FABRIC, "cross_shard_prefix_hit_ratio": 0.9,
                       "replica_recovery_ratio": 2.0})
    rec.record_group({**artifact.EMPTY_GROUP, "group_decode_latency_ratio": 1.2})
    doc = rec.to_dict()
    doc["spec"]["mean_accept_len"] = mean_accept_len
    return doc


def _planted(metric: str, worse: bool) -> dict:
    """The baseline with one ratio moved past its band (worse) or well
    inside the good side (better)."""
    doc = _doc()
    path, value = METRIC_LEAVES[metric]
    band = perf_gate.NOISE_BANDS[metric]
    up = DIRECTIONS[metric] == "higher"
    if worse:
        factor = (1 + band) * 1.25 if up else (1 - band) * 0.8
    else:
        factor = 0.5 if up else 1.05
    node = doc
    for part in path[:-1]:
        node = node[part]
    assert node[path[-1]] == value
    node[path[-1]] = value * factor
    return doc


def _both(baseline, current):
    """Both gates' verdicts on one pair, held equal check for check."""
    got = perf_gate.run_gate(baseline, current)
    want = ref_gate.run_gate(baseline, current)
    assert {k: v for k, v in got.items() if k != "explanation"} == \
        {k: v for k, v in want.items() if k != "explanation"}
    assert ("explanation" in got) == ("explanation" in want)
    return got


def test_every_gated_ratio_is_planted():
    assert set(METRIC_LEAVES) == set(perf_gate.NOISE_BANDS) - {"kernel_ceiling_frac"}
    assert set(METRIC_LEAVES) == set(DIRECTIONS)
    assert perf_gate.NOISE_BANDS == ref_gate.NOISE_BANDS
    assert [(m, d) for m, _, d in perf_gate.RATIO_CHECKS] == \
        [(m, d) for m, _, d in ref_gate.RATIO_CHECKS]
    base = _doc()
    verdict = _both(base, base)
    assert verdict["verdict"] == "pass" and not verdict["skipped"]


@pytest.mark.parametrize("worse", [True, False], ids=["worse", "better"])
@pytest.mark.parametrize("metric", list(METRIC_LEAVES))
def test_planted_ratio_verdict_matches_the_reference(metric, worse):
    verdict = _both(_doc(), _planted(metric, worse))
    if worse:
        assert verdict["verdict"] == "fail" and verdict["failed"] == [metric]
        assert verdict["explanation"]["schema"] == perf_explain.SCHEMA
    else:
        assert verdict["verdict"] == "pass" and not verdict["failed"]


def test_failed_verdict_explains_with_the_port_perf_explain(monkeypatch):
    calls = []
    real = perf_explain.explain_artifacts

    def spy(baseline, current):
        calls.append(1)
        return real(baseline, current)

    monkeypatch.setattr(perf_explain, "explain_artifacts", spy)
    base = _doc(phases={"admit": 50.0, "verify": 40.0, "claim": 1.0})
    cur = _doc(phases={"admit": 85.0, "verify": 5.0, "claim": 1.0})
    verdict = perf_gate.run_gate(base, cur)
    assert calls == [1]
    assert verdict["explanation"] == real(base, cur)
    assert verdict["explanation"] == ref_gate.run_gate(base, cur)["explanation"]


def test_perf_gate_passes_on_identical_artifacts():
    doc = _doc()
    del doc["sections"]["accel"]
    verdict = _both(doc, doc)
    assert verdict["verdict"] == "pass"
    gated = {c["metric"] for c in verdict["checks"]}
    assert {"native_speedup", "warm_cold_prefill_ratio", "mean_accept_len",
            "phase_pct:admit", "phase_pct:verify", "stall_pct"} <= gated
    assert "phase_pct:claim" not in gated  # under the floor
    assert {"metric": "mfu_vs_measured_matmul", "reason": "missing in baseline"} in \
        verdict["skipped"]


def test_a_metric_missing_on_one_side_is_skipped_not_failed():
    base, cur = _doc(), _doc()
    del cur["retention"]["overhead_ratio"]
    verdict = _both(base, cur)
    assert verdict["verdict"] == "pass"
    assert {"metric": "retention_overhead_ratio", "reason": "missing in current"} in \
        verdict["skipped"]


@pytest.mark.parametrize("degraded,metric", [
    (dict(mean_accept_len=1.0), "mean_accept_len"),
    (dict(warm_cold=0.8), "warm_cold_prefill_ratio"),
    (dict(native=600.0), "native_speedup"),
    (dict(phases={"admit": 85.0, "verify": 5.0, "claim": 1.0}), "phase_pct:admit"),
    (dict(stall=60.0), "stall_pct"),
    (dict(fracs={"flash": 0.15}), "kernel_ceiling_frac:flash"),
])
def test_perf_gate_fails_on_degraded_ratios(degraded, metric):
    verdict = _both(_doc(), _doc(**degraded))
    assert verdict["verdict"] == "fail"
    assert metric in verdict["failed"]


def test_perf_gate_catches_small_or_new_phase_eating_the_round():
    base = _doc(phases={"admit": 55.0, "verify": 43.0, "draft": 2.0})
    grown = _doc(phases={"admit": 40.0, "verify": 28.0, "draft": 32.0})
    assert "phase_pct:draft" in _both(base, grown)["failed"]
    new_phase = _doc(phases={"admit": 45.0, "verify": 30.0, "gc": 25.0})
    assert "phase_pct:gc" in _both(base, new_phase)["failed"]


def test_perf_gate_never_gates_absolutes():
    base = _doc(msgs=100_000.0, native=1100.0, python=1000.0)
    cur = _doc(msgs=10_000.0, native=110.0, python=100.0)
    verdict = _both(base, cur)
    assert verdict["verdict"] == "pass"
    assert verdict["reported_not_gated"]["telemetry_msgs_per_sec"] == \
        {"baseline": 100_000.0, "current": 10_000.0}


def test_perf_gate_improvements_pass():
    assert _both(_doc(), _doc(mean_accept_len=3.0, warm_cold=0.05))["verdict"] == "pass"


def test_perf_gate_cli_on_written_artifacts(tmp_path, capsys):
    base = artifact.ArtifactRecorder("bench_e2e")
    base.record_control({**artifact.EMPTY_CONTROL, "victim_ttft_ratio": 0.1,
                         "tail_fairness_ratio": 0.2})
    path = base.write(str(tmp_path / "base.json"))
    assert perf_gate.main(["--baseline", path, "--current", path]) == 0
    capsys.readouterr()
    degraded = json.load(open(path))
    degraded["control"]["victim_ttft_ratio"] = 0.4
    bad = tmp_path / "degraded.json"
    bad.write_text(json.dumps(degraded))
    out, explain = tmp_path / "verdict.json", tmp_path / "explain.json"
    rc = perf_gate.main(["--baseline", path, "--current", str(bad), "--out", str(out),
                         "--explain-out", str(explain)])
    assert rc == 1
    verdict = json.loads(out.read_text())
    assert verdict["schema"] == "beholder-perf-gate" and verdict["verdict"] == "fail"
    assert verdict["failed"] == ["control_victim_ttft_ratio"]
    assert json.loads(explain.read_text())["schema"] == perf_explain.SCHEMA
    assert json.loads(capsys.readouterr().out) == verdict


def test_perf_gate_cli_rejects_pre_v5_current(tmp_path):
    old = artifact.ArtifactRecorder("bench_e2e").to_dict()
    old["schema_version"] = 4
    del old["attribution"]
    path = tmp_path / "old.json"
    path.write_text(json.dumps(old))
    with pytest.raises(SystemExit, match="v5 attribution"):
        perf_gate.main(["--baseline", str(path), "--current", str(path)])


def test_perf_gate_cli_defaults_under_the_port_artifact_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_ARTIFACT_DIR", str(tmp_path))
    want = str(tmp_path / "bench_e2e.json")
    with pytest.raises(SystemExit, match=f"no artifact at {want}"):
        perf_gate.main([])
    artifact.ArtifactRecorder("bench_e2e").write(want)
    assert perf_gate.main([]) == 0
    monkeypatch.delenv("BENCH_ARTIFACT_DIR")
    assert perf_gate._default_path() == f"{artifact.DEFAULT_DIR}/bench_e2e.json"


def test_planted_copy_is_a_valid_artifact():
    for metric in METRIC_LEAVES:
        artifact.validate(copy.deepcopy(_planted(metric, True)))
