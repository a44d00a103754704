"""The port's raw-timing artifacts (``beholder_tpu_torch/artifact.py``)
against the reference's ``beholder_tpu/artifact.py``: one schema, so an
artifact either writes validates under both validators, every malformed
case fails both with the same message, and a port registry recorded by
either recorder gives the same counter blocks.

Everything here is host-side Python and exact: blocks and messages are
compared with ``==``. The tests write only under ``tmp_path`` and read no
committed artifact, ``BENCH_*.json`` or ``BENCHMARK.json``.
"""

import copy
import json

import numpy as np
import pytest
import torch

from beholder_tpu import artifact as ref_artifact
from beholder_tpu.metrics import Registry as JaxRegistry
from beholder_tpu.obs import register_build_info as ref_register_build_info
from beholder_tpu_torch import artifact
from beholder_tpu_torch.cache import PrefixCache
from beholder_tpu_torch.cluster import ClusterConfig, FailoverConfig
from beholder_tpu_torch.cluster.router import ClusterScheduler
from beholder_tpu_torch.metrics import Registry
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models.bridge import init_params, load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
from beholder_tpu_torch.obs import FlightRecorder, attribution_summary, register_build_info
from beholder_tpu_torch.reliability.chaos import WorkerFault, inject_worker_fault
from beholder_tpu_torch.spec import SpecConfig

#: the counter blocks ``record_*(registry)`` fill
REGISTRY_BLOCKS = ("reliability", "cache", "spec", "cluster", "failover")
#: each versioned block, by the schema version that introduced it
VERSIONED_BLOCKS = {
    2: "reliability", 3: "cache", 4: "spec", 5: "attribution", 6: "cluster",
    7: "failover", 8: "slo", 9: "kernel", 10: "ingest", 11: "control",
    12: "flight_plane", 13: "retention", 14: "capacity", 15: "fabric", 16: "group",
}
KW = dict(num_pages=16, page_size=8, slots=2, max_prefix=16, max_pages_per_seq=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port side runs many small ops: with torch's intra-op threads
    spinning beside the suite's other workers they ran far slower on a
    loaded host, so this module's tests take one thread, and give the count
    back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_global_recorder():
    yield
    artifact.set_current(None)
    ref_artifact.set_current(None)


def make_recorder(mod):
    """``tests/test_artifact.py``'s recorder, built with ``mod``."""
    rec = mod.ArtifactRecorder("bench_test")
    rec.section("service", {"value": 123.4, "trials": [120.0, 123.4]},
                metrics_before="# HELP x\n", metrics_after="# HELP x\nx 1\n")
    rec.record_raw("service.in_memory", "trial_wall", [0.5, 0.48], messages=60_000)
    return rec


def both_raise(obj) -> str:
    """Both validators refuse ``obj``; returns their (equal) message."""
    with pytest.raises(ValueError) as port_err:
        artifact.validate(obj)
    with pytest.raises(ValueError) as ref_err:
        ref_artifact.validate(obj)
    assert str(port_err.value) == str(ref_err.value)
    return str(port_err.value)


def test_schema_constants_match_the_reference():
    assert artifact.SCHEMA == ref_artifact.SCHEMA
    assert artifact.SCHEMA_VERSION == ref_artifact.SCHEMA_VERSION == 16
    for name in ("RELIABILITY_COUNTERS", "CACHE_COUNTERS", "CACHE_PAGES_GAUGE",
                 "SPEC_COUNTERS", "SPEC_EMITTED_COUNTER", "SPEC_STEPS_COUNTER",
                 "CLUSTER_COUNTERS", "CLUSTER_SHARDS_GAUGE", "CLUSTER_SHED_COUNTER",
                 "FAILOVER_COUNTERS", "EMPTY_ATTRIBUTION", "EMPTY_SLO", "EMPTY_KERNEL",
                 "EMPTY_INGEST", "EMPTY_CONTROL", "EMPTY_FLIGHT_PLANE", "EMPTY_RETENTION",
                 "EMPTY_CAPACITY", "EMPTY_FABRIC", "EMPTY_GROUP"):
        assert getattr(artifact, name) == getattr(ref_artifact, name), name


def test_round_trip_validates_under_both(tmp_path):
    rec = make_recorder(artifact)
    path = rec.write(str(tmp_path / "bench_test.json"))
    obj = artifact.validate_file(path)
    assert ref_artifact.validate_file(path) == obj
    assert obj["outcome"] == "ok"
    assert obj["sections"]["service"]["result"]["value"] == 123.4
    (raw,) = obj["raw_timings"]
    assert raw == {"label": "service.in_memory", "method": "trial_wall",
                   "samples_s": [0.5, 0.48], "messages": 60_000}
    # the reference's recorder writes what the port's validator accepts,
    # with the same top-level keys
    ref_obj = json.loads(json.dumps(make_recorder(ref_artifact).to_dict()))
    artifact.validate(ref_obj)
    assert sorted(ref_obj) == sorted(obj)
    for key in ("sections", "raw_timings", *VERSIONED_BLOCKS.values()):
        assert ref_obj[key] == obj[key], key


def test_provenance_probes_torch_not_jax():
    prov = artifact.provenance()
    assert isinstance(prov["python"], str) and isinstance(prov["platform"], str)
    assert prov["torch"] == torch.__version__
    assert prov["cuda"] == torch.version.cuda
    assert "jax" not in prov and "jax_platforms_env" not in prov
    if torch.cuda.is_available():
        assert prov["device"] == {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}
    else:
        assert prov["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
        assert prov["power_limit_w"] is None


def test_error_and_skip_outcomes(tmp_path):
    rec = artifact.ArtifactRecorder("bench_err")
    rec.skip("accel", "no card")
    rec.error = "RuntimeError('boom')"
    obj = ref_artifact.validate_file(rec.write(str(tmp_path / "bench_err.json")))
    assert obj["outcome"] == "error" and obj["error"] == "RuntimeError('boom')"
    assert obj["skipped"] == ["accel"]
    assert obj["sections"]["accel"]["result"] == {"skipped": "no card"}
    rec2 = artifact.ArtifactRecorder("bench_partial")
    rec2.skip("accel", "quick")
    assert rec2.to_dict()["outcome"] == "partial"


def _malformed():
    """``tests/test_artifact.py:64-110``'s malformed artifacts, then one
    missing key in each versioned block."""
    good = make_recorder(artifact).to_dict()
    cases = {
        "not-a-dict": [],
        "schema": dict(good, schema="something-else"),
        "schema-version": dict(good, schema_version="1"),
        "error-without-message": dict(good, outcome="error", error=None),
        "raw-label": dict(good, raw_timings=[{"label": 1, "method": "x", "samples_s": []}]),
        "raw-samples": dict(good, raw_timings=[{"label": "x", "method": "x",
                                                 "samples_s": [1, "a"]}]),
        "section": dict(good, sections={"s": {"no_result": 1}}),
        "reliability-retries": dict(good, reliability={"retries": "many"}),
        "no-reliability": {k: v for k, v in good.items() if k != "reliability"},
    }
    for version, block in VERSIONED_BLOCKS.items():
        bad = copy.deepcopy(good)
        del bad[block][next(iter(bad[block]))]
        cases[f"v{version}-{block}"] = bad
    return cases


MALFORMED = _malformed()


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_artifacts_fail_both_validators_alike(case):
    message = both_raise(MALFORMED[case])
    assert message


def test_v1_artifacts_stay_valid_in_both():
    v1 = dict(make_recorder(artifact).to_dict(), schema_version=1)
    for block in VERSIONED_BLOCKS.values():
        del v1[block]
    artifact.validate(v1)
    ref_artifact.validate(v1)


def _filled_registry() -> Registry:
    """One port registry, filled on the CPU by a disaggregated cluster (a
    decode worker killed mid-run, an overfull intake), a prefix-cache
    batcher served twice, and a speculative batcher."""
    model = TelemetrySequenceModel(dim=32, heads=2, layers=1, device="cpu")
    load_flax_params(model, init_params(model, seed=0))

    def req(seed, t=9, horizon=5):
        rng = np.random.default_rng(seed)
        return Request(np.cumsum(1.0 + rng.normal(0, 0.05, t + 1)), np.full(t + 1, 2), horizon)

    registry = Registry()
    cluster = ClusterScheduler(
        model, ClusterConfig(n_decode_workers=2, n_prefill_workers=1, failover=FailoverConfig(),
                             max_pending_per_shard=2),
        devices=["cpu"], metrics=registry, **KW)
    inject_worker_fault(cluster, WorkerFault("decode-1", "kill", after_dispatches=1))
    cluster.run([req(i) for i in range(6)])
    for i in range(8):
        cluster.submit(req(i))
    cluster.run_pending()
    b = ContinuousBatcher(model, **KW, metrics=registry,
                          prefix_cache=PrefixCache(8, metrics=registry),
                          spec=SpecConfig(max_draft=3), device="cpu")
    shared = [req(0, t=16)] * 2
    b.run(shared)
    b.run(shared)
    b.run_spec([req(i) for i in range(3)])
    return registry


def test_registry_blocks_equal_the_reference_recorders():
    registry = _filled_registry()
    blocks = []
    for mod in (artifact, ref_artifact):
        rec = mod.ArtifactRecorder("bench_registry")
        for _ in range(2):  # counters accumulate across calls; gauges snapshot
            rec.record_reliability(registry)
            rec.record_cache(registry)
            rec.record_spec(registry)
            rec.record_cluster(registry)
            rec.record_failover(registry)
        obj = rec.to_dict()
        artifact.validate(obj)
        ref_artifact.validate(obj)
        blocks.append({k: obj[k] for k in REGISTRY_BLOCKS})
    assert blocks[0] == blocks[1]
    got = blocks[0]
    # the run reached every family it should: sheds, prefix hits, drafts,
    # handoffs, per-shard sheds, recoveries
    assert got["reliability"]["sheds"] > 0
    assert got["cache"]["prefix_hits"] > 0 and got["cache"]["cached_pages"] > 0
    assert got["spec"]["drafted"] > 0 and got["spec"]["mean_accept_len"] >= 1.0
    assert got["cluster"]["transfers"] > 0 and got["cluster"]["shards"] == 2.0
    assert got["cluster"]["sheds_by_shard"]
    assert got["failover"]["recoveries"] > 0


def test_module_helpers_route_to_the_current_recorder():
    artifact.set_current(None)
    artifact.record_raw("x", "y", [1.0])  # no recorder: a no-op
    artifact.record_reliability(Registry())
    rec = artifact.ArtifactRecorder("bench_cur")
    artifact.set_current(rec)
    assert artifact.current() is rec
    artifact.record_raw("x", "y", [1.0], k1=2)
    artifact.record_group(dict(artifact.EMPTY_GROUP, group_size=2))
    assert rec.raw == [{"label": "x", "method": "y", "samples_s": [1.0], "k1": 2}]
    assert rec.to_dict()["group"]["group_size"] == 2.0
    with pytest.raises(ValueError, match="slo summary missing"):
        artifact.record_slo({})
    result = rec.section("accel", {"value": 1.0})
    result["flash"] = 2.0  # a later edit of the caller's dict stays out
    assert rec.sections["accel"]["result"] == {"value": 1.0}


def test_attribution_summary_records_and_validates():
    recorder = FlightRecorder()
    recorder.record("admit", 0.0, 0.004, rows=8)
    recorder.record("decode_step", 0.004, 0.010, ceiling_frac=0.25)
    recorder.record("device_wait", 0.012, 0.001)
    summary = attribution_summary(recorder.events())
    rec = artifact.ArtifactRecorder("bench_attr")
    rec.record_attribution(summary)
    obj = rec.to_dict()
    artifact.validate(obj)
    ref_artifact.validate(obj)
    assert obj["attribution"] == {k: summary[k] for k in artifact.EMPTY_ATTRIBUTION}
    assert obj["attribution"]["phase_ms_pcts"]


def test_write_honours_the_env_dir_and_the_default_is_not_artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_ARTIFACT_DIR", str(tmp_path / "arts"))
    path = artifact.ArtifactRecorder("bench_envdir").write()
    assert path == str(tmp_path / "arts" / "bench_envdir.json")
    ref_artifact.validate_file(path)
    assert artifact.DEFAULT_DIR != ref_artifact.DEFAULT_DIR
    assert artifact.DEFAULT_DIR.replace("\\", "/").endswith("/chiprun_out/artifacts")


def test_build_info_gauge_matches_the_reference_but_its_torch_label():
    port, ref = Registry(), JaxRegistry()
    register_build_info(port)
    ref_register_build_info(ref)
    gauge, ref_gauge = port.find("beholder_build_info"), ref.find("beholder_build_info")
    assert gauge.help == ref_gauge.help
    assert gauge.labelnames == ("schema_version", "package_version", "torch_version")
    assert ref_gauge.labelnames == ("schema_version", "package_version", "jax_version")
    (key, value), = gauge._values.items()
    (ref_key, ref_value), = ref_gauge._values.items()
    assert value == ref_value == 1.0
    assert key[:2] == ref_key[:2] == (str(artifact.SCHEMA_VERSION), ref_key[1])
    assert key[2] in (torch.__version__, "unknown")
