"""The port's autotune table (``beholder_tpu_torch.ops.autotune``) against
the reference's (``beholder_tpu.ops.autotune``) on the CPU.

Counterparts of the reference's autotuner tests (``tests/
test_paged_chunk_kernel.py``'s table round trip, missing and malformed
tables, the loud-once report, the clamps, the search, the validator and the
committed table; ``tests/test_group.py``'s group family keys): the same
shape gives the same key string on both sides, a table of the port
validates under both validators, and a knob the port does not know (the
TPU's block sizes) never changes a launch. Then the wiring: the chunk
wrapper resolves a config on the CPU too (the plain version ignores it),
the batcher's ``autotune_table=`` serves the same streams as no table, the
service's ``instance.serving.autotune.table`` reaches ``configure``, and
the artifact's ``kernel.autotuned`` block validates under both artifact
validators."""

import json
import logging

import numpy as np
import pytest
import torch

import beholder_tpu.artifact as ref_artifact
from beholder_tpu.ops import autotune as ref
from beholder_tpu_torch import artifact
from beholder_tpu_torch.ops import autotune
from beholder_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_table():
    """Each test starts and ends on the default resolution, no recorder."""
    autotune.configure(None)
    autotune.set_recorder(None)
    yield
    autotune.configure(None)
    autotune.set_recorder(None)


SHAPE = dict(slots=4, width=4, max_pages=8, page=8, kv_heads=2, head_dim=16)


def _entry(config, per_call_s=1e-4):
    return {"config": config, "per_call_s": per_call_s,
            "candidates": {autotune._label(config): per_call_s}, "measured_unix_s": 0.0}


# -- keys and families ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_shape_key_matches_the_reference(dtype, group):
    want = ref.shape_key("paged_chunk", dtype=dtype, group=group, **SHAPE)
    assert autotune.shape_key("paged_chunk", dtype=dtype, group=group, **SHAPE) == want


def test_autotune_group_family_keys():
    kw = dict(slots=2, width=8, max_pages=4, page=8, kv_heads=2, head_dim=16, dtype="bf16")
    k1 = autotune.shape_key("paged_chunk", group=1, **kw)
    k2 = autotune.shape_key("paged_chunk", group=2, **kw)
    assert ":g" not in k1
    assert k2.endswith("bf16:g2")
    assert k2.replace(":g2", "") == k1


@pytest.mark.parametrize("family", ["bf16", "bf16:g1", "bfloat16:g2", "int8:g4", "fp8",
                                    "bf16:g0", "martian:g2", "bf16:gx"])
def test_canon_family_matches_the_reference(family):
    try:
        want = ref._canon_family(family)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            autotune._canon_family(family)
        assert str(got.value) == str(err)
    else:
        assert autotune._canon_family(family) == want


# -- the table ---------------------------------------------------------------

def test_autotune_table_roundtrip_and_resolution(tmp_path):
    path = str(tmp_path / "table.json")
    key = autotune.shape_key("paged_chunk", dtype="bfloat16", **SHAPE)
    autotune.save_table({key: _entry({"row_tiles_per_block": 2})}, path)
    autotune.configure(path)
    first = autotune.resolve_config(key)
    assert first == {"row_tiles_per_block": 2}
    assert autotune.resolve_config(key) == first
    assert autotune.resolve_config("paged_chunk/unknown") == autotune.DEFAULTS
    assert autotune.resolve_config(key, {"row_tiles_per_block": 1}) == {"row_tiles_per_block": 1}
    # the file is the reference's v2 layout: its loader reads the same entries
    obj = json.loads(open(path).read())
    ref.validate_table(obj)
    assert ref.flat_entries(obj) == autotune.flat_entries(obj)
    assert obj["families"]["bf16"]  # the v1 spelling migrated on save


def test_v1_table_loads_like_the_reference(tmp_path):
    key = autotune.shape_key("paged_chunk", dtype="bfloat16", **SHAPE)
    path = tmp_path / "v1.json"
    path.write_text(json.dumps({"schema": autotune.SCHEMA, "schema_version": 1,
                                "entries": {key: _entry({"row_tiles_per_block": 2})}}))
    assert autotune.load_table(str(path)) == ref.load_table(str(path))
    autotune.configure(str(path))
    assert autotune.resolve_config(key) == {"row_tiles_per_block": 2}
    # legacy spellings resolve through their canonical family
    autotune.save_table(autotune.load_table(str(path)), str(tmp_path / "v2.json"))
    autotune.configure(str(tmp_path / "v2.json"))
    assert autotune.resolve_config(key) == {"row_tiles_per_block": 2}


def test_autotune_missing_or_malformed_table_is_empty(tmp_path):
    autotune.configure(str(tmp_path / "absent.json"))
    assert autotune.resolve_config("anything") == autotune.DEFAULTS
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    autotune.configure(str(bad))
    assert autotune.resolve_config("anything") == autotune.DEFAULTS


def test_autotune_malformed_table_is_loud_once(tmp_path, caplog):
    from beholder_tpu_torch.obs import FlightRecorder

    from beholder_tpu_torch.log import get_logger

    fr = FlightRecorder(ring_size=16)
    autotune.set_recorder(fr)
    log = get_logger("ops.autotune")  # configured as the warning finds it
    log.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger="ops.autotune"):
            bad = tmp_path / "corrupt.json"
            bad.write_text('{"schema": "beholder-autotune-table"')  # truncated
            autotune.configure(str(bad))
            assert autotune.resolve_config("anything") == autotune.DEFAULTS

            def instants():
                return [e for e in fr.events() if e["name"] == "autotune.table_bad"]

            assert len(instants()) == 1
            assert instants()[0]["args"]["path"] == str(bad)
            assert instants()[0]["args"]["error"]
            autotune.configure(str(bad))  # the same path read again: quiet
            assert autotune.resolve_config("anything") == autotune.DEFAULTS
            assert len(instants()) == 1
            bad2 = tmp_path / "corrupt2.json"
            bad2.write_text("[1, 2, 3]")  # JSON, but not a table: malformed, not absent
            autotune.configure(str(bad2))
            assert autotune.resolve_config("anything") == autotune.DEFAULTS
            assert len(instants()) == 2
        warnings = [r for r in caplog.records if r.name == "ops.autotune"]
        assert len(warnings) == 2 and "malformed" in warnings[0].getMessage()
    finally:
        log.propagate = False


def test_autotune_normalize_clamps_to_the_rows_and_the_kernel():
    assert autotune.normalize({"row_tiles_per_block": 2}, 1024) == 2
    assert autotune.normalize({"row_tiles_per_block": 8}, 1024) == autotune.MAX_ROW_TILES
    assert autotune.normalize({"row_tiles_per_block": 2}, 64) == 1   # one tile of rows
    assert autotune.normalize({"row_tiles_per_block": 2}, 20) == 1   # spec verify, 4 x 5
    assert autotune.normalize({"row_tiles_per_block": 2}, 65) == 2
    assert autotune.normalize({}, 1024) == autotune.DEFAULTS["row_tiles_per_block"]
    assert autotune.normalize({"row_tiles_per_block": 0}, 1024) == 1
    assert autotune.candidate_configs(20) == [{"row_tiles_per_block": 1}]
    assert autotune.candidate_configs(1024) == [{"row_tiles_per_block": r}
                                                for r in range(1, autotune.MAX_ROW_TILES + 1)]


def test_autotune_search_picks_the_fastest_candidate(monkeypatch):
    """The search times each candidate with the slope harness on the named
    device and keeps the fastest; a stub harness makes the times exact."""
    from beholder_tpu_torch.obs import roofline

    seen = []

    def slope(fn, device, k1, k2, rounds):
        seen.append((device.type, k1, k2, rounds))
        return fn(None)

    monkeypatch.setattr(roofline, "_slope_seconds", slope)

    def build_fn(config):
        return lambda prev: 2e-3 / config["row_tiles_per_block"]  # more tiles "faster"

    candidates = autotune.candidate_configs(1024)
    entry = autotune.autotune_entry("k", build_fn, candidates, k1=2, k2=4, rounds=1,
                                    device="cpu")
    assert entry["config"] == candidates[-1]
    assert entry["candidates"] == {autotune._label(c): 2e-3 / c["row_tiles_per_block"]
                                   for c in candidates}
    assert entry["per_call_s"] == min(entry["candidates"].values())
    assert seen == [("cpu", 2, 4, 1)] * len(candidates)
    # per launch: a chain link of 4 launches reads a quarter of the link
    quarter = autotune.search("k", build_fn, candidates[:1], device="cpu", calls=4)[1]
    assert quarter == {autotune._label(candidates[0]): 5e-4}
    with pytest.raises(AssertionError, match="at least one candidate"):
        autotune.search("k", build_fn, [], device="cpu")


@pytest.mark.parametrize("obj", [
    {"schema": "nope", "entries": {}},
    {"schema": ref.SCHEMA, "schema_version": 1},
    {"schema": ref.SCHEMA, "schema_version": 1, "entries": {"k": {"per_call_s": 1.0}}},
    {"schema": ref.SCHEMA, "schema_version": 1,
     "entries": {"k": {"config": {"row_tiles_per_block": 0}, "per_call_s": 1.0}}},
    {"schema": ref.SCHEMA, "schema_version": 2,
     "families": {"bf16:g0": {"b": {"config": {}, "per_call_s": 1.0}}}},
    {"schema": ref.SCHEMA, "schema_version": 2, "families": {"bf16": []}},
    {"schema": ref.SCHEMA, "schema_version": "2", "families": {}},
    [1, 2],
])
def test_validate_table_errors_match_the_reference(obj):
    with pytest.raises(ValueError) as want:
        ref.validate_table(obj)
    with pytest.raises(ValueError) as got:
        autotune.validate_table(obj)
    assert str(got.value) == str(want.value)


def test_committed_port_table_is_valid_under_both_validators():
    with open(autotune.DEFAULT_TABLE_PATH) as f:
        table = json.load(f)
    autotune.validate_table(table)
    ref.validate_table(table)
    assert table["schema_version"] >= 2
    for family in autotune.FAMILIES:
        rows = table["families"].get(family)
        assert rows, f"the committed table must carry measured {family} entries"
        for entry in rows.values():
            assert set(entry["config"]) <= set(autotune.DEFAULTS)
            assert entry["card"] and entry["candidates"]


def test_a_foreign_knob_never_changes_a_launch():
    """The reference's TPU table (``slots_per_block``/``pages_per_block``)
    loaded by the port resolves every key to the port's defaults."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "autotune_paged.json")
    autotune.configure(path)
    table = autotune.load_table()
    assert table  # the file is a valid table to both validators
    for key, entry in table.items():
        assert set(entry["config"]) - set(autotune.DEFAULTS)
        assert autotune.resolve_config(key) == autotune.DEFAULTS
    assert autotune.resolve_config("k", {"slots_per_block": 4}) == autotune.DEFAULTS


# -- the wiring ----------------------------------------------------------------

def _chunk_inputs(rng, slots=2, heads=4, kv_heads=2, width=8, dh=16, n=8, page=8, pages=2):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()

    q, kc, vc = t(slots, heads, width, dh), t(slots, kv_heads, width, dh), \
        t(slots, kv_heads, width, dh)
    kp, vp = t(n, kv_heads, dh, page), t(n, kv_heads, dh, page)
    table = torch.from_numpy(rng.permutation(n)[: slots * pages].reshape(slots, pages)
                             .astype(np.int32))
    lens = torch.tensor([3, 9], dtype=torch.int32)
    return (q, kc, vc, kp, vp, table, lens)


def test_chunk_wrapper_resolves_its_config_on_the_cpu(tmp_path):
    args = _chunk_inputs(np.random.default_rng(0))
    key = autotune.shape_key("paged_chunk", slots=2, width=8, max_pages=2, page=8,
                             kv_heads=2, head_dim=16, dtype="bf16")
    plain = pa.paged_chunk_reference(*args, ctx_len=16, live_pages=2)
    mark = autotune.launch_mark()
    out = pa.paged_chunk_attention(*args, config={"row_tiles_per_block": 2})
    assert torch.equal(out, plain)  # the plain version takes no config
    # 2 x 8 = 16 query rows a kv head: one row tile, whatever is asked
    assert autotune.used_configs(since=mark) == {key: {"row_tiles_per_block": 1}}
    autotune.save_table({f"{key}:g2": _entry({"row_tiles_per_block": 2})},
                        str(tmp_path / "t.json"))
    autotune.configure(str(tmp_path / "t.json"))
    pa.paged_chunk_attention(*args, group=2)
    assert autotune.used_configs(since=mark)[f"{key}:g2"] == {"row_tiles_per_block": 1}


def _model_and_requests():
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.serving import Request

    torch.manual_seed(0)
    model = TelemetrySequenceModel(dim=32, heads=4, kv_heads=2, layers=2, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(np.cumsum(1.0 + rng.normal(0, 0.05, t + 1)), np.full(t + 1, 2), h)
            for t, h in ((40, 6), (33, 4), (47, 5))]
    return model, reqs


def test_batcher_with_a_table_serves_the_streams_without_one(tmp_path):
    from beholder_tpu_torch.models.serving import ContinuousBatcher

    model, reqs = _model_and_requests()
    serve = dict(num_pages=32, page_size=8, slots=4, max_prefix=64, max_pages_per_seq=8,
                 fused_wave=True, device="cpu")
    autotune.configure(str(tmp_path / "absent.json"))
    mark = autotune.launch_mark()
    want = ContinuousBatcher(model, **serve).run_waves(reqs)
    keys = autotune.used_configs(since=mark)
    assert keys and all(v == autotune.DEFAULTS for v in keys.values())
    path = autotune.save_table({k: _entry({"row_tiles_per_block": 2}) for k in keys},
                               str(tmp_path / "table.json"))
    b = ContinuousBatcher(model, **serve, autotune_table=path)
    assert autotune.table_path() == path
    mark = autotune.launch_mark()
    got = b.run_waves(reqs)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    for key, used in autotune.used_configs(since=mark).items():
        assert autotune.resolve_config(key) == {"row_tiles_per_block": 2}
        assert used["row_tiles_per_block"] >= 1


def test_service_table_reaches_configure(tmp_path):
    from beholder_tpu_torch import clients, config, mq, service, storage
    from beholder_tpu_torch.models.serving import ContinuousBatcher

    path = str(tmp_path / "svc_table.json")
    data = {"keys": {"trello": {"key": "K", "token": "T"}},
            "instance": {"flow_ids": {"queued": "q"},
                         "serving": {"fused_verify": True, "autotune": {"table": path}}}}
    svc = service.BeholderService(config.ConfigNode(data), mq.InMemoryBroker(),
                                  storage.MemoryStorage(),
                                  transport=clients.RecordingTransport(), device="cpu")
    assert svc.autotune_table == path
    model, _ = _model_and_requests()
    ContinuousBatcher(model, num_pages=8, page_size=8, slots=2, max_prefix=16,
                      max_pages_per_seq=4, fused_verify=svc.fused_verify,
                      autotune_table=svc.autotune_table, device="cpu")
    assert autotune.table_path() == path


def test_kernel_autotuned_validates_under_both_artifact_validators():
    rec = artifact.ArtifactRecorder("autotune_test")
    args = _chunk_inputs(np.random.default_rng(1))
    pa.paged_chunk_attention(*args)
    doc = rec.to_dict()
    used = doc["kernel"]["autotuned"]
    key = autotune.shape_key("paged_chunk", slots=2, width=8, max_pages=2, page=8,
                             kv_heads=2, head_dim=16, dtype="bf16")
    assert used == {key: {"row_tiles_per_block": 1}}
    artifact.validate(doc)
    ref_artifact.validate(doc)
    # a later recorder holds only its own run's launches
    assert artifact.ArtifactRecorder("next").to_dict()["kernel"]["autotuned"] == {}
