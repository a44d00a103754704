"""The port's serving profiler (``beholder_tpu_torch/tools/profile_serving.py``)
against the reference's ``beholder_tpu/tools/profile_serving.py``.

The reference profiles the headline model at full width and has no size
knobs, so it is not run here: its slope timer is run on the same fake
timings as the port's (slopes and raw entries exactly equal), and its
result keys, raw labels and probe names are read off its source. The port
runs at a small size on the CPU (``device="cpu"``); its numbers are CPU
host times and are checked only for shape: finite, positive, and
``us_per_tick`` its formula.
"""

import inspect
import math
import re

import pytest
import torch

from beholder_tpu import artifact as ref_artifact
from beholder_tpu.tools import profile_serving as ref_ps
from beholder_tpu_torch import artifact
from beholder_tpu_torch.tools import profile_serving as ps

#: a small profile: dim 32, 2 layers, 2 slots of 16-step prefixes, horizon 4
SMALL = dict(dim=32, heads=4, kv_heads=2, layers=2, slots=2, t=16, horizon=4, num_pages=8,
             page_size=8, max_pages_per_seq=4)
#: k = 2 against k = 6: four calls apart, so host noise on a loaded worker
#: cannot turn a slope negative
N2 = 6

REF_KEYS = re.findall(r'out\["(\w+)"\] =', inspect.getsource(ref_ps.profile_serving))
REF_LABELS = re.findall(r'label="(profile\.\w+)"', inspect.getsource(ref_ps.profile_serving))
REF_PROBES = re.findall(r'"(\w+_ms)":', inspect.getsource(ref_ps.probe_latencies))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: one torch thread keeps them from spinning beside the
    suite's other workers; the count is given back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_global_recorder():
    yield
    artifact.set_current(None)
    ref_artifact.set_current(None)


def fake_fn():
    """``fn(k)`` with deterministic 'times': a per-call cost, a constant and
    a jitter by call index, so the minima matter."""
    calls = []

    def fn(k):
        calls.append(k)
        return 0.003 * k + 0.05 + 0.001 * (len(calls) % 3)

    return fn, calls


@pytest.mark.parametrize("n1,n2", [(2, 10), (2, 6), (3, 5)])
def test_slope_matches_the_reference(n1, n2):
    rec, ref_rec = artifact.ArtifactRecorder("p"), ref_artifact.ArtifactRecorder("p")
    artifact.set_current(rec)
    ref_artifact.set_current(ref_rec)
    fn, calls = fake_fn()
    ref_fn, ref_calls = fake_fn()
    got = ps._slope(fn, n1, n2, label="profile.fake")
    want = ref_ps._slope(ref_fn, n1, n2, label="profile.fake")
    assert got == want
    assert math.isclose(got, 0.003, rel_tol=0.2)
    assert calls == ref_calls == [2, n1, n1, n2, n2]
    assert rec.raw == ref_rec.raw
    (raw,) = rec.raw
    assert raw["method"] == "slope_timeit" and (raw["k1"], raw["k2"]) == (n1, n2)
    assert len(raw["samples_s"]) == 4
    # without a label nothing is recorded
    ps._slope(fake_fn()[0], n1, n2)
    assert len(rec.raw) == 1


def test_profile_keys_and_labels_are_the_reference_ones():
    assert len(REF_KEYS) == 5 and len(REF_LABELS) == 4
    assert ps.DEFAULTS == dict(dim=512, heads=8, kv_heads=2, layers=4, t=256, horizon=128,
                               slots=8, num_pages=32, page_size=128, max_pages_per_seq=4)


def test_probe_latencies_on_the_cpu():
    probes = ps.probe_latencies(device="cpu")
    # the reference's jit_dispatch_ms becomes launch_ms (no jit in the port)
    want = [("launch_ms" if k == "jit_dispatch_ms" else k) for k in REF_PROBES]
    assert sorted(probes) == sorted(want)
    assert all(math.isfinite(v) and v > 0 for v in probes.values())


def test_profile_serving_small_on_the_cpu():
    rec = artifact.ArtifactRecorder("profile_serving")
    artifact.set_current(rec)
    out = ps.profile_serving(device="cpu", n2=N2, **SMALL)
    assert list(out) == REF_KEYS
    assert all(math.isfinite(v) and v > 0 for v in out.values()), out
    assert out["us_per_tick"] == out["wave_scan_program_ms"] / (SMALL["horizon"] - 1) * 1e3
    assert [r["label"] for r in rec.raw] == REF_LABELS
    assert all(len(r["samples_s"]) == 4 and r["k2"] == N2 for r in rec.raw)
    with pytest.raises(TypeError, match="unknown sizes"):
        ps.profile_serving(device="cpu", width=3)


def test_main_writes_a_valid_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_ARTIFACT_DIR", str(tmp_path))
    path = ps.main(device="cpu", n2=N2, **SMALL)
    assert path == str(tmp_path / "profile_serving.json")
    obj = artifact.validate_file(path)
    assert ref_artifact.validate_file(path) == obj
    assert obj["outcome"] == "ok" and obj["name"] == "profile_serving"
    assert sorted(obj["sections"]) == ["latency_probes", "serving_profile"]
    assert sorted(obj["sections"]["serving_profile"]["result"]) == sorted(REF_KEYS)
    assert [r["label"] for r in obj["raw_timings"]] == REF_LABELS
    assert artifact.current() is None


def test_main_writes_the_artifact_even_on_error(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_ARTIFACT_DIR", str(tmp_path))

    def explode(**kw):
        raise RuntimeError("profile exploded")

    monkeypatch.setattr(ps, "profile_serving", explode)
    with pytest.raises(RuntimeError, match="profile exploded"):
        ps.main(device="cpu")
    obj = ref_artifact.validate_file(str(tmp_path / "profile_serving.json"))
    artifact.validate(obj)
    assert obj["outcome"] == "error" and "profile exploded" in obj["error"]
    assert list(obj["sections"]) == ["latency_probes"]
    assert artifact.current() is None


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.profile_serving()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.probe_latencies()
