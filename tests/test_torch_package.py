"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points build its kernels only when called."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from beholder_tpu_torch import csrc

ROOT = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "beholder_tpu_torch",
    "beholder_tpu_torch.device",
    "beholder_tpu_torch.csrc",
    "beholder_tpu_torch.ops",
    "beholder_tpu_torch.ops.quant",
    "beholder_tpu_torch.ops.attention",
    "beholder_tpu_torch.ops.paged_attention",
    "beholder_tpu_torch.ops.flash_attention",
    "beholder_tpu_torch.ops.aggregate",
    "beholder_tpu_torch.ops.fused_aggregate",
    "beholder_tpu_torch.analytics",
    "beholder_tpu_torch.cache",
    "beholder_tpu_torch.cache.prefix",
    "beholder_tpu_torch.cache.core",
    "beholder_tpu_torch.models",
    "beholder_tpu_torch.models.sequence",
    "beholder_tpu_torch.models.bridge",
    "beholder_tpu_torch.models.decode",
    "beholder_tpu_torch.models.serving",
    "beholder_tpu_torch.models.train",
    "beholder_tpu_torch.models.anomaly",
    "beholder_tpu_torch.models.checkpoint",
    "beholder_tpu_torch.parallel",
    "beholder_tpu_torch.parallel.mesh",
    "beholder_tpu_torch.parallel.collectives",
    "beholder_tpu_torch.parallel.sharding",
    "beholder_tpu_torch.parallel.zero",
    "beholder_tpu_torch.parallel.pipeline",
    "beholder_tpu_torch.parallel.distributed",
    "beholder_tpu_torch.ops.moe",
    "beholder_tpu_torch.spec",
    "beholder_tpu_torch.spec.verify",
    "beholder_tpu_torch.spec.drafter",
    "beholder_tpu_torch.spec.scheduler",
    "beholder_tpu_torch.spec.instruments",
    "beholder_tpu_torch.cache.instruments",
    "beholder_tpu_torch.tracing",
    "beholder_tpu_torch.metrics",
    "beholder_tpu_torch.reliability",
    "beholder_tpu_torch.reliability.policy",
    "beholder_tpu_torch.reliability.shed",
    "beholder_tpu_torch.reliability.chaos",
    "beholder_tpu_torch.reliability.breaker",
    "beholder_tpu_torch.reliability.dlq",
    "beholder_tpu_torch.reliability.instruments",
    "beholder_tpu_torch.control",
    "beholder_tpu_torch.control.admission",
    "beholder_tpu_torch.control.instruments",
    "beholder_tpu_torch.control.policy",
    "beholder_tpu_torch.control.evaluator",
    "beholder_tpu_torch.control.replay",
    "beholder_tpu_torch.obs",
    "beholder_tpu_torch.obs.recorder",
    "beholder_tpu_torch.obs.roofline",
    "beholder_tpu_torch.obs.timeline",
    "beholder_tpu_torch.obs.slo",
    "beholder_tpu_torch.obs.flightplane",
    "beholder_tpu_torch.obs.retention",
    "beholder_tpu_torch.obs.sentinel",
    "beholder_tpu_torch.artifact",
    "beholder_tpu_torch.tools",
    "beholder_tpu_torch.tools.profile_serving",
    "beholder_tpu_torch.tools.trace_export",
    "beholder_tpu_torch.tools.perf_explain",
    "beholder_tpu_torch.cluster",
    "beholder_tpu_torch.cluster.pool",
    "beholder_tpu_torch.cluster.instruments",
    "beholder_tpu_torch.cluster.transfer",
    "beholder_tpu_torch.cluster.failover",
    "beholder_tpu_torch.cluster.router",
    "beholder_tpu_torch.cluster.fabric",
    "beholder_tpu_torch.cluster.fabric.index",
    "beholder_tpu_torch.cluster.fabric.mirror",
    "beholder_tpu_torch.cluster.fabric.engine",
    "beholder_tpu_torch.cluster.group",
    "beholder_tpu_torch.cluster.group.engine",
    "beholder_tpu_torch.log",
    "beholder_tpu_torch.config",
    "beholder_tpu_torch.proto",
    "beholder_tpu_torch.mq",
    "beholder_tpu_torch.mq.base",
    "beholder_tpu_torch.mq.memory",
    "beholder_tpu_torch.mq.codec",
    "beholder_tpu_torch.mq.amqp",
    "beholder_tpu_torch.mq.server",
    "beholder_tpu_torch.mq.ingest",
    "beholder_tpu_torch.mq._native",
    "beholder_tpu_torch.storage",
    "beholder_tpu_torch.storage.base",
    "beholder_tpu_torch.storage.sqlite",
    "beholder_tpu_torch.storage.cached",
    "beholder_tpu_torch.storage.pg_wire",
    "beholder_tpu_torch.storage.pg_server",
    "beholder_tpu_torch.storage.postgres",
    "beholder_tpu_torch.clients",
    "beholder_tpu_torch.clients.http",
    "beholder_tpu_torch.clients.trello",
    "beholder_tpu_torch.clients.telegram",
    "beholder_tpu_torch.clients.emby",
    "beholder_tpu_torch.httpd",
    "beholder_tpu_torch.health",
    "beholder_tpu_torch.service",
    "beholder_tpu_torch.tools.publish",
    "chip_smoke",
    "serve_ab",
]

_PROBE = """
import importlib, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "google.protobuf", "yaml", "requests"):
    sys.modules[blocked] = None  # any import of these now raises
for name in {modules!r}:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "beholder_tpu" or m.startswith("beholder_tpu."))
assert not leaked, leaked
from beholder_tpu_torch import csrc
assert not csrc._loaded, "a kernel was built at import"
print("ok")
"""


def test_port_imports_without_jax_or_the_jax_package():
    """Every port module imports with JAX, the JAX package,
    ``google.protobuf``, PyYAML and ``requests`` all blocked (the card's
    machine has none of the last three) and builds no kernel."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=PORT_MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


#: the pipeline's and sharded serving's public names, as the reference's
#: ``parallel/__init__.py`` and ``models/decode.py`` export them
SLICE_NAMES = {
    "beholder_tpu_torch.parallel": [
        "pipeline_forward", "pipeline_train_step", "stack_stage_params", "stage_shardings",
        "split_microbatches", "merge_microbatches", "bubble_fraction"],
    "beholder_tpu_torch.models.decode": [
        "cache_shardings", "sharded_prefill", "sharded_decode_step", "sharded_forecast_eta"],
}

_NAMES_PROBE = """
import importlib, sys
for blocked in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[blocked] = None
for module, names in {names!r}.items():
    m = importlib.import_module(module)
    missing = [n for n in names if not callable(getattr(m, n, None))]
    assert not missing, (module, missing)
leaked = sorted(m for m in sys.modules
                if m == "beholder_tpu" or m.startswith("beholder_tpu."))
assert not leaked, leaked
print("ok")
"""


def test_pipeline_and_sharded_serving_names_import_without_jax():
    """The pipeline's and sharded serving's names resolve with JAX absent,
    and importing them pulls in nothing of the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _NAMES_PROBE.format(names=SLICE_NAMES)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax_import():
    """A textual check beside the runtime one: no port source (nor
    ``chip_smoke.py`` and ``serve_ab.py``) has an import line for JAX, flax,
    optax or the JAX package."""
    banned = ("import jax", "from jax", "import flax", "from flax",
              "import optax", "from optax", "import beholder_tpu\n",
              "from beholder_tpu ", "from beholder_tpu.", "import beholder_tpu.")
    files = sorted((ROOT / "beholder_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "serve_ab.py"]
    assert len(files) >= 12
    for path in files:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(banned), f"{path}: {line}"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CUDA compiler: building a kernel raises a clear error (it is
    never skipped, and nothing falls back)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(csrc, "TOOLKIT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(csrc, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        csrc.build("paged_decode")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        csrc.build("flash_fwd", "flash_bwd")
    with pytest.raises(FileNotFoundError):
        csrc.build("no_such_kernel")


def test_kernel_build_key_covers_the_sources_a_kernel_includes(monkeypatch, tmp_path):
    """A kernel's library is keyed by its source, the shared headers and
    any source it includes: the chunk kernel's padded build (which
    includes ``paged_chunk.cu``) is rebuilt when that file changes, and a
    source that includes neither is not."""
    for name in ("paged_chunk.cu", "paged_chunk_padded.cu", "flash_mma.cuh"):
        (tmp_path / name).write_text((csrc.CSRC / name).read_text())
    (tmp_path / "other.cu").write_text("extern \"C\" int other() { return 0; }\n")
    monkeypatch.setattr(csrc, "CSRC", tmp_path)
    names = ("paged_chunk", "paged_chunk_padded", "other")
    before = {n: csrc._target(n)[1] for n in names}
    src = tmp_path / "paged_chunk.cu"
    src.write_text(src.read_text() + "// changed\n")
    after = {n: csrc._target(n)[1] for n in names}
    assert after["paged_chunk"] != before["paged_chunk"]
    assert after["paged_chunk_padded"] != before["paged_chunk_padded"]
    assert after["other"] == before["other"]


def test_flash_wrappers_never_fall_back():
    """The flash wrappers run the plain version only for CPU tensors: a
    tensor elsewhere than the CPU or the card raises, and so does asking
    for the card where there is none."""
    from beholder_tpu_torch.models import TelemetrySequenceModel, init_seq_state
    from beholder_tpu_torch.ops import flash_attention as fa

    q, k = torch.zeros(4, 8, 64, device="meta"), torch.zeros(2, 8, 64, device="meta")
    lse = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_forward(q, k, k, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_backward_dq(q, k, k, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_backward_dkv(q, k, k, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q[None], k[None], k[None], causal=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TelemetrySequenceModel(attention="flash")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_seq_state(0)


_SERVICE_PROBE = """
import sys
for blocked in ("jax", "jaxlib", "google.protobuf", "yaml", "requests"):
    sys.modules[blocked] = None
from beholder_tpu_torch import proto
from beholder_tpu_torch.config import ConfigNode
from beholder_tpu_torch.mq import InMemoryBroker
from beholder_tpu_torch.service import PROGRESS_TOPIC, BeholderService
from beholder_tpu_torch.storage import MemoryStorage
svc = BeholderService(ConfigNode({"instance": {}}), InMemoryBroker(), MemoryStorage(),
                      device="cpu")
svc.start()
svc.broker.publish(PROGRESS_TOPIC, proto.encode(proto.TelemetryProgress(mediaId="m", progress=3)))
assert svc.broker.in_flight == 0
assert svc.metrics.progress_updates_total.value(status="queued") == 1
svc.close()
leaked = sorted(m for m in sys.modules if m == "beholder_tpu" or m.startswith("beholder_tpu."))
assert not leaked, leaked
print("ok")
"""


def test_service_runs_without_protobuf_yaml_or_requests():
    """The port's service boots and consumes with ``google.protobuf``,
    PyYAML and ``requests`` blocked in ``sys.modules``."""
    out = subprocess.run(
        [sys.executable, "-c", _SERVICE_PROBE],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
