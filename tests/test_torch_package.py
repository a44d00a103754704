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
    "beholder_tpu_torch.control",
    "beholder_tpu_torch.control.admission",
    "beholder_tpu_torch.obs",
    "beholder_tpu_torch.obs.recorder",
    "beholder_tpu_torch.obs.roofline",
    "chip_smoke",
    "serve_ab",
]

_PROBE = """
import importlib, sys
for blocked in ("jax", "jaxlib", "flax", "optax"):
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
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=PORT_MODULES)],
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
