"""Build helper for the port's CUDA kernels.

Each ``<name>.cu`` beside this file (with the ``*.cuh`` headers and any
source it includes) is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``. The build happens at first
use, into ``_build/`` beside this file (listed in ``.gitignore``), keyed by
a hash of the sources and the flags, so a checkout
that holds only the sources builds what it needs. Nothing here runs when the
package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: where the CUDA toolkit puts nvcc when it is not on PATH
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_loaded: dict[str, ctypes.CDLL] = {}
#: per kernel source: seconds its build took and what ptxas reported
#: (empty when the library was already built)
build_log: dict[str, dict] = {}


def find_nvcc() -> str:
    """The CUDA compiler, or a clear error: a kernel is never skipped."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and TOOLKIT_NVCC.exists():
        nvcc = str(TOOLKIT_NVCC)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "beholder_tpu_torch/csrc at first use and need the CUDA toolkit "
            "(put nvcc on PATH or install it under /usr/local/cuda)"
        )
    return nvcc


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    # the shared headers and the sources it includes count too: a kernel
    # is rebuilt when one of them changes
    deps = {*CSRC.glob("*.cuh"),
            *(CSRC / n for n in re.findall(r'#include "([^"]+\.cu)"', src.read_text()))}
    headers = b"".join(h.read_bytes() for h in sorted(deps))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, ctypes.CDLL]:
    """Build (where not built yet) and load the named kernels: one
    ``nvcc`` per source, all started together. Raises with the compiler's
    output when a build fails."""
    todo = [n for n in names if n not in _loaded]
    procs = []
    for name in todo:
        src, lib = _target(name)
        if lib.exists():
            build_log[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, lib, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    for name, lib, tmp, t0, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
        build_log[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": "\n".join(
                ln for ln in out.splitlines() if "ptxas" in ln
            ),
        }
    for name in todo:
        _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
    return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel, built at first use."""
    return build(name)[name]
