"""The native AMQP frame scanner: built from C++ at first use, then bound.

The port's own copy of the reference's ``mq/_native.py``. Two artifacts
come from the sources beside this module (``native/framecodec.cc`` and
``native/framecodec_pymod.cc``):

- ``libframecodec-<hash>.so``, a plain C scan loop loaded with ``ctypes``
  (:class:`NativeScanner`);
- ``framecodec_ext-<hash><EXT_SUFFIX>``, the CPython C-API module with
  ``scan`` (payloads copied to ``bytes``) and ``scan_views`` (zero-copy
  memoryview payloads), built against ``sysconfig``'s include directory
  for the running interpreter.

:func:`build` compiles both with the host C++ compiler (``$CXX``, else
``g++``, else ``c++``) into ``native/_build/`` (listed in ``.gitignore``),
one compiler process per source, started together. Each artifact's name
carries a hash of its source, the flags, the compiler's version line and
the interpreter's ABI tag, so a stale or foreign build is never loaded;
each is written under a temporary name and renamed, so concurrent
processes (test workers) cannot see a half-written file. A failed build
raises with the compiler's output. Nothing is built when the module is
imported.

The scanners are zero-copy on input (the buffer's address goes to C, no
per-feed ``bytes()`` copy), and the ctypes scratch arrays live for the
scanner's lifetime instead of being reallocated per call.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import platform
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = NATIVE_DIR / "_build"
CXX_FLAGS = ["-O2", "-Wall", "-Wextra", "-shared", "-fPIC"]

_MAX_FRAMES = 4096

_lib: ctypes.CDLL | None = None
_ext = None
#: compiler path -> its artifacts (computing them runs ``--version``)
_targets_cache: dict[str, dict] = {}


def find_cxx() -> str:
    """The host C++ compiler, or a clear error naming what was looked for."""
    name = os.environ.get("CXX")
    found = shutil.which(name) if name else shutil.which("g++") or shutil.which("c++")
    if found is None:
        wanted = f"$CXX ({name!r})" if name else "g++ or c++"
        raise RuntimeError(
            f"no C++ compiler found ({wanted} on PATH): the native AMQP frame "
            "scanner is built from beholder_tpu_torch/mq/native at first use"
        )
    return found


def compiler_version(cxx: str) -> str:
    """The compiler's first ``--version`` line (printed by the card's smoke
    script, and part of every artifact's hash)."""
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True, check=False)
    return (out.stdout or out.stderr).splitlines()[0] if (out.stdout or out.stderr) else cxx


def _targets(cxx: str) -> dict[str, tuple[Path, list[str], Path]]:
    """Per artifact: its source, its flags and its hashed output path."""
    if cxx in _targets_cache:
        return _targets_cache[cxx]
    ext_suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    include = sysconfig.get_paths()["include"]
    tag = "\0".join((compiler_version(cxx), ext_suffix, platform.machine()))
    out = {}
    for key, src_name, flags, stem, suffix in (
        ("lib", "framecodec.cc", CXX_FLAGS, "libframecodec", ".so"),
        ("ext", "framecodec_pymod.cc", [*CXX_FLAGS, f"-I{include}"], "framecodec_ext",
         ext_suffix),
    ):
        src = NATIVE_DIR / src_name
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode() + tag.encode()
        ).hexdigest()[:16]
        out[key] = (src, flags, BUILD_DIR / f"{stem}-{digest}{suffix}")
    _targets_cache[cxx] = out
    return out


def _bind_lib(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.amqp_scan_frames.restype = ctypes.c_int64
    lib.amqp_scan_frames.argtypes = [
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _import_ext(path: Path):
    # the module name must match the .so's PyInit_ symbol
    spec = importlib.util.spec_from_file_location("framecodec_ext", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build() -> dict[str, Path]:
    """Build (where not built yet) and load both scanners. Returns the
    artifacts' paths; raises with the compiler's output on failure."""
    global _lib, _ext
    cxx = find_cxx()
    targets = _targets(cxx)
    procs = []
    for key, (src, flags, path) in targets.items():
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [cxx, *flags, "-o", str(tmp), str(src)]
        procs.append((path, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for path, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} failed to build the native frame scanner "
                f"({' '.join(cmd)}):\n{out}"
            )
        os.replace(tmp, path)
    if _lib is None:
        _lib = _bind_lib(targets["lib"][2])
    if _ext is None:
        _ext = _import_ext(targets["ext"][2])
    return {key: target[2] for key, target in targets.items()}


def ext_scan(buf: bytearray, factory) -> tuple[list, int]:
    """One C pass: scan + payload slicing + tuple building all inside
    the extension; Python only wraps the (type, channel, payload)
    triples in ``factory`` (a NamedTuple class: _make is tuple.__new__).
    Raises ValueError on a bad frame-end octet."""
    triples, consumed = _ext.scan(buf)
    make = factory._make
    return [make(t) for t in triples], consumed


class NativeScanner:
    """Per-parser scanner holding reusable scratch arrays."""

    def __init__(self):
        if _lib is None:
            raise RuntimeError(
                "the native frame scanner is not loaded (call _native.build())"
            )
        self._types = (ctypes.c_int32 * _MAX_FRAMES)()
        self._channels = (ctypes.c_int32 * _MAX_FRAMES)()
        self._offsets = (ctypes.c_int64 * _MAX_FRAMES)()
        self._sizes = (ctypes.c_int64 * _MAX_FRAMES)()
        self._consumed = ctypes.c_int64(0)
        # pre-cast memoryviews for bulk tolist() (ctypes' native "<i" format
        # doesn't support tolist; a byte-cast round trip does)
        self._types_mv = memoryview(self._types).cast("B").cast("i")
        self._channels_mv = memoryview(self._channels).cast("B").cast("i")
        self._offsets_mv = memoryview(self._offsets).cast("B").cast("q")
        self._sizes_mv = memoryview(self._sizes).cast("B").cast("q")

    def scan_views(self, buf: bytes, factory) -> tuple[list, int]:
        """Scan ``buf``, an IMMUTABLE bytes generation owned by the batch
        feed, for complete frames in C (the ctypes twin of the C-API
        module's ``scan_views``): each payload is a zero-copy memoryview
        into ``buf``, which the view keeps alive. ``factory(type,
        channel, payload)`` builds each result. Raises ``ValueError`` on a
        bad frame-end octet with the shared message format."""
        total = len(buf)
        if total < 8:
            return [], 0
        # bytes is read-only, so from_buffer is off the table; a c_char_p
        # cast yields the base address (buf stays referenced for the
        # duration of this call, so the pointer stays valid)
        base = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
        mv = memoryview(buf)
        frames: list = []
        consumed_total = 0
        while True:
            n = _lib.amqp_scan_frames(
                ctypes.cast(ctypes.c_void_p(base + consumed_total),
                            ctypes.POINTER(ctypes.c_char)),
                total - consumed_total,
                self._types,
                self._channels,
                self._offsets,
                self._sizes,
                _MAX_FRAMES,
                ctypes.byref(self._consumed),
            )
            if n < 0:
                pos = consumed_total + self._consumed.value
                err = ValueError(f"bad frame end at buffer offset {pos}")
                err.offset = pos
                raise err
            # bulk-convert the scratch arrays via the buffer protocol:
            # per-element ctypes __getitem__ costs ~100ns each; one
            # memoryview.tolist() per array is a single C-speed pass
            types = self._types_mv[:n].tolist()
            channels = self._channels_mv[:n].tolist()
            offsets = self._offsets_mv[:n].tolist()
            sizes = self._sizes_mv[:n].tolist()
            append = frames.append
            for t, c, off, size in zip(types, channels, offsets, sizes):
                start = consumed_total + off
                append(factory(t, c, mv[start : start + size]))
            consumed_total += self._consumed.value
            if n < _MAX_FRAMES:
                return frames, consumed_total
