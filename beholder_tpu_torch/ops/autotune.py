"""Measured launch configurations for the paged chunk kernel.

The port's copy of the reference's ``ops/autotune.py``. A **search**
(:func:`search`) slope-times the kernel at every candidate config of one
shape class on the card (:func:`beholder_tpu_torch.obs.roofline.
_slope_seconds`: k chained calls, the min of each endpoint) and keeps the
fastest; the winners persist to a JSON **table** keyed by
:func:`shape_key`; every launch resolves its config through
:func:`resolve_config`: an explicit config, then the table, then
:data:`DEFAULTS` (a cold miss serves, untuned).

The knobs are the CUDA chunk kernel's own (``csrc/paged_chunk.cu``), and
only knobs that are numerics-neutral by construction: every candidate gives
the bits of the default launch. The one knob is ``row_tiles_per_block``,
how many 64-row query tiles one block holds (1 or 2): a row's key tiles,
its terms and their order do not depend on the block it sits in, and a
block of two row tiles loads each key tile once for both. The reference's
knobs (``slots_per_block``, ``pages_per_block``) are Pallas grid and DMA
sizes that the CUDA kernel has no counterpart of; a knob the port does not
know is ignored at resolution, so a TPU table never changes a launch. The
decode kernel's split changes its partial sums and stays out of the table.

The table format, :data:`SCHEMA` version 2 grouped per dtype family, the
``:g<N>`` group families and :func:`shape_key`'s strings are the
reference's, so one shape gives one key on both sides and a table of the
port validates under both validators::

    {"schema": "beholder-autotune-table", "schema_version": 2,
     "families": {"bf16": {"<base_key>": {
                      "config": {"row_tiles_per_block": 2},
                      "per_call_s": 2.1e-5,
                      "candidates": {"row_tiles_per_block=1": s, ...},
                      "measured_unix_s": ..., "card": "..."}},
                  "int8": {...}, "fp8": {...}}}

The default table is ``autotune_paged.json`` beside this file (package
data; refreshed from a card run, see the README), then
``$BEHOLDER_AUTOTUNE_TABLE``, then :func:`configure`'s path, each
overriding the one before. A malformed table is an empty one, reported
once a path and process: a warning, and an ``autotune.table_bad`` instant
on the flight recorder armed by :func:`set_recorder`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

SCHEMA = "beholder-autotune-table"
SCHEMA_VERSION = 2

#: the dtype families a pool resolves to (:func:`beholder_tpu_torch.ops.
#: paged_attention.pool_dtype_family`)
FAMILIES = ("bf16", "int8", "fp8")

#: query rows a tile of the chunk kernel, and the most tiles a block holds
ROW_TILE = 64
MAX_ROW_TILES = 2

#: the cold-miss launch: one row tile a block
DEFAULTS: dict[str, int] = {"row_tiles_per_block": 1}

#: env override for the table location
TABLE_ENV = "BEHOLDER_AUTOTUNE_TABLE"

#: the committed table, package data beside this module
DEFAULT_TABLE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "autotune_paged.json"
)

_lock = threading.Lock()
_table: dict[str, Any] | None = None
_table_path: str | None = None
_recorder: Any = None
_warned_paths: set[str] = set()
#: full key -> (the count of launches when it last launched, its config)
_used: dict[str, tuple[int, dict[str, int]]] = {}
_launches = 0
#: configs resolved through the table (no explicit config), by full key
_resolved: dict[str, dict[str, int]] = {}


def set_recorder(recorder: Any) -> None:
    """Arm (or with ``None`` disarm) the flight recorder that a malformed
    table's read reports to. Process-global, as :func:`configure`."""
    global _recorder
    with _lock:
        _recorder = recorder


def shape_key(
    family: str,
    *,
    slots: int,
    width: int,
    max_pages: int,
    page: int,
    kv_heads: int,
    head_dim: int,
    dtype: str,
    group: int = 1,
) -> str:
    """One shape class, one table row, keyed exactly (no bucketing). A
    member of a decode group of ``group`` > 1 runs over its ``kv_heads``
    slice and keys into the ``<dtype>:g<group>`` family."""
    dtype_seg = dtype if group == 1 else f"{dtype}:g{group}"
    return (
        f"{family}/s{slots}w{width}p{max_pages}x{page}"
        f"h{kv_heads}d{head_dim}/{dtype_seg}"
    )


def configure(path: str | None) -> None:
    """Point the table at ``path`` (``instance.serving.autotune.table``)
    and drop the cached table, so the next lookup reads it. ``None``
    restores the default resolution."""
    global _table, _table_path
    with _lock:
        _table_path = path
        _table = None
        _resolved.clear()


def table_path() -> str:
    return _table_path or os.environ.get(TABLE_ENV) or DEFAULT_TABLE_PATH


def load_table(path: str | None = None) -> dict[str, Any]:
    """The table's entries as the flat ``base_key/family`` view; a missing
    or malformed file is an empty table. The active table is cached after
    its first read."""
    global _table
    if path is not None:
        return _read_entries(path)
    with _lock:
        if _table is None:
            _table = _read_entries(table_path())
        return _table


def _read_entries(path: str) -> dict[str, Any]:
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return {}  # absent: a cold start
    try:
        obj = json.loads(raw)
        validate_table(obj)
        return flat_entries(obj)
    except (ValueError, KeyError, TypeError) as err:
        # unparseable counts as malformed (loud), not absent (quiet)
        _warn_malformed(path, err)
        return {}


def _warn_malformed(path: str, err: Exception) -> None:
    """One warning a path and process, and an ``autotune.table_bad``
    instant when a recorder is armed."""
    if path in _warned_paths:
        return
    _warned_paths.add(path)
    from beholder_tpu_torch.log import get_logger

    get_logger("ops.autotune").warning(
        "autotune table %s is malformed (%s); serving DEFAULTS for "
        "every shape until it is regenerated",
        path,
        err,
    )
    if _recorder is not None:
        try:
            _recorder.instant("autotune.table_bad", path=path, error=str(err))
        except Exception:
            pass  # observability never stops a launch


def flat_entries(obj: dict[str, Any]) -> dict[str, Any]:
    """A validated table's entries as the flat runtime view: v2 families
    joined back onto their base keys; v1 flat entries as they are."""
    if "families" in obj:
        return {
            f"{base}/{_canon_family(family)}": entry
            for family, rows in obj["families"].items()
            for base, entry in rows.items()
        }
    return dict(obj["entries"])


def _validate_entry(key: str, entry: Any) -> None:
    if not isinstance(entry, dict) or not isinstance(entry.get("config"), dict):
        raise ValueError(f"entry {key!r} must carry a config dict")
    for knob, value in entry["config"].items():
        if not isinstance(value, int) or value < 1:
            raise ValueError(
                f"entry {key!r} config {knob}={value!r} must be a positive int"
            )
    if not isinstance(entry.get("per_call_s"), (int, float)):
        raise ValueError(f"entry {key!r} needs a numeric per_call_s")


def validate_table(obj: Any) -> None:
    """Raise ``ValueError`` unless ``obj`` is a well-formed table: v2
    (``families`` -> family -> base-key entries) or v1 (flat ``entries``)."""
    if not isinstance(obj, dict):
        raise ValueError("autotune table must be a dict")
    if obj.get("schema") != SCHEMA:
        raise ValueError(f"schema must be {SCHEMA!r}, got {obj.get('schema')!r}")
    if not isinstance(obj.get("schema_version"), int):
        raise ValueError("schema_version must be an int")
    if "families" in obj:
        families = obj["families"]
        if not isinstance(families, dict):
            raise ValueError("families must be a dict")
        for family, rows in families.items():
            _canon_family(family)  # raises on an unknown family or a bad :gN
            if not isinstance(rows, dict):
                raise ValueError(f"family {family!r} must map to a dict")
            for base, entry in rows.items():
                _validate_entry(f"{base}/{family}", entry)
        return
    entries = obj.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("entries must be a dict")
    for key, entry in entries.items():
        _validate_entry(key, entry)


#: v1 dtype spellings -> v2 family names
_FAMILY_ALIASES = {"bfloat16": "bf16"}


def _canon_family(family: str) -> str:
    """The canonical ``<family>[:g<N>]``: v1 dtype spellings become their
    family name and ``:g1`` the plain family. Raises ``ValueError`` on
    anything else."""
    base, sep, grp = family.partition(":g")
    base = _FAMILY_ALIASES.get(base, base)
    if base not in FAMILIES:
        raise ValueError(
            f"unknown dtype family {family!r} (want one of {FAMILIES},"
            " optionally suffixed :g<N>)"
        )
    if not sep:
        return base
    if not grp.isdigit() or int(grp) < 1:
        raise ValueError(
            f"family {family!r} has a malformed group suffix (want :g<N> with N >= 1)"
        )
    return base if int(grp) == 1 else f"{base}:g{int(grp)}"


def _split_family(key: str) -> tuple[str, str]:
    """``(base, family)`` of a full shape key, the family canonical."""
    base, _, family = key.rpartition("/")
    if not base:
        raise ValueError(f"key {key!r} does not end in a dtype family {FAMILIES}")
    return base, _canon_family(family)


def save_table(entries: dict[str, Any], path: str | None = None) -> str:
    """Write ``entries`` (the flat view) as a v2 table; when ``path`` is the
    active table, this process resolves the new winners at once. Returns
    the path."""
    global _table
    path = path or table_path()
    families: dict[str, dict[str, Any]] = {}
    for key, entry in entries.items():
        base, family = _split_family(key)
        families.setdefault(family, {})[base] = entry
    obj = {"schema": SCHEMA, "schema_version": SCHEMA_VERSION, "families": families}
    validate_table(obj)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
    if os.path.abspath(path) == os.path.abspath(table_path()):
        with _lock:
            _table = dict(entries)
            _resolved.clear()
    return path


def resolve_config(key: str, explicit: dict[str, int] | None = None) -> dict[str, int]:
    """The config of one launch: an explicit config, else the table's
    entry, else :data:`DEFAULTS`, each over the defaults. Knobs the port
    does not know are dropped. Deterministic: one table, one config."""
    if explicit is not None:
        return _known({**DEFAULTS, **explicit})
    cached = _resolved.get(key)
    if cached is not None:
        return dict(cached)
    table = load_table()
    entry = table.get(key)
    if entry is None:
        # legacy spellings resolve to their canonical family; a key outside
        # any family is a plain miss
        try:
            base, family = _split_family(key)
        except ValueError:
            pass
        else:
            entry = table.get(f"{base}/{family}")
    config = dict(DEFAULTS)
    if entry is not None and isinstance(entry.get("config"), dict):
        config = _known({**DEFAULTS, **entry["config"]})
    _resolved[key] = config
    return dict(config)


def _known(config: dict[str, int]) -> dict[str, int]:
    return {knob: config[knob] for knob in DEFAULTS}


def normalize(config: dict[str, int], rows: int) -> int:
    """The row tiles a block of this launch holds: the config's, at least
    1, never more than the kernel takes (:data:`MAX_ROW_TILES`) nor more
    than the ``rows`` = G x W query rows of a (slot, kv head) fill."""
    want = int(config.get("row_tiles_per_block", DEFAULTS["row_tiles_per_block"]))
    fill = max(1, -(-rows // ROW_TILE))
    return max(1, min(want, MAX_ROW_TILES, fill))


def candidate_configs(rows: int) -> list[dict[str, int]]:
    """The search grid of one shape: every row-tile count the shape has
    rows for (:func:`normalize`'s clamp)."""
    fill = max(1, -(-rows // ROW_TILE))
    return [
        {"row_tiles_per_block": r}
        for r in range(1, MAX_ROW_TILES + 1)
        if r <= fill
    ]


def note_used(key: str, config: dict[str, int]) -> None:
    """Record the config a launch of ``key`` used (the artifact's
    ``kernel.autotuned`` block reads these)."""
    global _launches
    _launches += 1
    _used[key] = (_launches, config)


def launch_mark() -> int:
    """The count of launches noted so far: a mark for :func:`used_configs`."""
    return _launches


def used_configs(since: int = 0) -> dict[str, dict[str, int]]:
    """Every key launched after ``since`` (a :func:`launch_mark`), with the
    config of its last launch."""
    return {key: dict(config) for key, (seq, config) in _used.items() if seq > since}


def _label(config: dict[str, int]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(config.items()))


def search(
    key: str,
    build_fn: Callable[[dict[str, int]], Callable[[Any], Any]],
    candidates: list[dict[str, int]],
    *,
    device=None,
    k1: int = 4,
    k2: int = 16,
    rounds: int = 2,
    calls: int = 1,
) -> tuple[dict[str, int], dict[str, float]]:
    """Slope-time every candidate; return (winner, seconds a launch by
    candidate label). ``build_fn(config)`` returns a chainable
    ``fn(prev) -> out`` that makes ``calls`` launches (on the card, a
    CUDA graph of several launches keeps the chain on the device's clock
    rather than the host's launch rate). ``device`` is where the timing
    runs: None means the card, the CPU only when named."""
    from beholder_tpu_torch.device import resolve_device
    from beholder_tpu_torch.obs.roofline import _slope_seconds

    dev = resolve_device(device)
    timings: dict[str, float] = {}
    best: dict[str, int] | None = None
    best_s = float("inf")
    for config in candidates:
        per_call = _slope_seconds(build_fn(config), dev, k1, k2, rounds) / calls
        timings[_label(config)] = per_call
        if per_call < best_s:
            best_s = per_call
            best = config
    assert best is not None, "search needs at least one candidate"
    return best, timings


def autotune_entry(
    key: str,
    build_fn: Callable[[dict[str, int]], Callable[[Any], Any]],
    candidates: list[dict[str, int]],
    **search_kw: Any,
) -> dict[str, Any]:
    """One table entry for ``key``: :func:`search`'s winner with every
    candidate's time beside it."""
    best, timings = search(key, build_fn, candidates, **search_kw)
    return {
        "config": best,
        "per_call_s": timings[_label(best)],
        "candidates": timings,
        "measured_unix_s": time.time(),
    }
