"""Prometheus metrics in the classic text exposition, with exemplars.

The port's own copy of the reference's ``metrics.py`` (host-side Python),
trimmed to what the serving layer uses: :class:`Counter`, :class:`Gauge`
and :class:`Histogram` (cumulative ``le`` buckets, ``_sum``/``_count``,
and per-bucket exemplars linking a bucket to the trace that last landed
in it), a :class:`Registry` whose :meth:`~Registry.render` gives the same
exposition text as the reference's for the same series, and
:func:`get_or_create`. Every histogram observation may also go to the
trace-linked observation log (:func:`configure_observation_log`): one
JSON line per raw observation, stamped with the active span's trace id,
rotated by size.

Not ported: the reference's ``Metrics`` set (its two service counters and
the ``/metrics`` HTTP server) and ``set_exemplar_resolver`` (the retention
vault's join). The serving layer accepts a :class:`Registry` or any object
with a ``.registry``, as the reference's does.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Iterable

from beholder_tpu_torch.tracing import current_trace_id

#: prom-client's default latency buckets (seconds), cumulative ``le``
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Labelled:
    """Label plumbing shared by the three metric types."""

    def __init__(self, name: str, help: str, labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(labels)}"
            )
        return tuple(str(labels[name]) for name in self.labelnames)

    def _label_str(self, key: tuple[str, ...]) -> str:
        return ",".join(f'{name}="{_esc(val)}"' for name, val in zip(self.labelnames, key))

    def _render_simple(self, kind: str, items) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {kind}"]
        for key, value in items:
            if key:
                lines.append(f"{self.name}{{{self._label_str(key)}}} {_fmt(value)}")
            else:
                lines.append(f"{self.name} {_fmt(value)}")
        return "\n".join(lines)


class Counter(_Labelled):
    """A monotonically increasing counter, optionally labelled."""

    def __init__(self, name: str, help: str, labelnames: Iterable[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: dict[tuple[str, ...], float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if not labels and not self.labelnames:  # the unlabelled hot path
            with self._lock:
                self._values[()] += amount
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label combination."""
        with self._lock:
            return sum(self._values.values())

    def items(self) -> list[tuple[tuple[str, ...], float]]:
        """``(key, value)`` per label combination, keys ordered by
        ``labelnames``."""
        with self._lock:
            return sorted(self._values.items())

    def render(self) -> str:
        return self._render_simple("counter", self.items())


def _fmt(value: float) -> str:
    return str(int(value)) if value == int(value) else repr(value)


def _esc(value: str) -> str:
    """Prometheus label-value escaping: one unescaped quote would make the
    whole exposition unparseable."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Gauge(_Labelled):
    """A settable instantaneous value, optionally labelled."""

    def __init__(self, name: str, help: str, labelnames: Iterable[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: dict[tuple[str, ...], float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> str:
        with self._lock:
            items = sorted(self._values.items())
        return self._render_simple("gauge", items)


class Histogram(_Labelled):
    """Classic-exposition histogram: cumulative ``le`` buckets (``_bucket``
    lines), ``_sum`` and ``_count`` series, optionally labelled.
    Observations are seconds by convention.

    Every :meth:`observe` also feeds the observation log, and one made
    inside a trace (or given ``exemplar_trace_id=``) leaves an exemplar:
    per (label set, bucket), the latest traced observation's trace id,
    value and timestamp (:meth:`exemplars`). Exemplars never render into
    the exposition."""

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        # per label key: [per-bucket counts..., +Inf overflow count]
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        # per label key: bucket index -> latest traced observation
        self._exemplars: dict[tuple[str, ...], dict[int, dict]] = {}
        if not self.labelnames:
            self._counts[()] = [0] * (len(self.buckets) + 1)
            self._sums[()] = 0.0

    def observe(
        self, value: float, *, exemplar_trace_id: str | None = None, **labels: str
    ) -> None:
        key = self._key(labels)
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        trace_id = exemplar_trace_id or current_trace_id()
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            counts[idx] += 1
            self._sums[key] += value
            if trace_id is not None:
                self._exemplars.setdefault(key, {})[idx] = {
                    "trace_id": trace_id,
                    "value": value,
                    "ts_us": int(time.time() * 1e6),
                }
        _observation_record(self.name, value, dict(labels), trace_id)

    def exemplars(self, **labels: str) -> dict[str, dict]:
        """Latest traced observation per bucket for one label set, keyed by
        the bucket's ``le`` rendering (``"+Inf"`` for the overflow
        bucket)."""
        key = self._key(labels)
        with self._lock:
            found = dict(self._exemplars.get(key, ()))
        return {
            (_fmt(self.buckets[idx]) if idx < len(self.buckets) else "+Inf"): dict(ex)
            for idx, ex in sorted(found.items())
        }

    def count(self, **labels: str) -> int:
        key = self._key(labels)
        with self._lock:
            return sum(self._counts.get(key, ()))

    def sum(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._sums.get(key, 0.0)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(
                (key, list(counts), self._sums[key]) for key, counts in self._counts.items()
            )
        for key, counts, total_sum in items:
            prefix = self._label_str(key)
            cumulative = 0
            for bound, count in zip(self.buckets, counts):
                cumulative += count
                labels = (prefix + "," if prefix else "") + f'le="{_fmt(bound)}"'
                lines.append(f"{self.name}_bucket{{{labels}}} {cumulative}")
            cumulative += counts[-1]
            labels = (prefix + "," if prefix else "") + 'le="+Inf"'
            lines.append(f"{self.name}_bucket{{{labels}}} {cumulative}")
            suffix = f"{{{prefix}}}" if prefix else ""
            lines.append(f"{self.name}_sum{suffix} {_fmt(total_sum)}")
            lines.append(f"{self.name}_count{suffix} {cumulative}")
        return "\n".join(lines)


# -- observation log ---------------------------------------------------------
#
# The exposition aggregates; this side channel keeps the raw observations,
# one JSON line each with the active trace id, so a latency outlier can be
# looked up as a trace. Off unless configured (or $METRICS_OBS_JSONL is set).

_obs_lock = threading.Lock()
_obs_path: str | None = None
#: cached append handle and the path it is open on: an open/close pair per
#: observation would cost as much as a sub-ms serving round
_obs_file = None
_obs_file_path: str | None = None
#: size-based rotation (path -> path.1 -> ... -> path.N, oldest dropped);
#: defaults from $METRICS_OBS_ROTATE_BYTES / $METRICS_OBS_ROTATE_KEEP
DEFAULT_OBS_ROTATE_BYTES = 64 * 1024 * 1024
DEFAULT_OBS_ROTATE_KEEP = 3
_obs_max_bytes: int | None = None
_obs_keep: int | None = None
#: the resolved (max_bytes, keep), memoised until the next configure call
_obs_policy: tuple[int, int] | None = None


def configure_observation_log(
    path: str | None, max_bytes: int | None = None, keep: int | None = None
) -> None:
    """Append raw histogram observations to ``path`` as JSON lines (``None``
    reverts to $METRICS_OBS_JSONL, or off). ``max_bytes``/``keep`` override
    the rotation policy (``max_bytes=0`` disables rotation)."""
    global _obs_path, _obs_file, _obs_file_path, _obs_max_bytes, _obs_keep, _obs_policy
    with _obs_lock:
        _obs_path = path
        _obs_max_bytes = max_bytes
        _obs_keep = keep
        _obs_policy = None
        if _obs_file is not None:
            try:
                _obs_file.close()
            except OSError:
                pass
        _obs_file = None
        _obs_file_path = None


def _obs_rotation_policy() -> tuple[int, int]:
    """(max_bytes, keep) from explicit configuration, then the environment;
    a malformed environment value falls back to the default, so rotation
    stays on."""
    global _obs_policy
    if _obs_policy is not None:
        return _obs_policy

    def env_int(name: str, default: int) -> int:
        try:
            return int(os.environ.get(name, default))
        except (TypeError, ValueError):
            return default

    max_bytes = _obs_max_bytes
    if max_bytes is None:
        max_bytes = env_int("METRICS_OBS_ROTATE_BYTES", DEFAULT_OBS_ROTATE_BYTES)
    keep = _obs_keep
    if keep is None:
        keep = env_int("METRICS_OBS_ROTATE_KEEP", DEFAULT_OBS_ROTATE_KEEP)
    _obs_policy = (max_bytes, max(1, keep))
    return _obs_policy


def _rotate_observation_log_locked(path: str, keep: int) -> None:
    """Shift-rotate ``path`` (the caller holds ``_obs_lock`` with the cached
    handle closed): path.(keep) drops, path.i -> path.(i+1), path ->
    path.1."""
    oldest = f"{path}.{keep}"
    if os.path.exists(oldest):
        os.remove(oldest)
    for i in range(keep - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i + 1}")
    os.replace(path, f"{path}.1")


def flush_observation_log() -> None:
    """Flush and close the cached handle (the shutdown path); the next
    observation re-opens it."""
    global _obs_file, _obs_file_path
    with _obs_lock:
        if _obs_file is not None:
            try:
                _obs_file.flush()
                _obs_file.close()
            except OSError:
                pass
        _obs_file = None
        _obs_file_path = None


def _observation_record(
    metric: str, value: float, labels: dict, trace_id: str | None = None
) -> None:
    global _obs_file, _obs_file_path
    path = _obs_path or os.environ.get("METRICS_OBS_JSONL")
    if not path:
        return
    try:
        line = json.dumps({
            "ts_us": int(time.time() * 1e6),
            "metric": metric,
            "value": value,
            "labels": labels,
            "trace_id": trace_id if trace_id is not None else current_trace_id(),
        })
        with _obs_lock:
            if _obs_file is None or _obs_file_path != path:
                if _obs_file is not None:
                    _obs_file.close()
                _obs_file = open(path, "a")
                _obs_file_path = path
            _obs_file.write(line + "\n")
            _obs_file.flush()
            max_bytes, keep = _obs_rotation_policy()
            if max_bytes and _obs_file.tell() >= max_bytes:
                _obs_file.close()
                _obs_file = None
                _obs_file_path = None
                _rotate_observation_log_locked(path, keep)
    except Exception:  # noqa: BLE001 - a broken sink must not kill hot paths
        pass


class Registry:
    """An ordered set of uniquely named metrics."""

    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def _register(self, metric):
        with self._lock:
            if any(existing.name == metric.name for existing in self._metrics):
                raise ValueError(f"duplicate metric {metric.name!r}")
            self._metrics.append(metric)
        return metric

    def find(self, name: str):
        """The registered metric with ``name``, or None."""
        with self._lock:
            for metric in self._metrics:
                if metric.name == name:
                    return metric
        return None

    def counter(self, name: str, help: str, labelnames: Iterable[str] = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str, labelnames: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        return "\n".join(m.render() for m in metrics) + "\n"


_METRIC_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def get_or_create(registry: Registry, kind: str, name: str, help: str, **kwargs):
    """Find or register one metric: a re-created component (a fresh
    ContinuousBatcher after a pool-exhaustion error) re-attaches to its
    series instead of tripping the duplicate guard. A name registered as
    another kind raises here, not mid-run."""
    found = registry.find(name)
    if found is not None:
        want = _METRIC_KINDS[kind]
        if not isinstance(found, want):
            raise ValueError(
                f"metric {name!r} is already registered as a "
                f"{type(found).__name__}, not a {want.__name__}"
            )
        return found
    return getattr(registry, kind)(name, help, **kwargs)
