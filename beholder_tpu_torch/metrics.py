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

The service's :class:`Metrics` set holds the reference's two counters,
``beholder_progress_updates_total{status}`` and ``beholder_trello_comments``,
with help text byte-identical to the reference's (its "crreated" typo
included) and no ``_total`` appended, and serves the exposition over HTTP
(:meth:`Metrics.expose`) with extra routes beside it
(:meth:`Metrics.add_route`). The serving layer accepts a :class:`Registry`
or any object with a ``.registry``, as the reference's does.

:func:`set_exemplar_resolver` installs the retention vault's join: with it
set, an exemplar whose trace the vault keeps gains a ``trace_ref`` field.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Iterable

from beholder_tpu_torch.httpd import CachedRoute, serve_routes
from beholder_tpu_torch.tracing import current_trace_id

DEFAULT_PORT = 8000
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

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

    def labels(self, **labels: str) -> "_BoundCounter":
        """A bound child for one label combination (prom-client pattern);
        hot paths cache these to skip per-call label validation."""
        key = self._key(labels)
        with self._lock:
            self._values.setdefault(key, 0.0)
        return _BoundCounter(self, key)

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


class _BoundCounter:
    __slots__ = ("_counter", "_key")

    def __init__(self, counter: Counter, key: tuple[str, ...]):
        self._counter = counter
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        with self._counter._lock:
            self._counter._values[self._key] += amount


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
        bucket). With the retention vault's resolver installed
        (:func:`set_exemplar_resolver`) and the exemplar's trace kept, a
        ``trace_ref`` field carries the vault id; otherwise the shape is
        unchanged."""
        key = self._key(labels)
        with self._lock:
            found = dict(self._exemplars.get(key, ()))
        resolver = _exemplar_resolver
        out: dict[str, dict] = {}
        for idx, ex in sorted(found.items()):
            entry = dict(ex)
            if resolver is not None:
                try:
                    ref = resolver(entry.get("trace_id"))
                except Exception:  # noqa: BLE001 - a join must not break reads
                    ref = None
                if ref is not None:
                    entry["trace_ref"] = ref
            out[_fmt(self.buckets[idx]) if idx < len(self.buckets) else "+Inf"] = entry
        return out

    def time(self, **labels: str) -> "_HistogramTimer":
        """Context manager observing the block's wall time in seconds."""
        return _HistogramTimer(self, labels)

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


class _HistogramTimer:
    __slots__ = ("_histogram", "_labels", "_t0")

    def __init__(self, histogram: Histogram, labels: dict):
        self._histogram = histogram
        self._labels = labels

    def __enter__(self) -> "_HistogramTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc_info) -> None:
        self._histogram.observe(time.perf_counter() - self._t0, **self._labels)


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


#: exemplar -> kept-trace join: a callable mapping a trace id to the
#: retention vault's id for it, or None. Module-global, as the observation
#: log is: histograms are built all over the tree, before (and whether or
#: not) a vault exists. Unset (the default) leaves exemplars' shape alone.
_exemplar_resolver = None


def set_exemplar_resolver(resolver) -> None:
    """Install (or, with None, remove) the exemplar ``trace_ref`` resolver,
    ``resolver(trace_id) -> vault_id | None``. The service installs it when
    retention is armed and removes it at ``close()``; it is read when
    :meth:`Histogram.exemplars` renders, so an exemplar recorded before its
    trace retired still links once the vault keeps it."""
    global _exemplar_resolver
    _exemplar_resolver = resolver


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


class Metrics:
    """The beholder metric set (``Prom.new('beholder')`` in the reference)."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.progress_updates_total = self.registry.counter(
            "beholder_progress_updates_total",
            "Total number of messages processed in this processes lifetime",
            labelnames=["status"],
        )
        self.trello_comments_total = self.registry.counter(
            "beholder_trello_comments",
            "Total trello comments crreated in this processes lifetime",
        )
        self._server: ThreadingHTTPServer | None = None
        #: extra endpoints riding the metrics server (``/slo``,
        #: ``/control``, ``/debug/flight``): registered before OR after
        #: expose() — the handler resolves routes per request off the
        #: live dict
        self._routes: dict | None = None
        self._extra_routes: dict = {}

    def add_route(self, path: str, route) -> None:
        """Serve ``route`` (an httpd Route callable) at ``path`` on the
        metrics server. Safe before or after :meth:`expose` — the request
        handler looks paths up per request, so a route added to a live
        server takes effect immediately."""
        self._extra_routes[path] = route
        if self._routes is not None:
            self._routes[path] = route

    def expose(
        self, port: int | None = None, cache_max_age_s: float | None = None
    ) -> int:
        """Start the /metrics endpoint (``Prom.expose()``); returns the
        bound port (pass 0 for an ephemeral one). ``None`` reads
        ``$METRICS_PORT``, else :data:`DEFAULT_PORT`.

        ``cache_max_age_s`` (the service threads
        ``instance.cache.httpd.metrics_max_age_s`` here) memoizes the
        rendered exposition for that window and serves it with
        ``Cache-Control``/``ETag`` (304 on revalidation): under scrape
        storms the registry renders once per window, not once per
        request. None (the default) keeps the uncached server
        byte-identical."""
        if port is None:
            port = int(os.environ.get("METRICS_PORT", DEFAULT_PORT))
        registry = self.registry

        def render():
            return 200, CONTENT_TYPE, registry.render().encode()

        route = render
        if cache_max_age_s is not None:
            route = CachedRoute(render, cache_max_age_s)
        self._routes = {"/metrics": route, "/": route}
        self._routes.update(self._extra_routes)
        self._server = serve_routes(self._routes, port)
        return self._server.server_address[1]

    @property
    def port(self) -> int | None:
        """The bound port of the running server, or None."""
        return None if self._server is None else self._server.server_address[1]

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
