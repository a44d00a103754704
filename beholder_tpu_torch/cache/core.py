"""Cache core: a policy-pluggable keyed cache with singleflight (the port's
own copy of the reference's ``cache/core.py``).

One host-side primitive shared by every I/O layer that caches
(:mod:`beholder_tpu_torch.storage.cached` memoizes Postgres/analytics reads,
:class:`beholder_tpu_torch.clients.http.CachingTransport` TTL-caches outbound
lookups, :class:`beholder_tpu_torch.httpd.CachedRoute` memoizes read-only
endpoint responses) so hit/miss/eviction accounting, capacity
enforcement, and duplicate-load collapse exist exactly once.

Design points:

- **Policy-pluggable eviction.** :class:`LRUPolicy` (recency),
  :class:`LFUPolicy` (frequency, recency tie-break), :class:`TTLPolicy`
  (LRU + a hard freshness bound). Policies are tiny strategy objects —
  a new policy is ~10 lines, not a new cache.
- **Byte AND entry capacity.** ``max_entries`` bounds count,
  ``max_bytes`` bounds the sum of per-entry sizes (``size_of``; default
  ``sys.getsizeof``) — backlog is bounded in the resource that runs
  out, mirroring the intake queue's cost bound (reliability/shed.py).
- **Singleflight.** :meth:`KeyedCache.get_or_load` collapses concurrent
  misses on one key into ONE loader call; followers block on the
  leader's result (or its exception — a failed load fails everyone, it
  is never cached). The thundering-herd guard for "same prompt family,
  millions of users" traffic.
- **Writer-side invalidation is race-safe.** :meth:`invalidate` during
  an in-flight load marks the flight so the (possibly stale) loaded
  value is returned to waiters but NOT stored.
- **Metrics on demand** (``cache/instruments.py``): nothing registers
  unless a registry is handed in, so the default exposition stays
  byte-identical.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable

from .instruments import EVICT_CAPACITY, EVICT_TTL, CacheMetrics

_MISSING = object()


class _Entry:
    __slots__ = ("value", "size", "expires_at", "freq", "order")

    def __init__(self, value: Any, size: float, expires_at: float | None):
        self.value = value
        self.size = size
        self.expires_at = expires_at
        self.freq = 1
        self.order = 0  # monotonic touch stamp (LFU tie-break)


class EvictionPolicy:
    """Strategy interface: which entry dies when capacity is exceeded.

    ``entries`` is an OrderedDict kept in recency order (least recent
    first) by the cache; policies may use or ignore that invariant."""

    name = "base"
    #: TTL applied to every entry (None = entries never expire)
    ttl_s: float | None = None

    def touch(self, entries: "OrderedDict[Hashable, _Entry]", key: Hashable) -> None:
        """Called on every hit; maintain whatever ordering the policy needs."""
        entries.move_to_end(key)

    def victim(self, entries: "OrderedDict[Hashable, _Entry]") -> Hashable:
        """The key to evict (entries is non-empty)."""
        return next(iter(entries))


class LRUPolicy(EvictionPolicy):
    """Evict the least recently used entry."""

    name = "lru"


class LFUPolicy(EvictionPolicy):
    """Evict the least frequently used entry (LRU tie-break)."""

    name = "lfu"

    def victim(self, entries):
        return min(entries, key=lambda k: (entries[k].freq, entries[k].order))


class TTLPolicy(LRUPolicy):
    """LRU eviction plus a hard freshness bound: every entry expires
    ``ttl_s`` after insertion (expiry is checked lazily on access and
    eagerly when hunting for capacity victims)."""

    name = "ttl"

    def __init__(self, ttl_s: float):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self.ttl_s = float(ttl_s)


def _make_policy(policy: "str | EvictionPolicy", ttl_s: float | None) -> EvictionPolicy:
    if isinstance(policy, EvictionPolicy):
        if ttl_s is not None and policy.ttl_s is None:
            policy.ttl_s = float(ttl_s)
        return policy
    if policy == "lru":
        out: EvictionPolicy = LRUPolicy()
    elif policy == "lfu":
        out = LFUPolicy()
    elif policy == "ttl":
        if ttl_s is None:
            raise ValueError("policy='ttl' needs ttl_s")
        return TTLPolicy(ttl_s)
    else:
        raise ValueError(f"unknown cache policy {policy!r} (lru/lfu/ttl)")
    out.ttl_s = float(ttl_s) if ttl_s is not None else None
    return out


class _Flight:
    """One in-flight load: followers wait on ``done``; exactly one of
    ``value``/``error`` is set before it fires."""

    __slots__ = ("done", "value", "error", "invalidated")

    def __init__(self):
        self.done = threading.Event()
        self.value: Any = None
        self.error: BaseException | None = None
        self.invalidated = False


class KeyedCache:
    """Thread-safe keyed cache with pluggable eviction, byte/entry
    capacity accounting, TTL, explicit invalidation, and singleflight
    loading. ``clock`` is injectable for deterministic TTL tests."""

    def __init__(
        self,
        name: str,
        max_entries: int | None = None,
        max_bytes: float | None = None,
        policy: "str | EvictionPolicy" = "lru",
        ttl_s: float | None = None,
        size_of: Callable[[Any], float] | None = None,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.name = name
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.policy = _make_policy(policy, ttl_s)
        self._size_of = size_of or sys.getsizeof
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self._bytes = 0.0
        self._order = 0
        self._inflight: dict[Hashable, _Flight] = {}
        self._metrics = (
            CacheMetrics(metrics, name) if metrics is not None else None
        )
        # host-side counters, always maintained (bench/tests read these
        # without wiring a registry)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.collapsed = 0

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def size_bytes(self) -> float:
        with self._lock:
            return self._bytes

    # -- internals (call with the lock held) ---------------------------------
    def _drop(self, key: Hashable, reason: str | None) -> None:
        entry = self._entries.pop(key)
        self._bytes -= entry.size
        if reason is not None:
            self.evictions += 1
            if self._metrics is not None:
                self._metrics.evicted(reason)

    def _expired(self, entry: _Entry, now: float) -> bool:
        return entry.expires_at is not None and now >= entry.expires_at

    def _occupancy(self) -> None:
        if self._metrics is not None:
            self._metrics.occupancy(len(self._entries), self._bytes)

    def _lookup(self, key: Hashable) -> Any:
        """Hit/miss accounting + TTL lazy expiry; returns _MISSING on miss."""
        entry = self._entries.get(key)
        now = self._clock()
        if entry is not None and self._expired(entry, now):
            self._drop(key, EVICT_TTL)
            entry = None
        if entry is None:
            self.misses += 1
            if self._metrics is not None:
                self._metrics.miss()
                self._occupancy()
            return _MISSING
        self.hits += 1
        entry.freq += 1
        self._order += 1
        entry.order = self._order
        self.policy.touch(self._entries, key)
        if self._metrics is not None:
            self._metrics.hit()
        return entry.value

    def _store(self, key: Hashable, value: Any, size: float | None) -> None:
        size = float(self._size_of(value) if size is None else size)
        if self.max_bytes is not None and size > self.max_bytes:
            return  # can never fit; storing would evict everything for nothing
        if key in self._entries:
            self._drop(key, None)  # replacement, not an eviction
        now = self._clock()
        ttl = self.policy.ttl_s
        entry = _Entry(value, size, now + ttl if ttl is not None else None)
        self._order += 1
        entry.order = self._order
        self._entries[key] = entry
        self._bytes += size
        # evict until within both capacity bounds (expired entries go
        # first — they are free wins)
        while (
            (self.max_entries is not None and len(self._entries) > self.max_entries)
            or (self.max_bytes is not None and self._bytes > self.max_bytes)
        ):
            expired = next(
                (k for k, e in self._entries.items() if self._expired(e, now)),
                None,
            )
            if expired is not None:
                self._drop(expired, EVICT_TTL)
                continue
            victim = self.policy.victim(self._entries)
            if victim == key:  # never evict what was just stored...
                others = OrderedDict(
                    (k, e) for k, e in self._entries.items() if k != key
                )
                if not others:  # ...unless it is the only entry
                    self._drop(key, EVICT_CAPACITY)
                    break
                victim = self.policy.victim(others)
            self._drop(victim, EVICT_CAPACITY)
        self._occupancy()

    # -- public API ----------------------------------------------------------
    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            value = self._lookup(key)
        return default if value is _MISSING else value

    def put(self, key: Hashable, value: Any, size: float | None = None) -> None:
        with self._lock:
            self._store(key, value, size)

    def invalidate(self, key: Hashable) -> bool:
        """Drop ``key`` (writer-side invalidation). Returns whether an
        entry existed. An in-flight load of the same key is marked so
        its (possibly stale) result is not stored."""
        with self._lock:
            self.invalidations += 1
            if self._metrics is not None:
                self._metrics.invalidated()
            flight = self._inflight.get(key)
            if flight is not None:
                flight.invalidated = True
            if key in self._entries:
                self._drop(key, None)
                self._occupancy()
                return True
        return False

    def invalidate_all(self) -> int:
        with self._lock:
            n = len(self._entries)
            self.invalidations += n
            if self._metrics is not None:
                for _ in range(n):
                    self._metrics.invalidated()
            for flight in self._inflight.values():
                flight.invalidated = True
            self._entries.clear()
            self._bytes = 0.0
            self._occupancy()
        return n

    def get_or_load(
        self,
        key: Hashable,
        loader: Callable[[], Any],
        size: float | None = None,
    ) -> Any:
        """Return the cached value, or load it — collapsing concurrent
        misses on the same key into ONE ``loader()`` call (singleflight).
        A loader exception propagates to the leader AND every collapsed
        follower; nothing is cached on failure."""
        while True:
            with self._lock:
                value = self._lookup(key)
                if value is not _MISSING:
                    return value
                flight = self._inflight.get(key)
                if flight is None:
                    flight = self._inflight[key] = _Flight()
                    leader = True
                else:
                    leader = False
                    self.collapsed += 1
                    if self._metrics is not None:
                        self._metrics.collapsed()
            if leader:
                try:
                    value = loader()
                except BaseException as err:
                    with self._lock:
                        del self._inflight[key]
                        flight.error = err
                    flight.done.set()
                    raise
                with self._lock:
                    del self._inflight[key]
                    if not flight.invalidated:
                        self._store(key, value, size)
                    flight.value = value
                flight.done.set()
                return value
            flight.done.wait()
            if flight.error is not None:
                raise flight.error
            return flight.value


class SingleFlight:
    """Standalone duplicate-call suppression (the cache-free half of
    :meth:`KeyedCache.get_or_load`): concurrent ``do(key, fn)`` calls
    with one key run ``fn`` once and share its result/exception. Nothing
    is retained once the flight lands — this is collapse, not caching."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict[Hashable, _Flight] = {}
        self.collapsed = 0

    def do(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        with self._lock:
            flight = self._inflight.get(key)
            if flight is None:
                flight = self._inflight[key] = _Flight()
                leader = True
            else:
                leader = False
                self.collapsed += 1
        if leader:
            try:
                value = fn()
            except BaseException as err:
                with self._lock:
                    del self._inflight[key]
                    flight.error = err
                flight.done.set()
                raise
            with self._lock:
                del self._inflight[key]
                flight.value = value
            flight.done.set()
            return value
        flight.done.wait()
        if flight.error is not None:
            raise flight.error
        return flight.value
