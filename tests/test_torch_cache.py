"""The port's keyed cache and its three users against the reference's on
the CPU.

Every case of ``tests/test_cache.py`` from the keyed-cache core through the
service wiring runs as one scenario, through the reference's modules and
then through the port's: the same operations, with a fake clock for TTLs,
must give the same results, the same host counters and the same exposition
text (``beholder_cache_*``). Beside them: seeded random operation streams
over each eviction policy, the query cache over each side's
``PgTestServer``, the /metrics server with and without
``cache_max_age_s``, and the service with ``instance.cache`` on over
seeded traffic."""

import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import beholder_tpu.cache as ref_cache
import beholder_tpu.httpd as ref_httpd
import beholder_tpu.metrics as ref_metrics
import beholder_tpu.storage.cached as ref_cached
import beholder_tpu.storage.pg_server as ref_pg_server
import beholder_tpu_torch.cache as port_cache
import beholder_tpu_torch.httpd as port_httpd
import beholder_tpu_torch.metrics as port_metrics
import beholder_tpu_torch.storage.cached as port_cached
import beholder_tpu_torch.storage.pg_server as port_pg_server
from test_torch_service import PORT, REF, S, _random_traffic, assert_same, make_config

pytestmark = pytest.mark.cache

REF.cache, REF.httpd, REF.metrics = ref_cache, ref_httpd, ref_metrics
REF.cached, REF.pg_server = ref_cached, ref_pg_server
PORT.cache, PORT.httpd, PORT.metrics = port_cache, port_httpd, port_metrics
PORT.cached, PORT.pg_server = port_cached, port_pg_server


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def counters(c):
    return dict(hits=c.hits, misses=c.misses, evictions=c.evictions,
                invalidations=c.invalidations, collapsed=c.collapsed, entries=len(c),
                bytes=c.size_bytes)


def both(scenario, *args):
    """Run ``scenario`` through the reference and the port; the port's
    result must equal the reference's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


# -- core: policies, capacity, invalidation, singleflight ---------------------

def core_lru(I):
    c = I.cache.KeyedCache("t", max_entries=2)
    c.put("a", 1)
    c.put("b", 2)
    out = [c.get("a")]
    c.put("c", 3)
    out += [c.get("b"), c.get("a"), c.get("c")]
    assert out == [1, None, 1, 3] and c.evictions == 1
    return out, counters(c)


def core_lfu(I):
    c = I.cache.KeyedCache("t", max_entries=2, policy=I.cache.LFUPolicy())
    c.put("a", 1)
    c.put("b", 2)
    for _ in range(3):
        c.get("a")
    c.get("b")
    c.put("c", 3)  # b has the lowest frequency
    out = [c.get("b"), c.get("a"), c.get("c")]
    assert out == [None, 1, 3]
    return out, counters(c), c.policy.name


def core_ttl(I):
    clock = FakeClock()
    c = I.cache.KeyedCache("t", policy="ttl", ttl_s=10.0, clock=clock)
    c.put("a", 1)
    out = [c.get("a")]
    clock.advance(10.0)
    out.append(c.get("a"))  # expired exactly at the bound
    assert out == [1, None] and (c.evictions, c.hits, c.misses) == (1, 1, 1)
    return out, counters(c)


def core_bytes(I):
    c = I.cache.KeyedCache("t", max_bytes=100, size_of=len)
    c.put("a", "x" * 40)
    c.put("b", "y" * 40)
    sizes = [c.size_bytes]
    c.put("c", "z" * 40)  # 120 > 100: LRU "a" must go
    sizes.append(c.size_bytes)
    c.put("huge", "h" * 200)  # can never fit: refused, nothing evicted
    out = [c.get("a"), c.get("huge"), len(c)]
    assert sizes == [80, 80] and out == [None, None, 2]
    return sizes, out, counters(c)


def core_invalidate(I):
    c = I.cache.KeyedCache("t")
    c.put("a", 1)
    c.put("b", 2)
    out = [c.invalidate("a"), c.invalidate("a"), c.get("a"), c.get("b"), c.invalidate_all()]
    assert out == [True, False, None, 2, 1] and len(c) == 0
    return out, counters(c)


def core_expired_go_first(I):
    """Hunting for room, an expired entry goes (as ``ttl``) before the
    policy's victim; the entry just stored is evicted only when alone."""
    clock = FakeClock()
    c = I.cache.KeyedCache("t", max_entries=2, policy="lru", ttl_s=5.0, clock=clock)
    c.put("old", 1)
    clock.advance(3.0)
    c.put("mid", 2)
    clock.advance(3.0)  # "old" expired, "mid" not
    c.put("new", 3)
    out = [c.get("mid"), c.get("new"), c.get("old")]
    one = I.cache.KeyedCache("one", max_bytes=10, size_of=len)
    one.put("k", "x" * 10)
    return out, counters(c), counters(one)


def core_policy_errors(I):
    out = []
    for kw in (dict(max_entries=0), dict(max_bytes=0), dict(policy="mru"),
               dict(policy="ttl"), dict(policy="ttl", ttl_s=-1.0)):
        with pytest.raises(ValueError) as err:
            I.cache.KeyedCache("t", **kw)
        out.append(str(err.value))
    lru = I.cache.LRUPolicy()
    c = I.cache.KeyedCache("t", policy=lru, ttl_s=3)
    out.append((c.policy is lru, lru.ttl_s, I.cache.TTLPolicy(2).name,
                I.cache.KeyedCache("t", policy="lfu", ttl_s=1).policy.ttl_s))
    return out


def core_singleflight_collapse(I):
    c = I.cache.KeyedCache("t")
    calls = []
    entered = threading.Event()
    release = threading.Event()

    def loader():
        calls.append(1)
        entered.set()
        release.wait(timeout=5)
        return "value"

    results = []

    def leader():
        results.append(c.get_or_load("k", loader))

    def follower():
        entered.wait(timeout=5)
        results.append(c.get_or_load("k", lambda: pytest.fail("follower must collapse")))

    threads = [threading.Thread(target=leader)] + [
        threading.Thread(target=follower) for _ in range(4)]
    for t in threads:
        t.start()
    entered.wait(timeout=5)
    deadline = time.monotonic() + 5
    while c.collapsed < 4 and time.monotonic() < deadline:
        time.sleep(0.002)
    release.set()
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert results == ["value"] * 5 and len(calls) == 1 and c.collapsed == 4
    return results, len(calls), counters(c)


def core_singleflight_error(I):
    c = I.cache.KeyedCache("t")
    with pytest.raises(RuntimeError, match="boom"):
        c.get_or_load("k", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    out = [c.get("k"), c.get_or_load("k", lambda: 42), c.get("k")]
    assert out == [None, 42, 42]
    return out, counters(c)


def core_singleflight_error_fails_followers(I):
    """A failed load fails every collapsed follower with the leader's
    exception, and nothing is cached."""
    c = I.cache.KeyedCache("t")
    entered, release = threading.Event(), threading.Event()

    def loader():
        entered.set()
        release.wait(timeout=5)
        raise KeyError("gone")

    errors = []

    def call():
        try:
            c.get_or_load("k", loader)
        except KeyError as err:
            errors.append(repr(err))

    threads = [threading.Thread(target=call) for _ in range(3)]
    threads[0].start()
    entered.wait(timeout=5)
    for t in threads[1:]:
        t.start()
    deadline = time.monotonic() + 5
    while c.collapsed < 2 and time.monotonic() < deadline:
        time.sleep(0.002)
    release.set()
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert errors == ["KeyError('gone')"] * 3 and len(c) == 0
    return errors, counters(c)


def core_invalidate_inflight(I):
    c = I.cache.KeyedCache("t")
    entered, release = threading.Event(), threading.Event()

    def loader():
        entered.set()
        release.wait(timeout=5)
        return "stale"

    out = []
    t = threading.Thread(target=lambda: out.append(c.get_or_load("k", loader)))
    t.start()
    entered.wait(timeout=5)
    c.invalidate("k")  # the writer moved underneath the load
    release.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert out == ["stale"] and c.get("k") is None  # returned, never stored
    return out, counters(c)


def core_standalone_singleflight(I):
    sf = I.cache.SingleFlight()
    out = [sf.do("k", lambda: 7), sf.do("k", lambda: 8)]
    with pytest.raises(ValueError):
        sf.do("k", lambda: int("x"))
    out.append(sf.do("k", lambda: 9))
    assert out == [7, 8, 9] and sf.collapsed == 0
    return out


def core_metrics_series(I):
    reg = I.metrics.Registry()
    c = I.cache.KeyedCache("demo", max_entries=1, metrics=reg)
    c.put("a", 1)
    c.get("a")
    c.get("b")
    c.put("b", 2)  # evicts a
    c.invalidate("b")
    clock = FakeClock()
    t = I.cache.KeyedCache("ttl", policy="ttl", ttl_s=1.0, metrics=I.metrics.Metrics(reg),
                           clock=clock)
    t.get_or_load("x", lambda: "value")
    clock.advance(2.0)
    t.get("x")
    t.put("y", 1)
    t.invalidate_all()
    text = reg.render()
    assert 'beholder_cache_hits_total{cache="demo"} 1' in text
    assert 'beholder_cache_evictions_total{cache="demo",reason="capacity"} 1' in text
    assert 'beholder_cache_evictions_total{cache="ttl",reason="ttl"} 1' in text
    assert 'beholder_cache_entries{cache="demo"} 0' in text
    return text


CORE = {f.__name__[5:]: f for f in (
    core_lru, core_lfu, core_ttl, core_bytes, core_invalidate, core_expired_go_first,
    core_policy_errors, core_singleflight_collapse, core_singleflight_error,
    core_singleflight_error_fails_followers, core_invalidate_inflight,
    core_standalone_singleflight, core_metrics_series)}


@pytest.mark.parametrize("case", list(CORE))
def test_keyed_cache_matches_the_reference(case):
    both(CORE[case])


def random_ops(seed, n=300):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        key = f"k{rng.integers(8)}"
        roll = rng.random()
        if roll < 0.3:
            ops.append(("put", key, "v" * int(rng.integers(1, 40))))
        elif roll < 0.6:
            ops.append(("get", key))
        elif roll < 0.8:
            ops.append(("load", key, "w" * int(rng.integers(1, 40)), bool(rng.random() < 0.2)))
        elif roll < 0.9:
            ops.append(("advance", float(rng.integers(1, 4))))
        elif roll < 0.98:
            ops.append(("invalidate", key))
        else:
            ops.append(("invalidate_all",))
    return ops


def run_ops(I, policy, ops):
    clock = FakeClock()
    reg = I.metrics.Registry()
    kw = dict(policy=policy, ttl_s=5.0) if policy in ("ttl", "lru+ttl") else dict(policy=policy)
    kw["policy"] = "lru" if policy == "lru+ttl" else policy
    c = I.cache.KeyedCache("rand", max_entries=5, max_bytes=120, size_of=len, metrics=reg,
                           clock=clock, **kw)
    trace = []
    for op in ops:
        if op[0] == "put":
            c.put(op[1], op[2])
        elif op[0] == "get":
            trace.append(c.get(op[1], "-"))
        elif op[0] == "load":
            def loader(value=op[2], fail=op[3]):
                if fail:
                    raise LookupError(value)
                return value
            try:
                trace.append(c.get_or_load(op[1], loader))
            except LookupError as err:
                trace.append(f"error {err}")
        elif op[0] == "advance":
            clock.advance(op[1])
        elif op[0] == "invalidate":
            trace.append(c.invalidate(op[1]))
        else:
            trace.append(c.invalidate_all())
        trace.append((len(c), c.size_bytes))
    return trace, counters(c), reg.render()


@pytest.mark.parametrize("policy", ["lru", "lfu", "ttl", "lru+ttl"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_operations_match_the_reference(policy, seed):
    trace, count, _ = both(run_ops, policy, random_ops(seed))
    assert count["hits"] and count["misses"] and count["evictions"]


# -- storage: the query cache -------------------------------------------------

@pytest.fixture(scope="module")
def pg():
    """One ``PgTestServer`` a side (trust auth), emptied by each scenario."""
    servers = {"ref": ref_pg_server.PgTestServer(), "port": port_pg_server.PgTestServer()}
    for srv in servers.values():
        srv.start()
    yield servers
    for srv in servers.values():
        srv.stop()


def media(I, id="m1", status=0):
    return I.proto.Media(id=id, name="Movie", creator=I.proto.CreatorType.TRELLO,
                         creatorId="card-1", metadataId="42", status=status)


def row_of(m):
    return (m.id, m.name, int(m.creator), m.creatorId, m.metadataId, int(m.status))


def selects(srv):
    return sum(1 for sql, _ in srv.queries if sql.strip().startswith("SELECT"))


def pg_hits_skip_the_wire(I, pg):
    srv = pg[I.name]
    srv.rows.clear()
    srv.queries.clear()
    clock = FakeClock()
    db = I.cached.CachingStorage(I.storage.PostgresStorage(srv.url()), ttl_s=30.0, clock=clock)
    db.add_media(media(I))
    db.get_by_id("m1")
    before = selects(srv)
    names = [db.get_by_id("m1").name for _ in range(5)]
    assert selects(srv) == before == 1  # all five served from the cache
    out = names, counters(db.cache), list(srv.queries)
    db.close()
    return out


def pg_writer_invalidation(I, pg):
    srv = pg[I.name]
    srv.rows.clear()
    srv.queries.clear()
    db = I.cached.CachingStorage(I.storage.PostgresStorage(srv.url()), ttl_s=30.0,
                                 clock=FakeClock())
    db.add_media(media(I, status=0))
    out = [db.get_by_id("m1").status]
    db.update_status("m1", 3)  # write-through + invalidate
    out.append(db.get_by_id("m1").status)
    with pytest.raises(I.storage.MediaNotFound):
        db.update_status("ghost", 1)
    found = db.update_status_batch([("m1", 4), ("ghost", 1)])
    out += [found, db.get_by_id("m1").status, selects(srv)]
    assert out == [0, 3, [True, False], 4, 3]
    out.append([q for q, _ in srv.queries].count("BEGIN"))
    db.close()
    return out, counters(db.cache)


def pg_ttl_expiry(I, pg):
    srv = pg[I.name]
    srv.rows.clear()
    srv.queries.clear()
    clock = FakeClock()
    db = I.cached.CachingStorage(I.storage.PostgresStorage(srv.url()), ttl_s=5.0, clock=clock)
    db.add_media(media(I))
    db.get_by_id("m1")
    before = selects(srv)
    clock.advance(5.0)
    db.get_by_id("m1")
    assert selects(srv) == before + 1  # expired -> re-queried
    db.close()
    return counters(db.cache), selects(srv)


PG = {f.__name__[3:]: f for f in (pg_hits_skip_the_wire, pg_writer_invalidation,
                                  pg_ttl_expiry)}


@pytest.mark.parametrize("case", list(PG))
def test_postgres_query_cache_matches_the_reference(case, pg):
    both(PG[case], pg)


def counting_storage(I):
    """A ``MemoryStorage`` that counts the BATCH hops: evidence that
    CachingStorage forwards them instead of unfolding them per row."""

    class Counting(I.storage.MemoryStorage):
        def __init__(self):
            super().__init__()
            self.batch_writes = 0
            self.batch_reads = []
            self.reads = 0

        def update_status_batch(self, updates):
            self.batch_writes += 1
            return super().update_status_batch(updates)

        def get_by_ids(self, media_ids):
            self.batch_reads.append(list(media_ids))
            return super().get_by_ids(media_ids)

        def get_by_id(self, media_id):
            self.reads += 1
            return super().get_by_id(media_id)

    return Counting()


def storage_defensive_copies(I):
    db = I.cached.CachingStorage(I.storage.MemoryStorage())
    db.add_media(media(I, status=0))
    row = db.get_by_id("m1")
    row.status = 9  # caller mutation must not poison the cache
    assert db.get_by_id("m1").status == 0
    return counters(db.cache)


def storage_not_found_never_cached(I):
    db = I.cached.CachingStorage(I.storage.MemoryStorage())
    with pytest.raises(I.storage.MediaNotFound):
        db.get_by_id("ghost")
    db.add_media(media(I, id="ghost"))
    assert db.get_by_id("ghost").id == "ghost"
    db.invalidate("ghost")
    return counters(db.cache)


def storage_batch_write(I):
    inner = counting_storage(I)
    db = I.cached.CachingStorage(inner)
    for i in range(3):
        db.add_media(media(I, id=f"m{i}", status=0))
        db.get_by_id(f"m{i}")
    found = db.update_status_batch([("m0", 3), ("m1", 4), ("ghost", 5), ("m2", 6)])
    statuses = [db.get_by_id(f"m{i}").status for i in range(3)]
    assert inner.batch_writes == 1 and found == [True, True, False, True]
    assert statuses == [3, 4, 6]
    return found, statuses, inner.reads, counters(db.cache)


def storage_batch_read(I):
    inner = counting_storage(I)
    db = I.cached.CachingStorage(inner)
    for i in range(4):
        db.add_media(media(I, id=f"m{i}", status=i))
    db.get_by_id("m0")
    rows = db.get_by_ids(["m0", "m1", "m2", "ghost"])
    assert inner.batch_reads == [["m1", "m2", "ghost"]] and sorted(rows) == ["m0", "m1", "m2"]
    again = db.get_by_ids(["m1", "m2"])
    assert inner.batch_reads == [["m1", "m2", "ghost"]]
    rows["m1"].status = 99
    assert db.get_by_id("m1").status == 1
    db.add_media(media(I, id="ghost", status=7))
    assert db.get_by_ids(["ghost"])["ghost"].status == 7
    return ({k: row_of(v) for k, v in rows.items()}, sorted(again), inner.batch_reads,
            inner.reads, counters(db.cache))


STORAGE = {f.__name__[8:]: f for f in (storage_defensive_copies, storage_not_found_never_cached,
                                       storage_batch_write, storage_batch_read)}


@pytest.mark.parametrize("case", list(STORAGE))
def test_caching_storage_matches_the_reference(case):
    both(STORAGE[case])


# -- clients: the outbound lookup cache ---------------------------------------

def reqs(transport):
    return [(r.method, r.url, r.params, r.json, r.headers) for r in transport.requests]


def http_caches_lookups(I):
    inner = I.clients.RecordingTransport()
    inner.responses = [I.http.HttpResponse(200, {"name": "board"})]
    t = I.http.CachingTransport(inner, ttl_s=30.0)
    bodies = [t.request("get", "https://api.trello.com/1/boards/b1").body for _ in range(3)]
    assert bodies == [{"name": "board"}] * 3 and len(inner.requests) == 1 and t.cache.hits == 2
    return bodies, reqs(inner), counters(t.cache)


def http_allowlist(I):
    urls = ["https://api.telegram.org/botT/sendMessage", "http://emby:8096/emby/library/refresh",
            "https://api.trello.com/1/boards/b1", "https://api.trello.com/1/cards/c1",
            "http://emby:8096/emby/Library/VirtualFolders", "https://api.trello.com/1/lists/l"]
    verdicts = [I.http.read_only_get(m, u) for m in ("get", "GET", "put") for u in urls]
    inner = I.clients.RecordingTransport()
    t = I.http.CachingTransport(inner, ttl_s=30.0)
    for _ in range(3):
        t.request("get", urls[0], params={"text": "hi"})
        t.request("put", urls[3], params={"idList": "l"})
        t.request("get", urls[2], json={"x": 1})  # a body is never cached
    assert len(inner.requests) == 9
    return verdicts, reqs(inner), counters(t.cache)


def http_ttl_and_params(I):
    clock = FakeClock()
    inner = I.clients.RecordingTransport()
    inner.responses = [I.http.HttpResponse(200, {"v": v}) for v in (1, 2, 3)]
    t = I.http.CachingTransport(inner, ttl_s=10.0, clock=clock)
    url = "https://api.trello.com/1/cards/c1"
    out = [t.request("get", url, params={"fields": "name"}).body,
           t.request("get", url, params={"fields": "desc"}).body,
           t.request("get", url, params={"fields": "name"}).body]
    clock.advance(10.0)
    out.append(t.request("get", url, params={"fields": "name"}).body)
    assert out == [{"v": 1}, {"v": 2}, {"v": 1}, {"v": 3}]
    return out, reqs(inner), counters(t.cache)


def http_defensive_copies(I):
    inner = I.clients.RecordingTransport()
    inner.responses = [I.http.HttpResponse(200, {"lists": ["a", "b"]})]
    t = I.http.CachingTransport(inner, ttl_s=30.0)
    url = "https://api.trello.com/1/boards/b1"
    first = t.request("get", url)
    first.body["lists"].append("MUTATED")
    second = t.request("get", url, headers={"traceparent": "00-x"})  # not in the key
    assert second.body == {"lists": ["a", "b"]}
    return second.body, reqs(inner), counters(t.cache)


def http_list_params(I):
    inner = I.clients.RecordingTransport()
    inner.responses = [I.http.HttpResponse(200, {"v": 1})]
    t = I.http.CachingTransport(inner, ttl_s=30.0)
    url = "https://api.trello.com/1/boards/b1"
    p = {"fields": ["name", "desc"], "nested": {"a": [1, 2]}, "tags": {"x"}}
    out = [t.request("get", url, params=p).body, t.request("get", url, params=p).body]
    assert out == [{"v": 1}] * 2 and len(inner.requests) == 1
    return out, I.http._freeze(p), counters(t.cache)


def http_errors_not_cached(I):
    inner = I.clients.RecordingTransport()
    inner.responses = [I.http.HttpResponse(500, "down"), I.http.HttpResponse(302, "moved"),
                       I.http.HttpResponse(200, {"ok": 1})]
    t = I.http.CachingTransport(inner, ttl_s=30.0)
    url = "https://api.trello.com/1/boards/b1"
    out = [(r.status, r.body) for r in (t.request("get", url) for _ in range(4))]
    assert out == [(500, "down"), (302, "moved"), (200, {"ok": 1}), (200, {"ok": 1})]
    inner.fail_with = ConnectionError("down")
    t.cache.invalidate_all()
    with pytest.raises(ConnectionError):
        t.request("get", url)
    return out, reqs(inner), counters(t.cache)


def http_client_lookups(I):
    inner = I.clients.RecordingTransport()
    reg = I.metrics.Registry()
    transport = I.http.CachingTransport(inner, ttl_s=30.0, metrics=reg)
    trello = I.clients.TrelloClient("K", "T", transport=transport)
    emby = I.clients.EmbyClient("http://emby:8096", "tok", transport=transport)
    trello.get_board("b1")
    trello.get_board("b1")
    trello.get_card("c1")
    trello.get_card("c1")
    emby.library_folders()
    emby.library_folders()
    emby.refresh_library()
    emby.refresh_library()  # a side effect: on the wire every time
    assert len(inner.requests) == 5
    return reqs(inner), counters(transport.cache), reg.render()


HTTP = {f.__name__[5:]: f for f in (http_caches_lookups, http_allowlist, http_ttl_and_params,
                                    http_defensive_copies, http_list_params,
                                    http_errors_not_cached, http_client_lookups)}


@pytest.mark.parametrize("case", list(HTTP))
def test_caching_transport_matches_the_reference(case):
    both(HTTP[case])


# -- httpd: the endpoint response cache ---------------------------------------

def route_memoizes(I):
    clock = FakeClock()
    bodies = [b"exposition-1", b"exposition-2"]
    cached = I.httpd.CachedRoute(lambda: (200, "text/plain", bodies.pop(0)), max_age_s=5.0,
                                 clock=clock)
    out = [cached.respond({})]
    etag = out[0][3]["ETag"]
    out += [cached.respond({}), cached.respond({"If-None-Match": etag}), cached(),
            cached.respond(None)]
    clock.advance(5.0)
    out.append(cached.respond({"If-None-Match": etag}))
    cached.invalidate()
    assert out[2][:3] == (304, "text/plain", b"") and out[5][3]["ETag"] != etag
    assert out[0][3]["Cache-Control"] == "max-age=5"
    with pytest.raises(ValueError):
        I.httpd.CachedRoute(lambda: None, max_age_s=0)
    return out, cached.hits, cached.misses


def route_never_caches_errors(I):
    codes = [(500, b"boom"), (200, b"ok")]

    def route():
        code, body = codes.pop(0)
        return code, "text/plain", body

    cached = I.httpd.CachedRoute(route, max_age_s=60.0)
    out = [cached.respond({}), cached.respond({})]
    assert out[0] == (500, "text/plain", b"boom", {}) and out[1][0] == 200
    return out, cached.hits, cached.misses


ROUTE = {"memoizes": route_memoizes, "never_caches_errors": route_never_caches_errors}


@pytest.mark.parametrize("case", list(ROUTE))
def test_cached_route_matches_the_reference(case):
    both(ROUTE[case])


def raw_get(port, path="/metrics", headers=()):
    """The server's whole response, its ``Date`` line masked."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        extra = "".join(f"{k}: {v}\r\n" for k, v in headers)
        sock.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n{extra}Connection: close\r\n\r\n"
                     .encode())
        data = b""
        while chunk := sock.recv(65536):
            data += chunk
    return b"\r\n".join(line for line in data.split(b"\r\n") if not line.startswith(b"Date:"))


def metrics_live(I, max_age):
    m = I.metrics.Metrics()
    port = m.expose(0, cache_max_age_s=max_age) if max_age else m.expose(0)
    try:
        m.progress_updates_total.inc(status="queued")
        first = raw_get(port)
        m.progress_updates_total.inc(status="queued")  # stale inside a window
        second = raw_get(port)
        url = f"http://127.0.0.1:{port}/metrics"
        with urllib.request.urlopen(url) as resp:
            etag = resp.headers["ETag"]
            resp.read()
        conditional = raw_get(port, headers=[("If-None-Match", etag or '"none"')])
        root = raw_get(port, "/")
    finally:
        m.close()
    return first, second, conditional, root, etag is None


@pytest.mark.parametrize("max_age", [None, 60.0])
def test_metrics_server_matches_the_reference(max_age):
    first, second, conditional, root, no_etag = both(metrics_live, max_age)
    if max_age is None:
        assert no_etag and b"ETag" not in first and b"Cache-Control" not in first
        assert second != first and b'status="queued"} 2' in second
    else:
        assert b"Cache-Control: max-age=60" in first and second == first
        assert conditional.startswith(b"HTTP/1.0 304") and conditional.endswith(b"\r\n\r\n")


def test_uncached_metrics_server_is_the_parents():
    """With ``cache_max_age_s`` None the server answers as it did before
    the cache existed: the same status line, headers and body as a plain
    route on the same registry."""
    m = port_metrics.Metrics()
    port = m.expose(0)
    plain = port_httpd.serve_routes(
        {"/metrics": lambda: (200, port_metrics.CONTENT_TYPE,
                              m.registry.render().encode())}, 0)
    try:
        m.trello_comments_total.inc()
        assert raw_get(port) == raw_get(plain.server_address[1])
    finally:
        plain.shutdown()
        plain.server_close()
        m.close()


# -- the service's wiring -----------------------------------------------------

def service_wiring(I):
    config = I.config.ConfigNode({"keys": {"trello": {"key": "K", "token": "T"}},
                                  "instance": {"flow_ids": {"queued": "l0"},
                                               "cache": {"enabled": True}}})
    svc = I.service.BeholderService(config, I.mq.InMemoryBroker(), I.storage.MemoryStorage(),
                                    transport=I.clients.RecordingTransport(), **I.kw)
    assert isinstance(svc.db, I.cached.CachingStorage)
    assert isinstance(svc.trello._transport, I.http.CachingTransport)
    assert svc.trello._transport is svc.telegram._transport is svc.emby._transport
    svc.db.inner.add_media(media(I))
    svc.db.get_by_id("m1")
    svc.db.get_by_id("m1")
    text = svc.metrics.registry.render()
    assert 'beholder_cache_hits_total{cache="storage.media"} 1' in text
    return text


def service_wiring_knobs(I):
    """Each half alone, a reliability stack under the cache, and the
    knobs' values."""
    out = []
    for cache in ({"enabled": True, "storage": {"enabled": False}},
                  {"enabled": True, "http": {"enabled": False},
                   "storage": {"ttl_s": 2.5, "max_entries": 7}},
                  {"enabled": True, "http": {"ttl_s": 1.5, "max_entries": 3}},
                  {"enabled": False, "storage": {"enabled": True}}):
        config = I.config.ConfigNode({"instance": {"cache": cache,
                                                   "reliability": {"enabled": True}}})
        db = I.storage.MemoryStorage()
        svc = I.service.BeholderService(config, I.mq.InMemoryBroker(), db,
                                        transport=I.clients.RecordingTransport(), **I.kw)
        t = svc.trello._transport
        caches = [getattr(svc.db, "cache", None), getattr(t, "cache", None)]
        out.append((svc.db is db, type(t).__name__, type(getattr(t, "inner", t)).__name__,
                    [None if c is None else (c.name, c.max_entries, c.policy.ttl_s)
                     for c in caches],
                    "beholder_cache" in svc.metrics.registry.render()))
        svc.close()
    return out


def service_semantics(I):
    """Both consumers with caching on: the status consumer's read-after-write
    observes its own update, the progress consumer's repeated reads
    collapse onto the cache, side effects unchanged."""
    broker, db = I.mq.InMemoryBroker(prefetch=100), I.storage.MemoryStorage()
    transport = I.clients.RecordingTransport()
    config = I.config.ConfigNode({"keys": {"trello": {"key": "K", "token": "T"}},
                                  "instance": {"flow_ids": {"downloading": "list-dl"},
                                               "cache": {"enabled": True}}})
    svc = I.service.BeholderService(config, broker, db, transport=transport, **I.kw)
    db.add_media(media(I))
    svc.start()
    broker.publish(I.service.STATUS_TOPIC, I.proto.encode(
        I.proto.TelemetryStatus(mediaId="m1", status=S.DOWNLOADING)))
    assert db.get_by_id("m1").status == S.DOWNLOADING
    for i in range(3):
        broker.publish(I.service.PROGRESS_TOPIC, I.proto.encode(I.proto.TelemetryProgress(
            mediaId="m1", status=S.DOWNLOADING, progress=10 * i)))
    assert len(transport.requests) == 4 and transport.requests[0].params["idList"] == "list-dl"
    out = reqs(transport), counters(svc.db.cache), svc.metrics.registry.render()
    svc.close()
    return out


def service_cache_off(I):
    config = I.config.ConfigNode({"keys": {"trello": {"key": "K", "token": "T"}}})
    db = I.storage.MemoryStorage()
    svc = I.service.BeholderService(config, I.mq.InMemoryBroker(), db,
                                    transport=I.clients.RecordingTransport(), **I.kw)
    assert svc.db is db and "beholder_cache" not in svc.metrics.registry.render()
    return type(svc.trello._transport).__name__


SERVICE = {f.__name__[8:]: f for f in (service_wiring, service_wiring_knobs, service_semantics,
                                       service_cache_off)}


@pytest.mark.parametrize("case", list(SERVICE))
def test_service_cache_wiring_matches_the_reference(case):
    both(SERVICE[case])


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_traffic_with_the_cache_matches_the_reference(seed):
    """Seeded traffic (unknown ids, undecodable bodies, 500s, an outage)
    through both services with ``instance.cache`` on: acks, rows, outbound
    requests, logs, summaries and the exposition (the cache's series
    included) are equal."""
    media_rows, steps = _random_traffic(seed)
    got = assert_same(make_config(cache={"enabled": True, "storage": {"ttl_s": 600}}), steps,
                      media_rows)
    assert 'beholder_cache_hits_total{cache="storage.media"}' in got["exposition"]
    assert 'cache="http.get"' not in got["exposition"]  # no lookup in the mix


@pytest.mark.parametrize("storage", ["memory", "sqlite"])
@pytest.mark.parametrize("cache", [None, {"enabled": False, "storage": {"ttl_s": 1}}])
def test_cache_off_is_the_uncached_service(cache, storage, tmp_path):
    """``instance.cache`` absent or off, in memory or on SQLite: everything
    the service did equals the run with no cache node at all, and the
    reference's."""
    media_rows, steps = _random_traffic(2, n=60)
    runs = iter(range(8))

    def make_db(I):
        if storage == "memory":
            return I.storage.MemoryStorage()
        return I.storage.SqliteStorage(str(tmp_path / f"{I.name}-{next(runs)}.db"))

    want = assert_same(make_config(), steps, media_rows, make_db=make_db)
    extra = {} if cache is None else {"cache": cache}
    got = assert_same(make_config(**extra), steps, media_rows, make_db=make_db)
    assert got == want and "beholder_cache" not in got["exposition"]
