"""The port's group-parallel decode against its own single batcher and the
JAX reference: config parse, device blocks, the refusals, the default-off
cluster, group-of-2 streams bitwise the single batcher's in bf16, int8 and
fp8, warm admissions, colocated and disaggregated group clusters, a fabric
hit onto a group shard, a whole-group kill, the member instants, the wire
format, the ``Block`` group forward, the megatron split of the weights and
the member pools' layout.

Model, weights and geometry are ``tests/test_group.py``'s (``dim=32,
heads=2, layers=1``, ``init_seq_state(PRNGKey(0), 24)``'s params through
the weight bridge, 16 pages of 8 tokens, 2 slots). The JAX group runs over
``tests/conftest.py``'s virtual CPU devices as the reference's tests run
it; the port's members are ``devices=["cpu", "cpu"]`` (clusters:
``["cpu"] * 4``). Tolerances:

- group against the port's single batcher: ``np.array_equal`` (the
  reference's own contract, ``beholder_tpu/cluster/group/__init__.py``:
  heads are put back together by concatenation, never summed), and pool
  bytes (exported full-head) and allocator state exactly equal;
- the port's streams against the JAX group's: the first value within
  ``atol=1e-4``, the whole stream within the band of
  ``tests/test_prefix_cache.py:138-165`` (rtol 3e-2, atol 1.5e-2), as
  ``tests/test_torch_fabric.py`` holds them and for its reason: at the
  reference tests' seeds some streams leave 1e-4 after a tick or two (the
  worst here, 1.79e-3 at the int8 group's sixth step), one bf16 spacing in
  an early tick carried by the fed-back prediction (ROADMAP C.4), while the
  port's group and single batcher agree bit for bit;
- page, transfer, fabric and failover counters: exactly the reference's.

``test_autotune_group_family_keys`` has its counterpart in
``tests/test_torch_autotune.py``, beside the port's autotune table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.cache import PrefixCache as JaxPrefixCache
from beholder_tpu.cluster import GroupConfig as JaxGroupConfig
from beholder_tpu.cluster import cluster_from_config as jax_cluster_from_config
from beholder_tpu.cluster.group import GroupBatcher as JaxGroupBatcher
from beholder_tpu.config import ConfigNode
from beholder_tpu.models import serving as jsv
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.parallel import mesh as jmesh
from beholder_tpu.parallel.sharding import path_specs
from beholder_tpu.reliability import chaos as jchaos
from beholder_tpu_torch.cache import PrefixCache
from beholder_tpu_torch.cluster import (
    ClusterConfig,
    FabricConfig,
    FailoverConfig,
    GroupConfig,
    cluster_from_config,
)
from beholder_tpu_torch.cluster.group import GroupBatcher
from beholder_tpu_torch.metrics import Registry
from beholder_tpu_torch.models import serving as tsv
from beholder_tpu_torch.models.sequence import Block
from beholder_tpu_torch.obs import FlightRecorder
from beholder_tpu_torch.ops.paged_attention import (
    ChunkPagedInfo,
    GroupSpec,
    PagedInfo,
    QuantizedPool,
)
from beholder_tpu_torch.parallel.mesh import group_mesh, serving_shard_devices
from beholder_tpu_torch.parallel.sharding import (
    seq_spec,
    seq_split_dim,
    shard_tensors,
    specs_for,
    unshard_tensors,
)
from beholder_tpu_torch.reliability.chaos import WorkerFault, inject_worker_fault
from beholder_tpu_torch.spec import SpecConfig

from test_torch_cluster import (  # noqa: F401 - the shared fixture
    BATCHER_KW,
    _jcfg,
    _jreq,
    _pristine,
    _request,
    pair,
)
from test_torch_fabric import _close_band as _close

FAMILIES = ["bf16", "int8", "fp8"]


def _jdtype(family):
    return {"int8": jnp.int8, "fp8": "fp8"}.get(family, jnp.bfloat16)


def _single(pair, **kw):
    return tsv.ContinuousBatcher(pair[2], **{**BATCHER_KW, **kw}, device="cpu")


def _group(pair, n=2, **kw):
    return GroupBatcher(pair[2], devices=["cpu"] * n, **{**BATCHER_KW, **kw})


def _jgroup(pair, n=2, **kw):
    jm, params, _ = pair
    return JaxGroupBatcher(jm, params, devices=tuple(jax.devices()[:n]), **{**BATCHER_KW, **kw})


def _cluster(pair, cfg, **kw):
    from beholder_tpu.cluster.router import ClusterScheduler as JaxClusterScheduler
    from beholder_tpu_torch.cluster.router import ClusterScheduler

    jm, params, tm = pair
    jkw = dict(kw)
    if "prefix_cache_factory" in jkw:
        jkw["prefix_cache_factory"] = lambda: JaxPrefixCache(8)
    port = ClusterScheduler(tm, cfg, devices=["cpu"] * 4, **{**BATCHER_KW, **kw})
    ref = JaxClusterScheduler(jm, params, _jcfg(cfg), **{**BATCHER_KW, **jkw})
    return port, ref


def _run_both(port, ref, reqs):
    got = port.run(reqs)
    _close(got, ref.run([_jreq(r) for r in reqs]))
    return got


def _bitwise(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), f"result {i}"


def _alloc(state):
    """Allocator state as numpy, from the port's state or the reference's."""
    return tuple(np.asarray(x) for x in (state.page_table, state.seq_lens, state.active,
                                         state.free_stack, state.free_top, state.page_ref,
                                         state.alloc_failed))


def _same_alloc(port_state, ref_state):
    ref_state = jax.device_get(ref_state)
    for a, b in zip(_alloc(port_state), _alloc(ref_state)):
        assert np.array_equal(a, b)


def _flat(chunks):
    """Every leaf of an ``export_pages`` result as uint8 bytes."""
    ks, vs = chunks
    out = []
    for c in (*ks, *vs):
        for x in (c if isinstance(c, tuple) else (c,)):
            out.append(x.contiguous().view(torch.uint8).numpy())
    return out


# -- config ------------------------------------------------------------------


def test_group_config_parse_and_validation():
    tree = {"instance": {"cluster": {"enabled": True, "group": {"enabled": True, "size": 2}}}}
    got = cluster_from_config(ConfigNode(tree)).group
    want = jax_cluster_from_config(ConfigNode(tree)).group
    assert (got.size, got.axis, got.head_partition) == (2, "tp", "kv_head")
    assert (got.size, got.axis, got.head_partition) == (want.size, want.axis,
                                                        want.head_partition)
    for tree in ({"instance": {"cluster": {"enabled": True}}},
                 {"instance": {"cluster": {"enabled": True,
                                           "group": {"enabled": False, "size": 4}}}}):
        assert cluster_from_config(ConfigNode(tree)).group is None
        assert jax_cluster_from_config(ConfigNode(tree)).group is None
    for kw in (dict(size=1), dict(axis="not an identifier!"), dict(head_partition="page")):
        with pytest.raises(ValueError):
            GroupConfig(**kw)
        with pytest.raises(ValueError):
            JaxGroupConfig(**kw)


def test_group_size_must_divide_kv_heads_and_devices(pair):
    # 2 kv heads: a group of 3 cannot split them (refused at build)
    with pytest.raises(ValueError, match="KV heads"):
        _group(pair, n=3)
    with pytest.raises(ValueError, match="KV heads"):
        _jgroup(pair, n=3)
    # a block that does not divide the device list is refused
    with pytest.raises(ValueError, match="does not divide"):
        serving_shard_devices(2, group_size=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="does not divide"):
        jmesh.serving_shard_devices(2, group_size=3)


def test_group_rejects_single_device_spec_and_fused_verify(pair):
    with pytest.raises(ValueError, match=">= 2 devices"):
        GroupBatcher(pair[2], devices=["cpu"], **BATCHER_KW)
    with pytest.raises(ValueError, match="speculative"):
        _group(pair, spec=SpecConfig())
    with pytest.raises(ValueError, match="fused_verify"):
        _group(pair, fused_verify=True)
    grp = _group(pair)
    for lane in (grp.run_waves, grp.run_what_if, grp.run_spec):
        with pytest.raises(NotImplementedError):
            lane([])
    jgrp = _jgroup(pair)
    for lane in (jgrp.run_waves, jgrp.run_what_if, jgrp.run_spec):
        with pytest.raises(NotImplementedError):
            lane([])


def test_cluster_refuses_group_plus_spec(pair):
    """The reference's service refuses ``group`` with ``spec``; the port has
    no service, and its cluster refuses the pair when it builds the group
    shards (the reference's ``GroupBatcher`` rule)."""
    from beholder_tpu_torch.cluster.router import ClusterScheduler

    with pytest.raises(ValueError, match="speculative"):
        ClusterScheduler(pair[2], ClusterConfig(group=GroupConfig()), devices=["cpu"] * 4,
                         spec=SpecConfig(), **BATCHER_KW)


# -- device blocks -------------------------------------------------------------


def test_serving_shard_devices_grouping():
    devices = [f"cpu:{i}" for i in range(8)]
    ref = jax.devices()
    assert len(ref) == 8  # the conftest's virtual CPU devices

    def positions(got, table):
        idx = {d: i for i, d in enumerate(table)}
        return [tuple(idx[x] for x in g) if isinstance(g, tuple) else idx[g] for g in got]

    port_table = [torch.device(d) for d in devices]
    for n, size in ((3, 1), (4, 2), (5, 2), (2, 4)):
        got = serving_shard_devices(n, group_size=size, devices=devices)
        want = jmesh.serving_shard_devices(n, group_size=size)
        assert positions(got, port_table) == positions(want, ref)
    assert serving_shard_devices(3, devices=devices) == serving_shard_devices(
        3, group_size=1, devices=devices)
    assert serving_shard_devices(2, group_size=2, devices=["cuda:0"] * 4) == [
        (torch.device("cuda:0"),) * 2] * 2
    with pytest.raises(ValueError):
        serving_shard_devices(1, group_size=16, devices=devices)
    with pytest.raises(ValueError):
        jmesh.serving_shard_devices(1, group_size=16)


# -- default off -----------------------------------------------------------------


def test_group_off_serving_and_exposition_byte_identical(pair):
    """A group-less cluster serves the single batcher's bits, registers
    nothing, and builds plain single-device shards."""
    reqs = [_request(i, horizon=5) for i in range(3)]
    base = _single(pair).run(reqs)
    before = Registry().render()
    port, ref = _cluster(pair, ClusterConfig(n_decode_workers=2))
    got = _run_both(port, ref, reqs)
    assert Registry().render() == before
    _bitwise(got, base)
    for shard in port.shards:
        assert type(shard.batcher) is tsv.ContinuousBatcher
        assert shard.batcher.group is None
        assert shard.pool.name.startswith("decode-")
        assert "g" not in shard.pool.name.split("-")[1]


# -- group == single, bitwise --------------------------------------------------


@pytest.mark.parametrize("cache_dtype", FAMILIES)
def test_group_of_two_stream_bitwise_vs_single(pair, cache_dtype):
    """A group of 2 streams the single batcher's bits in every pool dtype;
    its exported pages are the single pool's bytes; the allocator ends
    where the reference group's does (pristine), and the streams are within
    the band of the reference group's."""
    reqs = [_request(i) for i in range(6)]
    single = _single(pair, cache_dtype=cache_dtype)
    base = single.run(reqs)
    grp = _group(pair, cache_dtype=cache_dtype)
    got = grp.run(reqs)
    _bitwise(got, base)
    jgrp = _jgroup(pair, cache_dtype=_jdtype(cache_dtype))
    _close(got, jgrp.run([_jreq(r) for r in reqs]))
    _pristine(grp)
    _same_alloc(grp.state, jgrp.state)
    ids = torch.arange(grp.num_pages)
    for a, b in zip(_flat(grp.export_pages(ids)), _flat(single.export_pages(ids))):
        assert np.array_equal(a, b)


def test_group_warm_admission_bitwise_with_prefix_cache(pair):
    """Warm admissions on a group run fused over the member pools; the cold
    and warm streams are the single batcher's bits (bf16: cold == hit), the
    hits are the reference group's, and evicting the cache leaves both pools
    pristine."""
    reqs = lambda: [_request(7), _request(7), _request(8)]  # noqa: E731
    single = _single(pair, prefix_cache=PrefixCache(8))
    base = single.run(reqs()) + single.run(reqs())
    grp = _group(pair, prefix_cache=PrefixCache(8))
    got = grp.run(reqs()) + grp.run(reqs())
    _bitwise(got, base)
    jgrp = _jgroup(pair, prefix_cache=JaxPrefixCache(8))
    want = jgrp.run([_jreq(r) for r in reqs()]) + jgrp.run([_jreq(r) for r in reqs()])
    _close(got, want)
    assert grp.prefix_cache.hits > 0
    assert (grp.prefix_cache.hits, grp.prefix_cache.misses) == (
        jgrp.prefix_cache.hits, jgrp.prefix_cache.misses)
    for b in (single, grp):
        b._evict_cached(b.num_pages)
        _pristine(b)


# -- cluster integration ----------------------------------------------------------


def test_group_cluster_colocated_bitwise(pair):
    reqs = [_request(i) for i in range(6)]
    base = _single(pair).run(reqs)
    port, ref = _cluster(pair, ClusterConfig(n_decode_workers=2, group=GroupConfig(size=2)))
    assert [s.pool.name for s in port.shards] == ["decode-g0", "decode-g1"]
    assert [s.pool.name for s in port.shards] == [s.pool.name for s in ref.shards]
    got = _run_both(port, ref, reqs)
    _bitwise(got, base)
    for shard in port.shards:
        _pristine(shard.batcher)


def test_group_handoff_adopts_per_head_slice_bitwise(pair):
    """Disaggregated prefill hands full-head chunks to a group shard, each
    member adopting its head slice: the single batcher's bits, and the
    handoff counters of the reference."""
    reqs = [_request(i) for i in range(6)]
    base = _single(pair).run(reqs)
    port, ref = _cluster(pair, ClusterConfig(n_decode_workers=2, n_prefill_workers=1,
                                             group=GroupConfig(size=2)))
    got = _run_both(port, ref, reqs)
    assert port.transfer.transfers > 0
    t, r = port.transfer, ref.transfer
    assert (t.transfers, t.pages, t.bytes, dict(t.ops_by_plane)) == (
        r.transfers, r.pages, r.bytes, dict(r.ops_by_plane))
    _bitwise(got, base)
    for shard in port.shards:
        _pristine(shard.batcher)


def test_fabric_cross_shard_hit_onto_group_shard_bitwise(pair):
    """A prefix warm on one group shard admits with a fabric hit on the
    other: the export merges the members' heads, the import slices them,
    and the borrowing group streams its local warm hit's bits; the fabric
    counters are the reference's."""
    warm = [_request(100 + i) for i in range(4)]
    shifted = warm[1:] + warm[:1]
    port, ref = _cluster(
        pair,
        ClusterConfig(n_decode_workers=2, route_policy="round_robin", fabric=FabricConfig(),
                      group=GroupConfig(size=2)),
        prefix_cache_factory=lambda: PrefixCache(8),
    )
    _run_both(port, ref, warm)
    local = _run_both(port, ref, warm)
    cross = _run_both(port, ref, shifted)
    fab, jfab = port.fabric, ref.fabric
    assert fab.cross_shard_hits > 0 and fab.pages_fetched > 0
    _bitwise(cross, [local[(i + 1) % len(warm)] for i in range(len(warm))])
    assert (fab.cross_shard_lookups, fab.cross_shard_hits, fab.pages_fetched,
            fab.pins_released, fab.index.outstanding_pins) == (
        jfab.cross_shard_lookups, jfab.cross_shard_hits, jfab.pages_fetched,
        jfab.pins_released, jfab.index.outstanding_pins)
    assert dict(port.transfer.ops_by_plane) == dict(ref.transfer.ops_by_plane)
    assert fab.index.outstanding_pins == 0


def test_whole_group_kill_recovers_bitwise(pair):
    """One fault downs a whole group; its requests recover on the surviving
    group with the single batcher's bits, the survivor's pool ends
    pristine, and the cluster keeps serving."""
    reqs = [_request(i, horizon=5) for i in range(6)]
    base = _single(pair).run(reqs)
    port, ref = _cluster(pair, ClusterConfig(n_decode_workers=2, failover=FailoverConfig(),
                                             group=GroupConfig(size=2)))
    inject_worker_fault(port, WorkerFault("decode-g1", "kill", after_dispatches=1))
    jchaos.inject_worker_fault(ref, jchaos.WorkerFault("decode-g1", "kill", after_dispatches=1))
    got = _run_both(port, ref, reqs)
    assert port.failover.state("decode-g1") == "down"
    assert port.failover.recovered_total > 0
    assert port.failover.recovered_total == ref.failover.recovered_total
    assert dict(port.failover.states) == dict(ref.failover.states)
    _bitwise(got, base)
    _pristine(port.shards[0].batcher)
    _bitwise(_run_both(port, ref, reqs), base)


def test_group_flight_events_carry_member_identities(pair):
    """Each tick-chunk dispatch leaves one ``group.tick`` instant a member,
    as many as the reference's; with no recorder nothing records."""
    fr = FlightRecorder(ring_size=4096)
    grp = _group(pair, flight_recorder=fr)
    reqs = [_request(i) for i in range(3)]
    grp.run(reqs)
    events = [e for e in fr.events() if e["name"] == "group.tick"]
    assert events
    assert {e["args"]["worker"] for e in events} == {"decode-g0.m0", "decode-g0.m1"}
    assert all(e["args"]["members"] == 2 for e in events)
    assert all(e["args"]["collective"] == "concat" for e in events)
    jfr = JaxFlightRecorder(ring_size=4096)
    _jgroup(pair, flight_recorder=jfr).run([_jreq(r) for r in reqs])
    assert len(events) == len([e for e in jfr.events() if e["name"] == "group.tick"])


def test_group_wire_roundtrip_is_full_head_dialect(pair):
    """``export_pages`` from a group merges the members' slices into the
    bytes the single pool exports for the same content (int8: values and
    scales ride raw); importing them into another group puts back each
    member's slice, byte for byte."""
    single = _single(pair, cache_dtype="int8", prefix_cache=PrefixCache(8))
    grp = _group(pair, cache_dtype="int8", prefix_cache=PrefixCache(8))
    reqs = lambda: [_request(3), _request(4)]  # noqa: E731
    single.run(reqs())
    grp.run(reqs())
    ids_s = np.nonzero(single.state.page_ref.numpy())[0]
    ids_g = np.nonzero(grp.state.page_ref.numpy())[0]
    assert ids_s.size > 0 and np.array_equal(ids_s, ids_g)
    exp_s = single.export_pages(torch.as_tensor(ids_s))
    exp_g = grp.export_pages(torch.as_tensor(ids_g))
    for a, b in zip(_flat(exp_s), _flat(exp_g)):
        assert np.array_equal(a, b)
    other = _group(pair, cache_dtype="int8")
    state, dest = other.import_pages(*exp_g, len(ids_g), torch.ones(len(ids_g), dtype=torch.int32))
    other.state = state
    back = other.export_pages(dest[: len(ids_g)])
    for a, b in zip(_flat(back), _flat(exp_g)):
        assert np.array_equal(a, b)
    for layer in other.state.k_pools:
        for m, member in enumerate(layer):
            assert isinstance(member, QuantizedPool)
            assert member.values.is_contiguous() and member.values.shape[1] == 1


# -- the pieces --------------------------------------------------------------------


def _members(pool, n):
    hloc = pool.shape[1] // n
    return tuple(pool[:, m * hloc:(m + 1) * hloc].clone() for m in range(n))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_block_group_forward_concatenates_to_the_full_forward(quant):
    """``Block(group=...)`` over member pools gives the full forward's bits
    (the decode tick and the chunk), and the tick leaves each member pool
    equal to its slice of the full pool: heads concatenated, never summed."""
    torch.manual_seed(0)
    block = Block(64, 8, kv_heads=4, device="cpu")
    for p in block.parameters():
        p.requires_grad_(False)
        p.copy_(torch.randn_like(p) * 0.2)
    slots, n_pages, page = 3, 8, 4
    gen = torch.Generator().manual_seed(1)

    def pool():
        if quant:
            return QuantizedPool(
                torch.randint(-100, 100, (n_pages, 4, 8, page), dtype=torch.int8, generator=gen),
                torch.rand((n_pages, 4, page), generator=gen) * 0.02)
        return torch.randn((n_pages, 4, 8, page), generator=gen).to(torch.bfloat16)

    def split(p, n):
        if isinstance(p, QuantizedPool):
            return tuple(QuantizedPool(v, s) for v, s in zip(_members(p.values, n),
                                                           _members(p.scales, n)))
        return _members(p, n)

    table = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32)
    lens = torch.tensor([5, 0, 7], dtype=torch.int32)
    for n in (2, 4):
        kp, vp = pool(), pool()
        x = torch.randn(slots, 1, 64, generator=gen)
        info = PagedInfo(table, lens, table[torch.arange(slots), (lens // page).long()],
                         lens % page)
        k_m, v_m = split(kp, n), split(vp, n)
        want, (kw, vw) = block(x, cache=(kp, vp, info))
        got, (kg, vg) = block(x, cache=(k_m, v_m, info), group=GroupSpec("tp", n))
        assert torch.equal(got, want)
        for full, members in ((kw, kg), (vw, vg)):
            for part in ((0, 1) if quant else (None,)):
                f = full[part] if part is not None else full
                ms = [mm[part] if part is not None else mm for mm in members]
                assert torch.equal(torch.cat(ms, dim=1), f)
        chunk = ChunkPagedInfo(table, lens, ctx_len=2 * page + 3)
        xc = torch.randn(slots, 3, 64, generator=gen)
        want, kv_want = block(xc, cache=(kw, vw, chunk))
        got, kv_got = block(xc, cache=(kg, vg, chunk), group=GroupSpec("tp", n))
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(kv_got, kv_want))
    with pytest.raises(ValueError, match="paged-only"):
        block(x, group=GroupSpec("tp", 2))


def test_tp_rule_slices_concatenate_back(pair):
    """The megatron rule over the port's ``state_dict`` names: column layers
    split dim 0 of the ``(out, in)`` weight and their bias, row layers dim 1
    (the transpose of the reference's ``_seq_spec_for`` on flax kernels),
    everything else whole; the members' slices concatenate back to the full
    ``state_dict`` bit for bit."""
    _, params, tm = pair
    sd = tm.state_dict()
    ref_specs = path_specs(params, jmesh._seq_spec_for)

    def ref_axis(block, layer, leaf):
        spec = ref_specs["params"][block][layer][leaf] if block else ref_specs["params"][layer][leaf]
        for i, names in enumerate(spec):
            if names is not None:
                return i
        return None

    flax_names = {"weight": "kernel", "bias": "bias"}
    for name, t in sd.items():
        parts = name.split(".")
        got = seq_split_dim(name, t)
        if parts[0] == "blocks":
            layer, leaf = parts[2], parts[3]
            fl = {"ln0": "LayerNorm_0", "ln1": "LayerNorm_1"}.get(layer, layer)
            fleaf = {"weight": "scale"}.get(leaf, leaf) if layer.startswith("ln") else flax_names[leaf]
            want = ref_axis(f"block_{parts[1]}", fl, fleaf)
        else:
            fl = {"ln": "LayerNorm_0"}.get(parts[0], parts[0])
            fleaf = {"weight": "scale"}.get(parts[1], parts[1]) if parts[0] == "ln" else flax_names[parts[1]]
            want = ref_axis(None, fl, fleaf)
        if want is not None and t.ndim == 2:
            want = 1 - want  # (in, out) kernel -> (out, in) weight
        assert got == want, name
    for n in (1, 2):
        mesh, specs = group_mesh(["cpu"] * n), specs_for(sd, seq_spec)
        slices = shard_tensors(sd, specs, mesh)
        for name, t in sd.items():
            dim = seq_split_dim(name, t)
            for m, member in enumerate(slices):
                if dim is None:
                    assert torch.equal(member[name], t)
                else:
                    assert member[name].shape[dim] == t.shape[dim] // n
                    assert member[name].is_contiguous()
        back = unshard_tensors(slices, specs, mesh, "cpu")
        assert back.keys() == sd.keys()
        for name, t in sd.items():
            assert torch.equal(back[name], t)
            assert back[name].dtype == t.dtype
    grp = _group(pair)
    for name, t in grp.model.state_dict().items():
        assert torch.equal(t, sd[name])


def test_group_pools_are_own_contiguous_member_tensors(pair):
    """Each member pool is a contiguous tensor of its own (the kernels take
    pools by data pointer), and the allocator tensors exist once, on member
    0; the fused cold admit over member pools is the single pool's fused
    admit, bit for bit."""
    grp = _group(pair, cache_dtype="fp8")
    ptrs = set()
    for layer in (*grp.state.k_pools, *grp.state.v_pools):
        assert len(layer) == 2
        for member in layer:
            for part in (member.values, member.scales):
                assert part.is_contiguous()
                ptrs.add(part.data_ptr())
    assert len(ptrs) == 2 * 2 * 2 * len(grp.state.k_pools)
    assert grp.transfer_device == grp.devices[0] == grp.state.seq_lens.device
    tm = pair[2]
    feats = torch.randn(2, 16, 7, generator=torch.Generator().manual_seed(3))
    lens = torch.tensor([13, 9], dtype=torch.int32)
    slots_ = torch.tensor([0, 1], dtype=torch.int32)
    full = tsv.init_paged(tm, 16, 8, 2, 4, cache_dtype="fp8")
    pred_a, full = tsv.paged_admit_batch(tm, full, slots_, feats, lens, fused=True)
    pred_b, state = tsv.paged_admit_batch(tm, grp.state, slots_, feats, lens, fused=True,
                                          group=grp.group)
    assert torch.equal(pred_a, pred_b)
    ids = torch.arange(16)
    got = tsv.paged_export_pages(state, ids)
    want = tsv.paged_export_pages(full, ids)
    for a, b in zip(_flat(got), _flat(want)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="fused=True"):
        tsv.paged_admit_with_prefix(tm, state, 0, feats[:1, :8], 5,
                                    torch.tensor([0], dtype=torch.int32), group=grp.group)


def test_group_cluster_drain_and_scale_up_keep_streams(pair):
    """A drain moves a group's resident pages to the other group (exported
    full-head, sliced on import) and its queue with them, as the reference's
    drain does; a group spawned by ``scale_up`` takes the next block and
    serves the same bits."""
    reqs = [_request(30 + i) for i in range(4)]
    base = _single(pair).run(reqs)
    cfg = ClusterConfig(n_decode_workers=2, group=GroupConfig(size=2), failover=FailoverConfig())
    port, ref = _cluster(pair, cfg, prefix_cache_factory=lambda: PrefixCache(8))
    _bitwise(_run_both(port, ref, reqs), base)
    for req in reqs:
        assert port.submit(req).accepted
        assert ref.submit(_jreq(req)).accepted
    outcome = port.drain(0)
    assert outcome == ref.drain(0) and outcome["migrated_pages"] > 0
    drained = port.run_pending()
    _close(drained, ref.run_pending())
    _bitwise(drained, base)
    assert port.scale_up().pool.name == ref.scale_up().pool.name == "decode-g2"
    assert type(port.shards[-1].batcher) is GroupBatcher
    _bitwise(_run_both(port, ref, reqs), base)
    assert dict(port.failover.states) == dict(ref.failover.states)
