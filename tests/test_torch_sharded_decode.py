"""The port's sharded dense serving against the JAX package's
``models/decode.py`` (``cache_shardings``, ``sharded_prefill``,
``sharded_decode_step``, ``sharded_forecast_eta``): streams split over
``dp`` (B/dp a member), and under megatron parameters on a ``(dp, tp)``
mesh the cache heads over ``tp`` as well, with the checks of
``tests/test_decode.py:157-278``.

The JAX side runs as ``tests/test_decode.py`` runs it, jitted over the 8
virtual CPU devices of ``tests/conftest.py``; the port runs the same meshes
on ``["cpu"] * 8``. Both carry the reference's initial params (the bridge),
and the observed streams come from numpy seeds. Tolerances, with their
reasons:

- shard shapes, the cache specs and the write index: exact;
- prefill + decode rollouts against the unsharded one and against the
  reference's sharded one: the reference's band, rtol 2e-2 / atol 5e-3
  (``tests/test_decode.py:207-212``: bf16 products in other accumulation
  orders);
- ``eta`` and ``reached``: exactly the port's unsharded ``forecast_eta``'s
  (the reference asserts its own equality), and exactly the reference's
  sharded ones at targets that lie farther from every forecast value than
  the two sides' forecasts lie from each other (as
  ``tests/test_torch_obs.py::test_forecast_eta_matches_the_reference``
  chooses them), so a crossing cannot flip on rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from beholder_tpu.models.decode import forecast_deltas as jax_forecast_deltas
from beholder_tpu.models.decode import sharded_decode_step as jax_sharded_decode_step
from beholder_tpu.models.decode import sharded_forecast_eta as jax_sharded_forecast_eta
from beholder_tpu.models.decode import sharded_prefill as jax_sharded_prefill
from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxModel
from beholder_tpu.models.sequence import init_seq_state as jax_init_seq_state
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu.parallel import seq_state_shardings as jax_seq_state_shardings
from beholder_tpu_torch.models import (
    TelemetrySequenceModel,
    cache_shardings,
    decode_step,
    forecast_deltas,
    forecast_eta,
    prefill,
    serving_params,
    sharded_decode_step,
    sharded_forecast_eta,
    sharded_prefill,
    stream_features,
)
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.parallel import Mesh, seq_state_shardings

B, T, SPLIT, CONVERTING = 8, 24, 12, 2
BAND = dict(rtol=2e-2, atol=5e-3)
LAYOUTS = {"dp8": ((8,), ("dp",)), "dp4-tp2": ((4, 2), ("dp", "tp"))}



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port side runs many small ops, one a member: with torch's
    intra-op threads spinning beside the suite's other workers they ran up
    to 40x slower on a loaded host, so this module's tests take one thread,
    and give the count back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def setup():
    """The reference's test model and params (``tests/test_decode.py:146``),
    the port's model carrying them, and 8 observed streams."""
    jmodel = JaxModel(dim=32, heads=2, layers=2)
    state, _, _ = jax_init_seq_state(jax.random.PRNGKey(0), T, model=jmodel)
    model = TelemetrySequenceModel(dim=32, heads=2, layers=2, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, state.params))
    rng = np.random.default_rng(1)
    prog = np.cumsum(2.0 + rng.normal(0, 0.3, (B, T + 1)), axis=-1).astype(np.float32)
    stats = np.full((B, T + 1), CONVERTING, np.int32)
    return jmodel, state.params, model, prog, stats


def _meshes(layout):
    shape, names = LAYOUTS[layout]
    port = Mesh(np.full(shape, "cpu", dtype=object).tolist(), names)
    return port, JaxMesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


def _megatron(layout, model, jparams, mesh, jmesh):
    """The port's and the reference's parameter specs: megatron on a tp
    mesh, replicated (None) on the dp one."""
    if "tp" not in mesh.axis_names:
        return None, None
    return seq_state_shardings(model, mesh), jax_seq_state_shardings(jparams, jmesh)


def _unsharded_rollout(model, feats):
    with torch.no_grad():
        _, cache = prefill(model, feats[:, :SPLIT], T)
        preds = []
        for i in range(SPLIT, T):
            p, cache = decode_step(model, cache, feats[:, i])
            preds.append(p)
    return torch.stack(preds)


def test_sharded_cache_lives_dp_sharded(setup):
    """Each member holds only its (B/dp, Hkv, max_len, Dh) slice of every
    layer's cache, in and out of a decode step, as the reference's shards
    do; the predictions cover the whole batch."""
    jmodel, jparams, model, prog, stats = setup
    mesh, jmesh = _meshes("dp8")
    feats, _ = stream_features(torch.from_numpy(prog), torch.from_numpy(stats))
    max_len = 40
    params = serving_params(model, mesh)
    last, cache = sharded_prefill(model, mesh, max_len)(params, feats)
    assert cache_shardings(model, mesh).keys[0] == ("dp", None, None, None)
    assert len(cache.keys[0]) == 8
    assert {tuple(k.shape) for k in cache.keys[0]} == {(1, 2, max_len, 16)}
    jfeats, _ = jax_stream_features(jnp.asarray(prog), jnp.asarray(stats))
    _, jcache = jax_sharded_prefill(jmodel, jmesh, max_len)(jparams, jfeats)
    assert {tuple(s.data.shape) for s in jcache.keys[0].addressable_shards} == {(1, 2, max_len, 16)}
    assert int(cache.index) == int(jcache.index) == T
    pred, cache2 = sharded_decode_step(model, mesh)(params, cache, feats[:, -1])
    assert pred.shape == last.shape == (B,)
    assert {tuple(k.shape) for k in cache2.keys[1]} == {(1, 2, max_len, 16)}
    assert int(cache2.index) == T + 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_decode_matches_unsharded_and_the_reference(setup, layout):
    """prefill + decode steps on dp = 8, and on (4, 2) with megatron params
    (each member (B/dp, Hkv/tp, max_len, Dh) = (2, 1, T, 16)), in the band of
    the unsharded rollout and of the reference's sharded one."""
    jmodel, jparams, model, prog, stats = setup
    mesh, jmesh = _meshes(layout)
    specs, jspecs = _megatron(layout, model, jparams, mesh, jmesh)
    feats, _ = stream_features(torch.from_numpy(prog), torch.from_numpy(stats))
    params = serving_params(model, mesh, specs)
    step = sharded_decode_step(model, mesh, params_shardings=specs)
    _, cache = sharded_prefill(model, mesh, T, params_shardings=specs)(params, feats[:, :SPLIT])
    assert int(cache.index) == SPLIT
    want_shard = (1, 2, T, 16) if layout == "dp8" else (2, 1, T, 16)
    assert {tuple(k.shape) for k in cache.keys[0]} == {want_shard}
    head = "tp" if specs else None
    assert cache_shardings(model, mesh, head_axis=head).values[0] == ("dp", head, None, None)
    got = []
    for i in range(SPLIT, T):
        p, cache = step(params, cache, feats[:, i])
        got.append(p)
    got = torch.stack(got).numpy()
    np.testing.assert_allclose(got, _unsharded_rollout(model, feats).numpy(), **BAND)

    jfeats, _ = jax_stream_features(jnp.asarray(prog), jnp.asarray(stats))
    jp = jax.device_put(jparams, jspecs) if jspecs else jparams
    jpre = jax_sharded_prefill(jmodel, jmesh, T, params_shardings=jspecs)
    jstep = jax_sharded_decode_step(jmodel, jmesh, params_shardings=jspecs)
    _, jcache = jpre(jp, jfeats[:, :SPLIT])
    assert {tuple(s.data.shape) for s in jcache.keys[0].addressable_shards} == {want_shard}
    want = []
    for i in range(SPLIT, T):
        p, jcache = jstep(jp, jcache, jfeats[:, i])
        want.append(np.asarray(p))
    np.testing.assert_allclose(got, np.stack(want), **BAND)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_forecast_eta_matches(setup, layout):
    """``eta`` / ``reached`` through the mesh: exactly the unsharded
    ``forecast_eta``'s at targets away from both sides' forecasts (crossings
    both reached and missed), and the reference's sharded ones at the middle
    target, where some streams reach it and some do not."""
    jmodel, jparams, model, prog, stats = setup
    mesh, jmesh = _meshes(layout)
    specs, jspecs = _megatron(layout, model, jparams, mesh, jmesh)
    params = serving_params(model, mesh, specs)
    jp = jax.device_put(jparams, jspecs) if jspecs else jparams
    horizon = 12
    tprog, tstats = torch.from_numpy(prog), torch.from_numpy(stats).long()
    td = forecast_deltas(model, tprog, tstats, horizon).numpy()
    jd = np.asarray(jax_forecast_deltas(jmodel, jparams, jnp.asarray(prog), jnp.asarray(stats),
                                        horizon))
    t_future = prog[:, -1:] + np.cumsum(td, axis=-1)
    j_future = prog[:, -1:] + np.cumsum(jd, axis=-1)
    drift = float(np.abs(j_future - t_future).max())
    values = np.sort(np.concatenate([j_future.ravel(), t_future.ravel()]))
    gaps = np.diff(values)
    targets = [float(v) for v, gap in zip(values[:-1] + gaps / 2, gaps) if gap > 2 * drift + 1e-3]
    targets = targets[:: max(1, len(targets) // 4)] + [float(values[-1]) + 1.0, 100.0]
    reached_any = missed_any = False
    for target in targets:
        eta, reached = sharded_forecast_eta(model, mesh, horizon, target,
                                            params_shardings=specs)(params, tprog, tstats)
        want_eta, want_reached = forecast_eta(model, tprog, tstats, horizon, target)
        assert torch.equal(eta, want_eta) and torch.equal(reached, want_reached), target
        reached_any |= bool(reached.any())
        missed_any |= bool((~reached).any())
    # the reference compiles one program a target: hold it at the middle one
    target = targets[len(targets) // 2]
    eta, reached = sharded_forecast_eta(model, mesh, horizon, target,
                                        params_shardings=specs)(params, tprog, tstats)
    j_eta, j_reached = jax_sharded_forecast_eta(jmodel, jmesh, horizon, target,
                                                params_shardings=jspecs)(
        jp, jnp.asarray(prog), jnp.asarray(stats))
    np.testing.assert_array_equal(eta.numpy(), np.asarray(j_eta), err_msg=f"{target}")
    np.testing.assert_array_equal(reached.numpy(), np.asarray(j_reached))
    assert 0 < int(reached.sum()) < B, target
    assert reached_any and missed_any


def test_head_sharding_follows_the_params(setup):
    """The cache heads split over tp only when the params do: replicated
    params on a (4, 2) mesh keep whole heads a member (each tp member a
    replica of its rows), in the unsharded rollout's band; tp that does not
    divide the kv heads raises the reference's ValueError."""
    _, _, model, prog, stats = setup
    mesh, _ = _meshes("dp4-tp2")
    feats, _ = stream_features(torch.from_numpy(prog), torch.from_numpy(stats))
    params = serving_params(model, mesh)
    last, cache = sharded_prefill(model, mesh, T)(params, feats[:, :SPLIT])
    assert {tuple(k.shape) for k in cache.keys[0]} == {(2, 2, T, 16)}
    with torch.no_grad():
        want, _ = prefill(model, feats[:, :SPLIT], T)
    np.testing.assert_allclose(last.numpy(), want.numpy(), **BAND)

    mqa = TelemetrySequenceModel(dim=32, heads=2, kv_heads=1, layers=2, device="cpu")
    with pytest.raises(ValueError, match="kv heads"):
        cache_shardings(mqa, mesh, head_axis="tp")
    with pytest.raises(ValueError, match="kv heads"):
        sharded_prefill(mqa, mesh, T, params_shardings=seq_state_shardings(mqa, mesh))
