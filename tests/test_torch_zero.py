"""ZeRO in the port against the JAX package and against the port's own
plain data-parallel step.

The JAX side runs as ``tests/test_zero.py`` runs it, on a ("dp",) mesh of
the 8 virtual CPU devices; the port on ``Mesh([...] * 8, ("dp",))`` of the
CPU. Params and optax moments come over by the bridge, from the reference's
state after one unsharded step. Tolerances, with their reasons:

- spec rules and shard shapes: exact;
- a ZeRO step against the port's plain dp step
  (``sharded_seq_train_step`` on the same 4-member mesh): bitwise, losses,
  parameters and moments, over three steps, stage 2 and 3, with and without
  remat + flash. The gradients are summed in the same member order and
  Adam is elementwise;
- against the reference: the loss within rel 1e-4 of the reference's
  ``seq_loss`` run eagerly at the same params (the dense model's band,
  ``tests/test_torch_train.py``), and within the sharded-step band of
  ``tests/test_parallel.py:67`` (rel 2e-2) of its jitted ZeRO step, since
  XLA's fusions skip bf16 roundings that flax's op order makes (eager
  1.44020, jitted 1.43550 here: 3.3e-3); the parameters after the step
  within ``tests/test_parallel.py:169-177`` (rtol 2e-2, atol 5e-3); the
  gradients the ZeRO step applied against the port's unsharded step's and
  the reference's ZeRO step's, leaf by leaf, rel 2e-2
  (``test_torch_parallel._check_grads``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxSeqModel
from beholder_tpu.models.sequence import init_seq_state as jax_init_seq_state
from beholder_tpu.models.sequence import seq_loss as jax_seq_loss
from beholder_tpu.models.sequence import seq_train_step as jax_seq_train_step
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu.parallel import zero as jax_zero
from beholder_tpu_torch.models import TelemetrySequenceModel, seq_train_step, stream_features
from beholder_tpu_torch.models.bridge import flax_named, init_params, load_flax_params, load_optax_adam
from beholder_tpu_torch.models.train import init_state
from beholder_tpu_torch.parallel import (
    Mesh,
    gather_state,
    place_seq_state,
    place_zero_state,
    sharded_seq_train_step,
    zero_state_specs,
    zero_train_step,
)
from beholder_tpu_torch.parallel.sharding import MIN_SHARD_ELEMENTS, zero_leaf_spec

from test_torch_parallel import _check_grads, _jax_grads

LR = 1e-3
DP = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def dp_mesh():
    return Mesh(["cpu"] * DP, ("dp",))


def _data(batch=8, t=16, seed=0):
    rng = np.random.default_rng(seed)
    prog = np.cumsum(1.0 + rng.normal(0, 0.05, (batch, t + 1)), axis=-1)
    return prog, np.full((batch, t + 1), 2)


@pytest.mark.parametrize("shape", [(3, 64, 128), (64, 32), (31, 51, 7), (8,), (16, 64),
                                   (2, 512), (4, 8, 40)])
@pytest.mark.parametrize("dp", [8, 4])
def test_zero_leaf_spec_matches_the_reference(shape, dp):
    want = tuple(jax_zero.zero_leaf_spec(jnp.zeros(shape), dp))
    want = (want + (None,) * len(shape))[:len(shape)] if want else ()
    assert zero_leaf_spec(torch.zeros(shape), dp) == want
    assert MIN_SHARD_ELEMENTS == jax_zero.MIN_SHARD_ELEMENTS


@pytest.mark.parametrize("shard_params", [False, True])
def test_zero_specs_and_footprint(dp_mesh, shard_params):
    """Stage 2 keeps params whole and cuts the moments; stage 3 cuts both;
    each member holds 1/dp of every cut leaf (``tests/test_zero.py:43-79,
    :112-121``); the large leaves are exactly the reference's."""
    jstate, _, _ = jax_init_seq_state(jax.random.PRNGKey(0), 16,
                                      model=JaxSeqModel(dim=32, heads=2, layers=1))
    jspecs = jax_zero.zero_state_specs(jstate, JaxMesh(np.array(jax.devices()[:DP]), ("dp",)),
                                       shard_params=shard_params)
    model = TelemetrySequenceModel(dim=32, heads=2, layers=1, device="cpu")
    state = init_state(model, LR)
    specs = zero_state_specs(state, dp_mesh, shard_params=shard_params)
    want_cut = sum(1 for s in jax.tree.leaves(jspecs.opt_state[0].mu,
                                              is_leaf=lambda s: isinstance(s, P)) if "dp" in s)
    assert sum(1 for s in specs["moments"].values() if s) == want_cut
    assert any(specs["params"].values()) == shard_params
    zstate = place_zero_state(state, dp_mesh, shard_params=shard_params)
    for name, p in model.named_parameters():
        spec = zstate.specs[name]
        mine = zstate.members[3][name]
        if spec:
            dim = spec.index("dp")
            assert mine.shape[dim] * DP == p.shape[dim] and p.numel() >= MIN_SHARD_ELEMENTS
        else:
            assert mine.shape == p.shape
    assert (zstate.replicas is None) == shard_params


@pytest.mark.parametrize("kw", [{}, dict(attention="flash", remat=True)],
                         ids=["plain", "remat-flash"])
@pytest.mark.parametrize("shard_params", [False, True], ids=["stage2", "stage3"])
def test_zero_is_bitwise_the_plain_dp_step(shard_params, kw):
    """Three ZeRO steps against three plain dp steps on the same (4-member)
    mesh: the same losses, parameters and Adam moments, bit for bit."""
    dp_mesh = Mesh(["cpu"] * 4, ("dp",))
    model_kw = dict(dim=32, heads=2, layers=1, **kw)
    feats, targets = stream_features(*(torch.from_numpy(a) for a in _data(t=32)))
    params = init_params(TelemetrySequenceModel(**model_kw, device="cpu"), 0)

    def state():
        m = TelemetrySequenceModel(**model_kw, device="cpu")
        return init_state(load_flax_params(m, params), LR)

    plain = place_seq_state(state(), dp_mesh)
    zstate = place_zero_state(state(), dp_mesh, shard_params=shard_params)
    for _ in range(3):
        plain, want = sharded_seq_train_step(plain, feats, targets)
        zstate, got = zero_train_step(zstate, feats, targets)
        assert torch.equal(got, want)
    a, b = gather_state(plain), gather_state(zstate)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key], b.optimizer.state[q][key]), (name, key)
    if zstate.replicas is not None:
        for replica in zstate.replicas:
            for name, p in b.model.named_parameters():
                assert torch.equal(replica[name], p), name


@pytest.fixture(scope="module")
def zero_reference():
    """The reference's state after one unsharded step, then its ZeRO step
    (stage 2 and 3) from there: losses and params."""
    prog, stats = _data()
    feats, targets = jax_stream_features(jnp.asarray(prog), jnp.asarray(stats))
    model = JaxSeqModel(dim=32, heads=2, layers=1)
    state, tx, _ = jax_init_seq_state(jax.random.PRNGKey(0), 16, model=model)
    state, _ = jax.jit(lambda s, f, t: jax_seq_train_step(model, tx, s, f, t))(
        state, feats, targets)
    jmesh = JaxMesh(np.array(jax.devices()[:DP]), ("dp",))
    host = _np(state)
    out = dict(prog=prog, stats=stats, params=host.params, opt=host.opt_state,
               eager_loss=float(jax_seq_loss(model, state.params, feats, targets)))
    for shard_params in (False, True):
        # the step donates its input: place a fresh copy each time
        zs = jax_zero.place_zero_state(jax.tree.map(jnp.array, host), jmesh,
                                       shard_params=shard_params)
        step = jax_zero.zero_train_step(tx, jmesh, zs, lambda p, f, t: jax_seq_loss(model, p, f, t),
                                        shard_params=shard_params)
        zs, loss = step(zs, feats, targets)
        out[shard_params] = (float(loss), _np(zs.params), _np(zs.opt_state))
    return out


@pytest.mark.parametrize("shard_params", [False, True], ids=["stage2", "stage3"])
def test_zero_step_matches_jax(zero_reference, dp_mesh, shard_params):
    r = zero_reference
    def state():
        model = TelemetrySequenceModel(dim=32, heads=2, layers=1, device="cpu")
        load_flax_params(model, r["params"])
        return load_optax_adam(init_state(model, LR), r["opt"])

    feats, targets = stream_features(torch.from_numpy(r["prog"]), torch.from_numpy(r["stats"]))
    zstate, loss = zero_train_step(place_zero_state(state(), dp_mesh, shard_params=shard_params),
                                   feats, targets)
    want_loss, want_params, want_opt = r[shard_params]
    plain, _ = seq_train_step(state(), feats, targets)
    _check_grads(zstate, plain, _jax_grads(plain.model, r["opt"], want_opt))
    np.testing.assert_allclose(loss.item(), r["eager_loss"], rtol=1e-4)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=2e-2)
    got = gather_state(zstate).model
    want = flax_named(got, want_params)
    for name, p in got.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=2e-2, atol=5e-3,
                                   err_msg=name)


def test_zero_with_remat_and_flash_trains():
    """The long-context stack together (``tests/test_zero.py:148``): flash
    attention, remat blocks and ZeRO-3 on a 4-member dp mesh, losses finite
    and falling (8 steps here, 15 there)."""
    feats, targets = stream_features(*(torch.from_numpy(a) for a in _data(t=32)))
    model = TelemetrySequenceModel(dim=32, heads=2, layers=2, attention="flash", remat=True,
                                   device="cpu")
    load_flax_params(model, init_params(model, 0))
    zstate = place_zero_state(init_state(model, LR), Mesh(["cpu"] * 4, ("dp",)),
                              shard_params=True)
    losses = []
    for _ in range(8):
        zstate, loss = zero_train_step(zstate, feats, targets)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert min(losses[4:]) < losses[0]
