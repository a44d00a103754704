"""The port's parallel stack against the JAX package: the named-axis mesh,
the sharding rules, the collectives, and the sharded training steps (the
anomaly MLP on dp x tp; the transformer on dp x tp, with ``seq_shard``, on
dp x tp x sp with ring attention, and Ulysses under tp).

The JAX side runs as ``tests/test_parallel.py`` runs it, jitted over the 8
virtual CPU devices of ``tests/conftest.py``; the port runs the same meshes
on ``["cpu"] * 8``, one process holding every member. Both start from the
same state: the reference's initial params after one unsharded Adam step,
params and optax moments carried over by the bridge, so the compared step
is an Adam step with live moments. Inputs come from numpy seeds.
Tolerances, with their reasons:

- losses: the reference's band for a sharded step against the unsharded
  one, ``tests/test_parallel.py:67`` and ``:164`` (rel 2e-2): the
  reference rounds each tp member's row-layer partial product to bf16
  before the sum, the port sums the f32 partials and rounds once, and the
  reference's step is jitted (XLA skips bf16 roundings that the port, like
  flax's op order, makes);
- parameters after the step: ``tests/test_parallel.py:68`` for the MLP
  (rtol 2e-2, atol 1e-4) and ``:169-177`` for the transformer's kernels
  (rtol 2e-2, atol 5e-3). At lr 1e-3 that band is wider than one update,
  and Adam hardly depends on the gradient's scale, so it cannot see a
  wrong gradient sum;
- the gradients the sharded step reduced and applied, leaf by leaf,
  against the unsharded port step's and against the reference's sharded
  step's (read off its Adam first moments): rel 2e-2, the sharded-step
  band of ``tests/test_parallel.py:67``, each leaf's error taken against
  the larger of its norm and its even share of the whole gradient
  (:func:`_leaf_errors`); read here: at most 3.5e-3 against the port,
  1.1e-2 against the reference. A step that drops the 1/dp weighting, or
  a ``gather_from_members`` backward that sums, is off by O(1);
- spec rules, shard shapes, the shard round trip and the dp replicas:
  exact;
- Ulysses and ring attention against ``full_attention``: the reference's
  context-parallel band, ``tests/test_attention.py:47`` (rtol 2e-4, atol
  2e-5), in f32;
- the collectives' gradients: ``torch.autograd.gradcheck`` in f64 at its
  default tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.tree_util import tree_flatten_with_path

from beholder_tpu.models import anomaly as jax_anomaly
from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxSeqModel
from beholder_tpu.models.sequence import init_seq_state as jax_init_seq_state
from beholder_tpu.models.sequence import seq_train_step as jax_seq_train_step
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu.parallel import make_mesh as jax_make_mesh
from beholder_tpu.parallel import mesh as jax_mesh_mod
from beholder_tpu_torch.models import (
    ProgressAnomalyModel,
    TelemetrySequenceModel,
    seq_train_step,
    stream_features,
)
from beholder_tpu_torch.models.anomaly import train_step
from beholder_tpu_torch.models.bridge import flax_named, load_flax_params, load_optax_adam
from beholder_tpu_torch.models.train import init_state
from beholder_tpu_torch.ops.attention import full_attention, sequence_sharding, ulysses_attention
from beholder_tpu_torch.parallel import (
    Mesh,
    collectives,
    gather_state,
    group_mesh,
    make_mesh,
    place_seq_state,
    place_state,
    seq_state_shardings,
    sharded_seq_train_step,
    sharded_train_step,
    state_shardings,
)
from beholder_tpu_torch.parallel.sharding import shard_tensors, unshard_tensors

CPU8 = ["cpu"] * 8
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cpu_mesh(shape, names):
    return Mesh(np.full(shape, "cpu", dtype=object).tolist(), names)


def _jax_mesh(shape, names):
    return JaxMesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


#: the band of a sharded step's reduced gradients, leaf by leaf
#: (:func:`_leaf_errors`), against the port's unsharded step and against the
#: reference's sharded step: the reference's sharded-step band,
#: ``tests/test_parallel.py:67`` (rel 2e-2)
GRAD_BAND = 2e-2


def _leaf_errors(got: dict, want: dict) -> dict:
    """Per leaf, ``|got - want| / max(|want|, |W| * sqrt(n / N))`` in norms
    (``W`` every leaf of ``want``, ``N`` its size, ``n`` the leaf's): the
    relative error, or, for a leaf whose part is smaller than its even share
    of the whole (attention's q/k gradients at near-uniform attention, a k
    bias's zero gradient), the error against that share, so that rounding
    noise in a vanishing leaf is not magnified into a failure."""
    total = torch.sqrt(sum(w.double().norm() ** 2 for w in want.values())).item()
    n_all = sum(w.numel() for w in want.values())
    return {name: (got[name] - w).norm().item()
            / max(w.norm().item(), total * (w.numel() / n_all) ** 0.5)
            for name, w in want.items()}


def _sharded_grads(sstate) -> dict:
    """The whole gradients a sharded (or ZeRO) step applied: each member's
    reduced gradient put back together like its leaf."""
    grads = [{n: t.grad for n, t in m.items()} for m in sstate.members]
    return unshard_tensors(grads, sstate.specs, sstate.mesh, "cpu")


def _jax_grads(model, opt_before, opt_after, b1: float = 0.9) -> dict:
    """The gradients the reference's step applied, from its Adam first
    moments (``mu' = b1 * mu + (1 - b1) * g``), in the port's names."""
    def mu(opt):
        parts = (opt,) if hasattr(opt, "mu") else tuple(opt)
        return flax_named(model, next(p for p in parts if hasattr(p, "mu")).mu)

    before, after = mu(opt_before), mu(opt_after)
    return {n: (after[n] - b1 * before[n]) / (1 - b1) for n in before}


def _check_grads(sstate, plain, jax_grads: dict) -> None:
    """The sharded step's gradients against the unsharded step's and the
    reference's sharded step's, within :data:`GRAD_BAND`."""
    got = _sharded_grads(sstate)
    for want in ({n: p.grad for n, p in plain.model.named_parameters()}, jax_grads):
        err = _leaf_errors(got, want)
        worst = max(err, key=err.get)
        assert err[worst] <= GRAD_BAND, (worst, err[worst])


# -- the mesh -------------------------------------------------------------------


def test_make_mesh_and_named_axes():
    """``make_mesh`` as the reference's (``tests/test_parallel.py:28-38``),
    over the devices given; the mesh's groups, sub-meshes and coordinates."""
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.axis_names == ("dp", "tp") and mesh.shape == {"dp": 4, "tp": 2}
    assert jax_make_mesh(8).devices.shape == tuple(mesh.shape.values())
    assert make_mesh(8, tp=1, devices=CPU8).shape == {"dp": 8, "tp": 1}
    with pytest.raises(ValueError):
        make_mesh(8, tp=3, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(100, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)
    assert Mesh(["cpu"] * 4).axis_names == ("sp",)
    mesh3 = _cpu_mesh((2, 2, 2), ("dp", "tp", "sp"))
    assert mesh3.coords()[5] == (1, 0, 1)
    assert mesh3.groups("tp") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert mesh3.groups("dp", "sp") == [[0, 1, 4, 5], [2, 3, 6, 7]]
    ring = mesh3.axis_mesh("sp", {"dp": 1, "tp": 1})
    assert ring.axis_names == ("sp",) and ring.size == 2
    assert mesh3.take(dp=0).shape == {"tp": 2, "sp": 2}
    g = group_mesh(("cpu", "cpu"))
    assert g.shape == {"dp": 1, "tp": 2}
    with pytest.raises(ValueError):
        Mesh([["cpu"] * 2] * 2, ("dp",))


# -- spec rules -----------------------------------------------------------------


def _port_name(path) -> tuple[str, bool]:
    """A flax leaf path as the port's parameter name, and whether the leaf
    is a Dense kernel (transposed in the port)."""
    keys = [str(getattr(p, "key", getattr(p, "name", ""))) for p in path]
    keys = [k for k in keys if k not in ("params", "0", "mu", "nu")]
    rename = {"LayerNorm_0": "ln0", "LayerNorm_1": "ln1", "kernel": "weight",
              "scale": "weight"}
    if keys[0].startswith("block_"):
        keys = ["blocks", keys[0][6:]] + keys[1:]
    elif keys[0] == "LayerNorm_0":
        keys = ["ln"] + keys[1:]
    kernel = keys[-1] == "kernel"
    return ".".join(rename.get(k, k) for k in keys), kernel


def _jax_specs(tree):
    """{port name: spec as a full tuple in the port's layout}."""
    out = {}
    leaves = tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in leaves[0]:
        if not isinstance(spec, jax.sharding.PartitionSpec):
            continue
        name, kernel = _port_name(path)
        spec = tuple(spec)
        out[name] = (spec[::-1] if kernel else spec)
    return out


def _full(spec, ndim):
    """A spec padded to one entry a dim (``()`` is all None)."""
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("which", ["mlp", "seq", "seq-gqa"])
def test_spec_rules_match_the_reference(which):
    """Every leaf's split, params and Adam moments, against the reference's
    ``state_shardings`` / ``seq_state_shardings`` (flax kernels are the
    transpose of the port's weights)."""
    mesh = make_mesh(8, devices=CPU8)
    jmesh = jax_make_mesh(8)
    if which == "mlp":
        jstate, _ = jax_anomaly.init_train_state(jax.random.PRNGKey(0))
        model = ProgressAnomalyModel(device="cpu")
        want = jax_mesh_mod.state_shardings(jstate, jmesh)
        got = state_shardings(init_state(model), mesh)
    else:
        kw = dict(dim=32, heads=4, layers=2, kv_heads=2 if which == "seq-gqa" else None)
        jstate, _, _ = jax_init_seq_state(jax.random.PRNGKey(0), 16, model=JaxSeqModel(**kw))
        model = TelemetrySequenceModel(**kw, device="cpu")
        want = jax_mesh_mod.seq_state_shardings(jstate, jmesh)
        got = seq_state_shardings(init_state(model), mesh)
    shapes = {n: p.ndim for n, p in model.named_parameters()}
    params = _jax_specs(jax.tree.map(lambda s: s.spec, want.params))
    moments = _jax_specs(jax.tree.map(lambda s: s.spec, want.opt_state[0].mu))
    assert set(params) == set(got) == set(moments)
    for name, spec in got.items():
        assert _full(spec, shapes[name]) == _full(params[name], shapes[name]), name
        assert _full(moments[name], shapes[name]) == _full(params[name], shapes[name]), name


@pytest.mark.parametrize("layout", ["mlp-dp-tp", "seq-dp-tp-sp", "seq-dp-tp"])
def test_flax_to_sharded_round_trip_is_bitwise(layout):
    """flax params and optax moments -> port -> members -> whole again: bit
    for bit, and each member's slice has the shape its spec gives."""
    if layout == "mlp-dp-tp":
        jstate, tx = jax_anomaly.init_train_state(jax.random.PRNGKey(1))
        model, mesh = ProgressAnomalyModel(device="cpu"), make_mesh(8, devices=CPU8)
        place = place_state
    else:
        kw = dict(dim=32, heads=4, layers=2, kv_heads=2)
        jstate, tx, _ = jax_init_seq_state(jax.random.PRNGKey(1), 16, model=JaxSeqModel(**kw))
        model = TelemetrySequenceModel(**kw, device="cpu")
        mesh = (_cpu_mesh((2, 2, 2), ("dp", "tp", "sp")) if layout == "seq-dp-tp-sp"
                else make_mesh(8, devices=CPU8))
        place = place_seq_state
    # a state with live moments: one optax step's worth, made up from a seed
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), jstate.params)
    _, opt = tx.update(grads, jstate.opt_state, jstate.params)
    load_flax_params(model, _np(jstate.params))
    state = load_optax_adam(init_state(model, LR), _np(opt))
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_mu = flax_named(model, _np(opt[0].mu))
    sstate = place(state, mesh)
    if layout == "mlp-dp-tp":
        assert tuple(sstate.members[0]["in_proj.weight"].shape) == (64, 112)
        assert tuple(sstate.members[0]["mid_proj.weight"].shape) == (128, 64)
    else:
        assert tuple(sstate.members[0]["blocks.0.q_proj.weight"].shape) == (16, 32)
        assert tuple(sstate.members[0]["blocks.0.k_proj.weight"].shape) == (8, 32)
        assert tuple(sstate.members[0]["blocks.0.down.weight"].shape) == (32, 64)
    back = gather_state(sstate)
    for name, p in back.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
        assert torch.equal(back.optimizer.state[p]["exp_avg"], want_mu[name]), name
    # the helpers alone, on Adam moments keyed the same way
    members = shard_tensors(want_mu, sstate.specs, mesh)
    again = unshard_tensors(members, sstate.specs, mesh, "cpu")
    assert all(torch.equal(again[n], want_mu[n]) for n in want_mu)


# -- collectives ----------------------------------------------------------------


def _f64(*shape, n=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)
            for _ in range(n)]


@pytest.mark.parametrize("op,kw,shape", [
    ("all_reduce", {}, (3, 4)),
    ("all_gather", {"dim": 1}, (2, 3)),
    ("reduce_scatter", {"dim": 0}, (8, 3)),
    ("all_to_all", {"split_dim": 0, "concat_dim": 1}, (4, 2)),
    ("ring_shift", {"shift": 1}, (3,)),
    ("ring_shift", {"shift": -2}, (2, 2)),
])
def test_collective_gradients_are_adjoints(op, kw, shape):
    """Each collective's backward is its forward's adjoint (gradcheck, f64)."""
    fn = getattr(collectives, op)
    xs = _f64(*shape)
    assert torch.autograd.gradcheck(lambda *a: tuple(fn(list(a), **kw)), xs)


def test_megatron_conjugate_pair():
    """*g* (tp_all_reduce): sum forward, identity backward; *f*
    (tp_replicate): identity forward, sum backward; and the split pair
    around replicated work."""
    xs = _f64(3, n=2)
    ys = collectives.tp_all_reduce(xs)
    torch.testing.assert_close(ys[0], xs[0] + xs[1])
    torch.autograd.backward(ys, [torch.ones(3, dtype=torch.float64) * (i + 1) for i in range(2)])
    assert torch.equal(xs[0].grad, torch.ones(3, dtype=torch.float64))
    assert torch.equal(xs[1].grad, 2 * torch.ones(3, dtype=torch.float64))
    xs = _f64(3, n=2)
    ys = collectives.tp_replicate(xs)
    assert all(torch.equal(y, x) for y, x in zip(ys, xs))
    torch.autograd.backward(ys, [torch.ones(3, dtype=torch.float64) * (i + 1) for i in range(2)])
    assert torch.equal(xs[0].grad, 3 * torch.ones(3, dtype=torch.float64))
    whole = torch.arange(8.0, dtype=torch.float64).reshape(4, 2).requires_grad_()
    parts = collectives.scatter_to_members([whole, whole], dim=0)
    assert torch.equal(parts[1], whole[2:])
    back = collectives.gather_from_members(parts, dim=0)
    assert torch.equal(back[0], whole)
    # each member back-propagates its own copy: every member's input gets
    # the whole cotangent (here the same tensor twice)
    (back[0].sum() + back[1].sum()).backward()
    assert torch.equal(whole.grad, 2 * torch.ones(4, 2, dtype=torch.float64))


# -- the anomaly MLP on dp x tp ---------------------------------------------------


@pytest.fixture(scope="module")
def mlp_reference():
    rng = np.random.default_rng(7)
    progress = np.cumsum(1.0 + rng.normal(0, 0.05, 256)).clip(0)
    statuses = np.full(256, 2)
    windows, targets = jax_anomaly.make_windows(jnp.asarray(progress), jnp.asarray(statuses))
    n = (windows.shape[0] // 8) * 8
    windows, targets = windows[:n], targets[:n]
    state, tx = jax_anomaly.init_train_state(jax.random.PRNGKey(0))
    step = jax.jit(lambda s, w, t: jax_anomaly.train_step(s, tx, w, t))
    state, _ = step(state, windows, targets)
    jmesh = jax_make_mesh(8)
    sstep = jax_mesh_mod.sharded_train_step(tx, jmesh, state)
    out_state, loss = sstep(jax_mesh_mod.place_state(state, jmesh), windows, targets)
    _, ref_loss = step(state, windows, targets)
    return dict(windows=np.array(windows), targets=np.array(targets),
                params=_np(state.params), opt=_np(state.opt_state), loss=float(loss),
                ref_loss=float(ref_loss), after=_np(out_state.params),
                after_opt=_np(out_state.opt_state))


def test_mlp_sharded_step_matches_jax_and_unsharded(mlp_reference):
    r = mlp_reference
    windows, targets = torch.from_numpy(r["windows"]), torch.from_numpy(r["targets"])

    def state():
        m = load_flax_params(ProgressAnomalyModel(device="cpu"), r["params"])
        return load_optax_adam(init_state(m, LR), r["opt"])

    sstate, loss = sharded_train_step(place_state(state(), make_mesh(8, devices=CPU8)),
                                      windows, targets)
    plain, plain_loss = train_step(state(), windows, targets)
    _check_grads(sstate, plain, _jax_grads(plain.model, r["opt"], r["after_opt"]))
    assert loss.item() == pytest.approx(r["loss"], rel=2e-2)
    assert loss.item() == pytest.approx(plain_loss.item(), rel=2e-2)
    assert r["loss"] == pytest.approx(r["ref_loss"], rel=2e-2)
    # every dp replica of every slice bitwise equal
    for i, c in enumerate(sstate.mesh.coords()):
        for name, leaf in sstate.members[i].items():
            twin = sstate.members[sstate.mesh.coords().index((0, c[1]))][name]
            assert torch.equal(leaf, twin), (c, name)
    got = gather_state(sstate).model
    want = flax_named(got, r["after"])
    np.testing.assert_allclose(got.in_proj.weight.detach().numpy(), want["in_proj.weight"].numpy(),
                               rtol=2e-2, atol=1e-4)
    np.testing.assert_allclose(got.in_proj.weight.detach().numpy(),
                               plain.model.in_proj.weight.detach().numpy(), rtol=2e-2, atol=1e-4)


# -- the transformer ----------------------------------------------------------------

#: (mesh shape, axis names, model kwargs) — the reference's tests: dp x tp
#: (test_parallel.py:128), seq_shard on tp=4 (:195), dp x tp x sp ring +
#: seq_shard (:261), Ulysses under tp (:307), and Ulysses with GQA kv heads
#: that broadcast inside each member (the chip's headline rule)
SEQ_CASES = {
    "dp-tp": ((4, 2), ("dp", "tp"), dict(dim=32, heads=4, layers=2)),
    "seq-shard-tp4": ((2, 4), ("dp", "tp"), dict(dim=64, heads=4, layers=2, seq_shard=True)),
    "dp-tp-sp-ring": ((2, 2, 2), ("dp", "tp", "sp"),
                      dict(dim=32, heads=4, layers=2, attention="ring", seq_shard=True)),
    "ulysses-tp": ((2, 2, 2), ("dp", "tp", "sp"), dict(dim=32, heads=4, layers=1,
                                                      attention="ulysses")),
    "ulysses-gqa": ((2, 2, 2), ("dp", "tp", "sp"),
                    dict(dim=32, heads=4, kv_heads=2, layers=1, attention="ulysses",
                         seq_shard=True)),
}


@pytest.fixture(scope="module")
def seq_data():
    rng = np.random.default_rng(3)
    t = 32
    prog = np.cumsum(1.5 + rng.normal(0, 0.1, (8, t + 1)), axis=-1)
    stats = np.full((8, t + 1), 2)
    return prog, stats


@pytest.fixture(scope="module")
def seq_reference(seq_data):
    """Per case: the reference's state after one unsharded step (params and
    moments), then its sharded step from there (loss, params)."""
    prog, stats = seq_data
    feats, targets = jax_stream_features(jnp.asarray(prog), jnp.asarray(stats))
    out = {}

    def run(case):
        if case in out:
            return out[case]
        shape, names, kw = SEQ_CASES[case]
        jmesh = _jax_mesh(shape, names)
        base_kw = {k: v for k, v in kw.items() if k not in ("attention", "seq_shard")}
        base = JaxSeqModel(**base_kw)
        state, tx, _ = jax_init_seq_state(jax.random.PRNGKey(0), feats.shape[1], model=base)
        step = jax.jit(lambda s, f, t: jax_seq_train_step(base, tx, s, f, t))
        state, _ = step(state, feats, targets)
        _, ref_loss = step(state, feats, targets)
        mesh_kw = {"mesh": jmesh} if "attention" in kw or kw.get("seq_shard") else {}
        model = JaxSeqModel(**kw, **mesh_kw)
        sstep = jax_mesh_mod.sharded_seq_train_step(model, tx, jmesh, state)
        sh_state, loss = sstep(jax_mesh_mod.place_seq_state(state, jmesh), feats, targets)
        out[case] = dict(params=_np(state.params), opt=_np(state.opt_state), loss=float(loss),
                         ref_loss=float(ref_loss), after=_np(sh_state.params),
                         after_opt=_np(sh_state.opt_state))
        return out[case]

    return run


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_seq_sharded_step_matches_jax(case, seq_data, seq_reference):
    """One sharded Adam step (live moments) against the reference's sharded
    step and against the port's unsharded step; shard shapes; dp (and sp,
    and unsplit-tp) replicas bitwise."""
    r = seq_reference(case)
    shape, names, kw = SEQ_CASES[case]
    mesh = _cpu_mesh(shape, names)
    feats, targets = stream_features(*(torch.from_numpy(a) for a in seq_data))

    def state(**extra):
        m = TelemetrySequenceModel(**extra, device="cpu")
        load_flax_params(m, r["params"])
        return load_optax_adam(init_state(m, LR), r["opt"])

    mkw = {**kw, "mesh": mesh} if "attention" in kw else kw
    sstate, loss = sharded_seq_train_step(place_seq_state(state(**mkw), mesh), feats, targets)
    base_kw = {k: v for k, v in kw.items() if k not in ("attention", "seq_shard")}
    plain, plain_loss = seq_train_step(state(**base_kw), feats, targets)
    _check_grads(sstate, plain, _jax_grads(plain.model, r["opt"], r["after_opt"]))
    assert np.isfinite(loss.item())
    assert loss.item() == pytest.approx(r["loss"], rel=2e-2)
    assert loss.item() == pytest.approx(plain_loss.item(), rel=2e-2)
    assert r["loss"] == pytest.approx(r["ref_loss"], rel=2e-2)
    tp = mesh.shape["tp"]
    q = sstate.members[0]["blocks.0.q_proj.weight"]
    assert tuple(q.shape) == (kw["dim"] // tp, kw["dim"])
    coords, k = mesh.coords(), names.index("tp")
    for i, c in enumerate(coords):
        for name, leaf in sstate.members[i].items():
            at = tuple(c[k] if j == k and "tp" in sstate.specs[name] else 0
                       for j in range(len(c)))
            assert torch.equal(leaf, sstate.members[coords.index(at)][name]), (c, name)
    got = gather_state(sstate).model
    want = flax_named(got, r["after"])
    for name, p in got.named_parameters():
        if name.startswith("blocks.0.") and name.endswith("weight") and p.ndim == 2:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=2e-2, atol=5e-3, err_msg=name)
            np.testing.assert_allclose(p.detach().numpy(),
                                       dict(plain.model.named_parameters())[name].detach().numpy(),
                                       rtol=2e-2, atol=5e-3, err_msg=name)


def _saved_bytes_per_member(model_kw, mesh, feats, targets, seed=5):
    """Bytes the forward saves for the backward, over distinct storages,
    divided by the mesh's members."""
    from beholder_tpu_torch.models.bridge import init_params

    model = TelemetrySequenceModel(**model_kw, device="cpu")
    load_flax_params(model, init_params(model, seed))
    sstate = place_seq_state(init_state(model, LR), mesh)
    seen = {}

    def pack(t):
        seen[(t.untyped_storage().data_ptr(), t.dtype)] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.members_loss(sstate.members, feats, targets, mesh)
    return sum(seen.values()) / mesh.size


def test_seq_shard_saves_fewer_bytes_than_plain_tp():
    """The counterpart of ``tests/test_parallel.py:195-258``: with the
    residual stream and LayerNorms as T-slices over tp, each member saves
    fewer bytes for the backward than under plain megatron TP (dim 128, T
    256, tp 4 as there)."""
    rng = np.random.default_rng(9)
    t = 256
    prog = np.cumsum(1.5 + rng.normal(0, 0.1, (8, t + 1)), axis=-1)
    feats, targets = stream_features(torch.from_numpy(prog), torch.full((8, t + 1), 2))
    mesh = make_mesh(8, tp=4, devices=CPU8)
    kw = dict(dim=128, heads=4, layers=2)
    plain = _saved_bytes_per_member(kw, mesh, feats, targets)
    sharded = _saved_bytes_per_member({**kw, "seq_shard": True}, mesh, feats, targets)
    assert sharded < plain, (sharded, plain)


# -- Ulysses ------------------------------------------------------------------------


@pytest.mark.parametrize("shape,names,heads,kv_heads,window", [
    ((4,), ("sp",), 4, 4, None),            # kv exchange at kv-head width
    ((2,), ("sp",), 4, 1, None),            # MQA: kv broadcast inside
    ((2, 2, 2), ("dp", "tp", "sp"), 4, 2, None),  # tp then sp: 1 kv head a member
    ((2, 2), ("tp", "sp"), 4, 1, 5),        # kv heads do not split over tp; window
])
def test_ulysses_matches_full_attention(shape, names, heads, kv_heads, window):
    """Ulysses (whole tensors over the mesh) against ``full_attention``,
    forward and gradients, under the reference's GQA rules."""
    mesh = _cpu_mesh(shape, names)
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, heads, 16, 8, generator=g, requires_grad=True)
    k, v = (torch.randn(2, kv_heads, 16, 8, generator=g, requires_grad=True) for _ in range(2))
    out = ulysses_attention(q, k, v, mesh, causal=True, window=window, backend="full")
    want = full_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-5)
    do = torch.randn(out.shape, generator=g)
    got_g = torch.autograd.grad(out, (q, k, v), do)
    want_g = torch.autograd.grad(want, (q, k, v), do)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    flash = ulysses_attention(q, k, v, mesh, causal=True, window=window)
    torch.testing.assert_close(flash, want, rtol=2e-4, atol=2e-5)


def test_ulysses_checks_like_the_reference():
    mesh = Mesh(["cpu"] * 4)
    x = torch.arange(2 * 16 * 3.0).reshape(2, 16, 3)
    parts = sequence_sharding(mesh, x)
    assert [tuple(p.shape) for p in parts] == [(2, 4, 3)] * 4
    assert torch.equal(torch.cat(parts, dim=-2), x)
    q = torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError, match="heads"):
        ulysses_attention(q, q, q, mesh)
    q = torch.zeros(1, 4, 18, 8)
    with pytest.raises(ValueError, match="sequence length"):
        ulysses_attention(q, q, q, mesh)
    q = torch.zeros(1, 4, 16, 8)
    with pytest.raises(ValueError, match="causal"):
        ulysses_attention(q, q, q, mesh, window=4)
    with pytest.raises(ValueError, match="mesh"):
        TelemetrySequenceModel(dim=32, heads=4, layers=1, attention="ulysses", device="cpu")
    mesh3 = _cpu_mesh((1, 1, 2), ("dp", "tp", "sp"))
    model = TelemetrySequenceModel(dim=32, heads=4, layers=1, device="cpu")
    sstate = place_seq_state(init_state(model, LR), mesh3)
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        sharded_seq_train_step(sstate, torch.zeros(1, 8, 7), torch.zeros(1, 8))
