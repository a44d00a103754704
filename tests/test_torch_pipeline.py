"""The port's pipeline parallelism against the JAX package's
``parallel/pipeline.py``: the GPipe forward and its gradients, the 1F1B
training step (odd microbatch counts, dp x pp, tp inside the stages), the
stage placement, the microbatch split and merge, the bubble, and the
schedule's tick count, with the checks of ``tests/test_pipeline.py``.

The JAX side runs as ``tests/test_pipeline.py`` runs it, over the virtual
CPU devices of ``tests/conftest.py``; the port runs the same meshes on
``["cpu"] * n``, one process driving every stage. Stage parameters and
inputs come from numpy seeds and reach the port through
``models.bridge.flax_stage_params``. Tolerances, with their reasons:

- f32 stages (``tanh(x @ w + b)`` and the megatron ``w1``/``w2`` stage):
  the reference's own, ``tests/test_pipeline.py``: forward atol 1e-5,
  GPipe gradients atol 1e-4, 1F1B loss rtol 1e-5 and gradients atol 1e-5;
- the transformer ``Block`` stages with flash attention (the port's plain
  version, the reference's kernels in interpret mode; bf16 products): the
  dryrun's bands, ``__graft_entry__.py``: the loss within rel 1e-3
  (``_assert_close(..., tol=1e-3)``) and every gradient leaf within
  ``5e-2 * max(1, max|g|)`` (``assert_grads_close``);
- ticks, units, the residual ring's peak, shard shapes and the bubble:
  exact.

The reference's wall-clock test (``tests/test_pipeline.py:447``) has no
counterpart: it times a shared CPU, and the tick counter checks the same
schedule exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from beholder_tpu.models.sequence import Block as JaxBlock
from beholder_tpu.parallel import pipeline as jpipe
from beholder_tpu.parallel import tp_all_reduce as jax_tp_all_reduce
from beholder_tpu.parallel import tp_replicate as jax_tp_replicate
from beholder_tpu_torch.models import TelemetrySequenceModel, pipeline_stages
from beholder_tpu_torch.models.bridge import flax_stage_params
from beholder_tpu_torch.parallel import (
    Mesh,
    bubble_fraction,
    merge_microbatches,
    pipeline_forward,
    pipeline_train_step,
    split_microbatches,
    stack_stage_grads,
    stack_stage_params,
    stage_shardings,
    stage_specs,
    tp_all_reduce,
    tp_replicate,
)

STAGES = 4
DIM = 8


def _cpu_mesh(shape, names):
    return Mesh(np.full(shape, "cpu", dtype=object).tolist(), names)


def _jax_mesh(shape, names):
    return JaxMesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)



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
def meshes():
    return _cpu_mesh((STAGES,), ("pp",)), _jax_mesh((STAGES,), ("pp",))


def _stages(seed, n=STAGES, dim=DIM) -> dict:
    """The reference's stacked ``{"w", "b"}`` stages, numpy from a seed."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(n, dim, dim)) / np.sqrt(dim)).astype(np.float32),
            "b": (rng.normal(size=(n, dim)) * 0.1).astype(np.float32)}


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def j_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def t_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def j_loss(out, y):
    return jnp.mean((out - y) ** 2)


def t_loss(out, y):
    return torch.mean((out - y) ** 2)


def _port(stacked_np: dict) -> dict:
    return flax_stage_params(stacked_np)


def _port_sequential(stacked: dict, x: torch.Tensor, stage=t_stage) -> torch.Tensor:
    for i in range(next(iter(stacked.values())).shape[0]):
        x = stage({n: t[i] for n, t in stacked.items()}, x)
    return x


def _close(got: dict, want: dict, atol: float) -> None:
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].detach().numpy(), np.asarray(want[n]), atol=atol,
                                   err_msg=n)


def _port_step(stacked_np, x, y, mesh, **kw):
    """The port's 1F1B step on the numpy inputs: (loss, stacked grads, stats)."""
    stacked, stats = _port(stacked_np), {}
    loss, grads = pipeline_train_step(t_stage, t_loss, stacked, torch.from_numpy(x),
                                      torch.from_numpy(y), mesh, stats=stats, **kw)
    specs = kw.get("param_specs") or stage_specs(stacked)
    return loss, stack_stage_grads(grads, mesh, specs), stats


def _jax_seq_value_and_grad(stacked_np, x, y):
    def seq_loss(p):
        out = jnp.asarray(x)
        for i in range(p["w"].shape[0]):
            out = j_stage(jax.tree.map(lambda leaf: leaf[i], p), out)
        return jnp.mean(jax.vmap(j_loss)(out, jnp.asarray(y)))

    loss, grads = jax.value_and_grad(seq_loss)(jax.tree.map(jnp.asarray, stacked_np))
    return float(loss), jax.tree.map(np.asarray, grads)


def test_pipeline_matches_sequential_and_the_reference(meshes):
    """M = 6 microbatches through 4 stages: the reference's forward, the
    port's sequential application; M + S - 1 ticks, S * M units."""
    mesh, jmesh = meshes
    stacked_np, x = _stages(0), _normal(1, 6, 5, DIM)
    stats = {}
    got = pipeline_forward(t_stage, _port(stacked_np), torch.from_numpy(x), mesh, stats=stats)
    want = jpipe.pipeline_forward(j_stage, jax.tree.map(jnp.asarray, stacked_np),
                                  jnp.asarray(x), jmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _port_sequential(_port(stacked_np),
                                                             torch.from_numpy(x)).numpy(),
                               atol=1e-5)
    assert stats == {"ticks": 6 + STAGES - 1, "forward_units": 6 * STAGES}


def test_pipeline_single_microbatch(meshes):
    mesh, _ = meshes
    stacked_np, x = _stages(2), _normal(3, 1, 3, DIM)
    got = pipeline_forward(t_stage, _port(stacked_np), torch.from_numpy(x), mesh)
    want = _port_sequential(_port(stacked_np), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_pipeline_gradients_match_the_reference(meshes):
    """GPipe under autograd: the gradients of sum(out**2) equal the
    reference's under ``jax.grad`` (atol 1e-4)."""
    mesh, jmesh = meshes
    stacked_np, x = _stages(4), _normal(5, 8, 2, DIM)
    stacked = {n: t.requires_grad_() for n, t in _port(stacked_np).items()}
    (pipeline_forward(t_stage, stacked, torch.from_numpy(x), mesh) ** 2).sum().backward()
    want = jax.grad(lambda p: jnp.sum(jpipe.pipeline_forward(j_stage, p, jnp.asarray(x), jmesh)
                                      ** 2))(jax.tree.map(jnp.asarray, stacked_np))
    _close({n: t.grad for n, t in stacked.items()}, flax_stage_params(_np(want)), atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam_losses(step_fn, stacked: dict, steps: int = 10) -> list:
    params = {n: t.clone().requires_grad_() for n, t in stacked.items()}
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        losses.append(step_fn(params))
        opt.step()
    return losses


def test_pipeline_training_reduces_loss(meshes):
    """Adam on the GPipe forward's MSE: the loss falls below 0.9 of its
    start; the first loss is the reference's."""
    mesh, jmesh = meshes
    stacked_np, x = _stages(6), _normal(7, 8, 4, DIM)
    y = np.roll(x, 1, axis=-1) * 0.5
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def step(params):
        loss = torch.mean((pipeline_forward(t_stage, params, xt, mesh) - yt) ** 2)
        loss.backward()
        return float(loss.detach())

    losses = _adam_losses(step, _port(stacked_np))
    want0 = jnp.mean((jpipe.pipeline_forward(j_stage, jax.tree.map(jnp.asarray, stacked_np),
                                             jnp.asarray(x), jmesh) - y) ** 2)
    np.testing.assert_allclose(losses[0], float(want0), rtol=1e-5)
    assert losses[-1] < losses[0] * 0.9 and np.isfinite(losses[-1])


def test_microbatch_split_merge_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    mb = split_microbatches(x, 4)
    assert mb.shape == (4, 3, 2)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jpipe.split_microbatches(
        jnp.asarray(x.numpy()), 4)))
    assert torch.equal(merge_microbatches(mb), x)
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches(x, 5)


def test_pipeline_rejects_mismatched_stage_count(meshes):
    mesh, _ = meshes
    stacked = _port(_stages(8, n=3))
    x = torch.zeros((2, 2, DIM))
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_forward(t_stage, stacked, x, mesh)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_train_step(t_stage, t_loss, stacked, x, x, mesh)
    with pytest.raises(ValueError, match="leading dim"):
        stage_shardings(stacked, mesh)


def test_stack_stage_params_stacks_and_checks_names():
    stages = [{"w": torch.full((2, 2), float(i)), "b": torch.zeros(2)} for i in range(3)]
    stacked = stack_stage_params(stages)
    assert stacked["w"].shape == (3, 2, 2) and torch.equal(stacked["w"][2], stages[2]["w"])
    with pytest.raises(ValueError, match="stage 1"):
        stack_stage_params([stages[0], {"w": stages[1]["w"]}])


def test_1f1b_loss_and_grads_match_the_reference(meshes):
    """The 1F1B step's (loss, grads) equal the reference's step and the
    port's sequential stages under autograd; each stage's gradient stays on
    its member, a (1, D, D) slice."""
    mesh, jmesh = meshes
    stacked_np, x, y = _stages(10), _normal(11, 8, 3, DIM), _normal(12, 8, 3, DIM)
    loss, grads, stats = _port_step(stacked_np, x, y, mesh)
    jloss, jgrads = jax.jit(lambda p, a, b: jpipe.pipeline_train_step(
        j_stage, j_loss, p, a, b, jmesh))(jax.tree.map(jnp.asarray, stacked_np), x, y)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close(grads, flax_stage_params(_np(jgrads)), atol=1e-5)

    stacked = {n: t.requires_grad_() for n, t in _port(stacked_np).items()}
    out = _port_sequential(stacked, torch.from_numpy(x))
    want = torch.stack([t_loss(out[j], torch.from_numpy(y[j])) for j in range(8)]).mean()
    want.backward()
    np.testing.assert_allclose(float(loss), float(want.detach()), rtol=1e-5)
    _close(grads, {n: t.grad for n, t in stacked.items()}, atol=1e-5)
    assert stats["forward_units"] == stats["backward_units"] == 8 * STAGES


def test_1f1b_grads_stay_on_their_stage_members(meshes):
    mesh, _ = meshes
    stacked = _port(_stages(13))
    members = stage_shardings(stacked, mesh)
    assert [tuple(m["w"].shape) for m in members] == [(1, DIM, DIM)] * STAGES
    assert all(torch.equal(m["w"][0], stacked["w"][i]) for i, m in enumerate(members))
    x, y = torch.from_numpy(_normal(14, 4, 2, DIM)), torch.from_numpy(_normal(15, 4, 2, DIM))
    _, grads = pipeline_train_step(t_stage, t_loss, stacked, x, y, mesh)
    assert len(grads) == STAGES
    assert {tuple(g["w"].shape) for g in grads} == {(1, DIM, DIM)}
    assert all(g["w"].device == d for g, d in zip(grads, mesh.devices))


def test_1f1b_training_reduces_loss(meshes):
    mesh, _ = meshes
    x = torch.from_numpy(_normal(17, 8, 4, DIM))
    y = torch.roll(x, 1, dims=-1) * 0.5
    specs = stage_specs(_port(_stages(16)))

    def step(params):
        loss, grads = pipeline_train_step(t_stage, t_loss, params, x, y, mesh)
        for n, g in stack_stage_grads(grads, mesh, specs).items():
            params[n].grad = g
        return float(loss)

    losses = _adam_losses(step, _port(_stages(16)))
    assert losses[-1] < losses[0] * 0.9 and np.isfinite(losses[-1])


def test_bubble_fraction():
    assert bubble_fraction(1, 4) == 0.0
    assert bubble_fraction(4, 4) == pytest.approx(6 / 10)
    fractions = [bubble_fraction(4, m) for m in (4, 8, 16, 64, 256)]
    assert fractions == sorted(fractions, reverse=True)
    assert fractions[-1] < 0.03
    assert bubble_fraction(8, 32) == pytest.approx(14 / 46)
    for s, m in ((1, 1), (2, 3), (4, 7), (8, 32)):
        assert bubble_fraction(s, m) == jpipe.bubble_fraction(s, m)


@pytest.mark.parametrize("m", [1, 3, 4, 7])
def test_1f1b_odd_microbatch_counts(meshes, m):
    """M smaller than, equal to and coprime with the stage count: the
    reference's sequential loss and gradients; every unit live once; the
    ring's peak ``min(2(S-1)+1, M)``."""
    mesh, _ = meshes
    stacked_np, x, y = _stages(18), _normal(20 + m, m, 2, DIM), _normal(40 + m, m, 2, DIM)
    loss, grads, stats = _port_step(stacked_np, x, y, mesh)
    want_loss, want_grads = _jax_seq_value_and_grad(stacked_np, x, y)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _close(grads, flax_stage_params(want_grads), atol=1e-5)
    assert stats == {"ticks": m + 2 * (STAGES - 1), "forward_units": m * STAGES,
                     "backward_units": m * STAGES,
                     "residual_peak": min(2 * (STAGES - 1) + 1, m)}


def test_1f1b_composes_with_dp():
    """dp x pp on (2, 4): each replica pipelines its half of every
    microbatch; loss and gradients those of the reference's dp x pp step;
    every member holds its stage's summed gradient, the replicas bitwise
    equal."""
    mesh, jmesh = _cpu_mesh((2, 4), ("dp", "pp")), _jax_mesh((2, 4), ("dp", "pp"))
    stacked_np, x, y = _stages(30), _normal(31, 8, 6, DIM), _normal(32, 8, 6, DIM)
    stacked = _port(stacked_np)
    loss, grads = pipeline_train_step(t_stage, t_loss, stacked, torch.from_numpy(x),
                                      torch.from_numpy(y), mesh, dp_axis="dp")
    jloss, jgrads = jax.jit(lambda p, a, b: jpipe.pipeline_train_step(
        j_stage, j_loss, p, a, b, jmesh, dp_axis="dp"))(jax.tree.map(jnp.asarray, stacked_np),
                                                        x, y)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close(stack_stage_grads(grads, mesh, stage_specs(stacked)), flax_stage_params(_np(jgrads)),
           atol=1e-5)
    for a, b in zip(grads[:4], grads[4:]):
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_1f1b_dp_rejects_bad_inputs():
    mesh = _cpu_mesh((2, 4), ("dp", "pp"))
    stacked = _port(_stages(33))
    x = torch.zeros((4, 3, DIM))                       # 3 % dp=2 != 0
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_train_step(t_stage, t_loss, stacked, x, x, mesh, dp_axis="dp")
    with pytest.raises(ValueError, match="not in mesh axes"):
        pipeline_train_step(t_stage, t_loss, stacked, x, x, mesh, dp_axis="data")
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_train_step(t_stage, t_loss, stacked, x, x[:3], mesh)


def test_1f1b_composes_with_tp_inside_stages():
    """dp x pp x tp on (2, 2, 2): a megatron stage (``w1`` column-, ``w2``
    row-parallel, the *f*/*g* pair), composed with dp; loss and gradients
    those of the reference's step, each member's gradient its (1, dim,
    ff/2) slice of ``w1``."""
    mesh = _cpu_mesh((2, 2, 2), ("dp", "pp", "tp"))
    jmesh = _jax_mesh((2, 2, 2), ("dp", "pp", "tp"))
    stages, dim, ff = 2, 8, 16
    rng = np.random.default_rng(20)
    params_np = {"w1": (rng.normal(size=(stages, dim, ff)) * 0.3).astype(np.float32),
                 "w2": (rng.normal(size=(stages, ff, dim)) * 0.3).astype(np.float32)}
    specs = {"w1": ("pp", None, "tp"), "w2": ("pp", "tp", None)}
    x, y = _normal(21, 4, 4, dim), _normal(22, 4, 4, dim)

    def stage(ps, xs):
        hs = [torch.nn.functional.gelu(a @ p["w1"], approximate="tanh")
              for a, p in zip(tp_replicate(xs), ps)]
        return [a + b for a, b in zip(xs, tp_all_reduce([h @ p["w2"] for h, p in zip(hs, ps)]))]

    def jstage(p, z):
        h = jax.nn.gelu(jax_tp_replicate(z) @ p["w1"])
        return z + jax_tp_all_reduce(h @ p["w2"])

    stats = {}
    loss, grads = pipeline_train_step(stage, t_loss, _port(params_np), torch.from_numpy(x),
                                      torch.from_numpy(y), mesh, dp_axis="dp",
                                      param_specs=specs, stats=stats)
    jspecs = {"w1": jax.sharding.PartitionSpec("pp", None, "tp"),
              "w2": jax.sharding.PartitionSpec("pp", "tp", None)}
    jloss, jgrads = jax.jit(lambda p, a, b: jpipe.pipeline_train_step(
        jstage, j_loss, p, a, b, jmesh, dp_axis="dp", param_specs=jspecs))(
        jax.tree.map(jnp.asarray, params_np), x, y)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close(stack_stage_grads(grads, mesh, specs), flax_stage_params(_np(jgrads)), atol=1e-5)
    assert {tuple(g["w1"].shape) for g in grads} == {(1, dim, ff // 2)}
    assert stats["ticks"] == 4 + 2 * (stages - 1) and stats["residual_peak"] == 3


def _scan_lengths(closed) -> list:
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "scan":
                found.append(eqn.params["length"])
            for sub in eqn.params.values():
                if hasattr(sub, "eqns"):
                    walk(sub)
                elif hasattr(sub, "jaxpr"):
                    walk(sub.jaxpr)

    walk(closed.jaxpr)
    return found


@pytest.mark.parametrize("m", [2, 6, 16])
def test_1f1b_schedule_runs_m_plus_2s_ticks(meshes, m):
    """The schedule is one pass of exactly M + 2(S-1) ticks, the length of
    the reference's one scan; S * M live units each way."""
    mesh, jmesh = meshes
    stacked_np, x, y = _stages(0), _normal(5, m, 2, DIM), _normal(6, m, 2, DIM)
    _, _, stats = _port_step(stacked_np, x, y, mesh)
    jaxpr = jax.make_jaxpr(lambda p, a, b: jpipe.pipeline_train_step(
        j_stage, j_loss, p, a, b, jmesh))(jax.tree.map(jnp.asarray, stacked_np), x, y)
    assert _scan_lengths(jaxpr) == [stats["ticks"]] == [m + 2 * (STAGES - 1)]
    assert stats["forward_units"] == stats["backward_units"] == m * STAGES


# -- transformer Block stages ---------------------------------------------------------------


BLOCK_DIM, BLOCK_SEQ = 32, 8


@pytest.mark.parametrize("layout", ["pp4", "dp2-pp2-gqa"])
def test_block_stages_match_the_reference(layout):
    """The port's flash ``Block`` stages through the 1F1B step against the
    reference's over flax ``Block``s with flash attention (the dryrun's
    cells, ``__graft_entry__.py:241-330``): pp = 4 with M = 8, and dp x pp =
    (2, 2) with a GQA block; in the dryrun's bf16 bands."""
    shape, names, kv = ((4,), ("pp",), None) if layout == "pp4" else ((2, 2), ("dp", "pp"), 1)
    dp_axis = "dp" if "dp" in names else None
    s = shape[-1]
    block = JaxBlock(dim=BLOCK_DIM, heads=2, kv_heads=kv, attention="flash")
    x = _normal(40, 8, 2, BLOCK_SEQ, BLOCK_DIM)
    y = _normal(41, 8, 2, BLOCK_SEQ)
    head = _normal(42, BLOCK_DIM) * 0.1
    keys = jax.random.split(jax.random.PRNGKey(2), s)
    stacked_j = jpipe.stack_stage_params([block.init(k, jnp.asarray(x[0])) for k in keys])

    def j_mb(out, tgt):
        return jnp.mean((out @ head - tgt) ** 2)

    jloss, jgrads = jax.jit(lambda p, a, b: jpipe.pipeline_train_step(
        lambda pp, z: block.apply(pp, z), j_mb, p, a, b, _jax_mesh(shape, names),
        dp_axis=dp_axis))(stacked_j, x, y)

    model = TelemetrySequenceModel(dim=BLOCK_DIM, heads=2, kv_heads=kv, layers=s,
                                   attention="flash", device="cpu")
    stage_fn, _ = pipeline_stages(model, s)
    stacked = flax_stage_params(_np(stacked_j))
    head_t = torch.from_numpy(head)
    mesh = _cpu_mesh(shape, names)
    loss, grads = pipeline_train_step(
        stage_fn, lambda out, tgt: torch.mean((out @ head_t - tgt) ** 2), stacked,
        torch.from_numpy(x), torch.from_numpy(y), mesh, dp_axis=dp_axis)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * max(1.0, abs(float(jloss)))
    got = stack_stage_grads(grads, mesh, stage_specs(stacked))
    want = flax_stage_params(_np(jgrads))
    assert set(got) == set(want)
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        assert err <= 5e-2 * max(1.0, float(w.abs().max())), (n, err)
