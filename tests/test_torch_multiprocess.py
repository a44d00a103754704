"""The port's mesh over processes (``make_hybrid_mesh``, or a ``Mesh``
with ``owners``, in a process group) against the port's one-process mesh
and against the JAX package.

Two ``gloo`` processes on a free local port run ``tests/torch_mp_cells.py``
(the port only, one torch thread each): the anomaly MLP on a global (dp, tp)
= (4, 2), two (2, 2) halves; the transformer (dim 64, 2 layers, T 64) on
(2, 2), two (1, 2) halves, full and flash attention (the plain version on
the CPU), ``seq_shard`` off and on; ZeRO-2, and ZeRO-3 with remat and
flash, on dp = 4, two halves of 2. Each takes two Adam steps from a numpy
seed. The same two processes run the collectives across processes inside
a forward, each cell on its mesh cut between them: the MoE model (dim 16,
4 experts; top-1, top-2 and expert choice) on (dp, ep) = (2, 2) cut along
dp and along ep; GPipe on pp = 2 and (dp, pp) = (2, 2) and 1F1B on pp = 2,
(dp, pp) = (2, 2) and (dp, pp, tp) = (2, 2, 2) with megatron stages, cut
along pp, and on (pp, tp) = (2, 2) cut along tp, each stage's tp pair split
between the processes (megatron stages, and the model's flash blocks as
the stages); dp-sharded serving (prefill, decode, forecast eta) on dp = 2 and
(dp, tp) = (2, 2) cut along dp; ring and Ulysses attention alone on sp = 2
(flash and the plain backends) and inside ``sharded_seq_train_step`` on
(dp, tp, sp) = (2, 1, 2) cut along sp; ``along`` over a group of 4 split
2 / 2 for every collective, forward and backward. Four processes, one
member each, run the ring step on (dp, sp) = (2, 2), whose sp and dp groups
each cross two of them (sub-groups), and 1F1B on (pp, tp) = (2, 2), whose
tp pairs and stage hops each cross two. ``dryrun_multichip(8)`` runs every
mesh cell over the two processes. The parent waits with a limit of its own
(:data:`WAIT_S`), so a hang fails these tests and does not hold the suite.
Tolerances, with their reasons:

- the processes against each other and against the one-process mesh of
  the same global shape on ``["cpu"] * n``: bitwise, losses and a hash of
  every whole parameter and Adam moment after the steps (the forward cells:
  a hash of their outputs and gradients). A sum over a group that crosses
  processes gathers every member's tensor and folds them in member order
  on each process, the one-process adds, and a move delivers bytes;
- against the reference's ``sharded_train_step``, ``sharded_seq_train_step``
  and ``zero_train_step`` (jitted, on a JAX mesh of the same shape over the
  8 virtual CPU devices, from the same params): the bands of
  ``tests/test_torch_parallel.py`` and ``tests/test_torch_zero.py``, the
  reference's sharded-step band ``tests/test_parallel.py:67`` (losses rel
  2e-2) and ``:68`` / ``:169-177`` for the parameters after the steps
  (rtol 2e-2, atol 1e-4 for the MLP, 5e-3 for the transformer). The flash
  cells are held against the reference's full-attention step: flash
  attention is full attention within that band, and the reference's flash
  kernel runs only in interpret mode;
- the forward cells against the reference on a JAX mesh of the same
  shape, in the bands of their one-process tests: MoE and the sp steps as
  the sharded steps above (``tests/test_torch_moe.py``,
  ``tests/test_torch_parallel.py``); GPipe forward atol 1e-5 and gradients
  atol 1e-4, 1F1B loss rtol 1e-5 and gradients atol 1e-5
  (``tests/test_torch_pipeline.py``); serving's teacher-forced predictions
  and fed-back deltas rtol 2e-2, atol 5e-3
  (``tests/test_torch_sharded_decode.py``); ring and Ulysses against the
  reference's ``flash_attention``, forward rtol 2e-4, atol 2e-5 and
  gradients rtol 1e-3, atol 1e-4 (``tests/test_torch_ring.py``);
- ``make_hybrid_mesh``'s layout and error texts: exact, the texts word for
  word with the reference's (``jax.process_count`` patched to 2);
- two planted controls must fail the bitwise gate: rank 1 given the wrong
  dp rows, and rank 1 keeping the k block it sent in its first ring hop
  between processes where it should take the one it received.
"""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

import torch_mp_cells as cells
from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxSeqModel
from beholder_tpu.models.sequence import seq_loss as jax_seq_loss
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu.models.train import TrainState as JaxTrainState
from beholder_tpu.models.decode import sharded_decode_step as jax_sharded_decode_step
from beholder_tpu.models.decode import sharded_prefill as jax_sharded_prefill
from beholder_tpu.models.sequence import seq_train_step as jax_seq_train_step
from beholder_tpu.ops import moe as jax_moe
from beholder_tpu.ops.flash_attention import flash_attention as jax_flash
from beholder_tpu.parallel import make_hybrid_mesh as ref_make_hybrid_mesh
from beholder_tpu.parallel import mesh as jax_mesh_mod
from beholder_tpu.parallel import pipeline as jpipe
from beholder_tpu.parallel import seq_state_shardings as jax_seq_state_shardings
from beholder_tpu.parallel import tp_all_reduce as jax_tp_all_reduce
from beholder_tpu.parallel import tp_replicate as jax_tp_replicate
from beholder_tpu.parallel import zero as jax_zero
from beholder_tpu_torch.models import ProgressAnomalyModel, TelemetrySequenceModel
from beholder_tpu_torch.models.bridge import flax_named, flax_stage_params, init_params
from beholder_tpu_torch.parallel import Mesh, collectives

WORLD = 2
#: seconds the parent waits for the processes (two take about 20 here,
#: four about 10)
WAIT_S = 240


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spawn(out, world: int, *flags) -> list:
    """``world`` processes of the cells script, each a rank of one group,
    waited for up to WAIT_S together; each rank's results."""
    port = free_port()
    script = Path(cells.__file__)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(port),
                               str(out / f"rank{r}.pt"), *flags],
                              cwd=script.parent.parent, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WAIT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"the {world} processes did not finish in {WAIT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results: the two processes run every cell, then the
    planted controls."""
    return _spawn(tmp_path_factory.mktemp("mp"), WORLD, "--plant")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Four processes, one member each: the cells of ``FOUR_CELLS``."""
    return _spawn(tmp_path_factory.mktemp("mp4"), 4, "--four")


@pytest.fixture(scope="module")
def one_process():
    """The same cells on the one-process mesh of the same global shape."""
    done = {}

    def run(name):
        if name not in done:
            done[name] = cells.run_cell(name, cells.cell_mesh(name))
        return done[name]

    return run


@pytest.fixture(scope="module")
def one_process_forward():
    """The forward cells on the one-process mesh of the same global shape."""
    done = {}

    def run(name):
        if name not in done:
            done[name] = cells.run_forward_cell(name, cells.forward_mesh(name))
        return done[name]

    return run


def _same(a: dict, b: dict) -> bool:
    return a["losses"] == b["losses"] and a["digest"] == b["digest"]


@pytest.mark.parametrize("name", list(cells.CELLS))
def test_processes_are_bitwise_the_one_process_mesh(ranks, one_process, name):
    want = one_process(name)
    for r in range(WORLD):
        assert ranks[r][name]["losses"] == want["losses"], (r, ranks[r][name]["losses"])
        bad = [n for n, h in want["digest"].items() if ranks[r][name]["digest"][n] != h]
        assert not bad, (r, bad)
    assert np.isfinite(want["losses"]).all() and want["losses"][1] < want["losses"][0]


def test_planted_wrong_rows_fail_the_bitwise_gate(ranks, one_process):
    """Rank 1 passes the batch rolled by half, so its dp rows are rank 0's:
    the ranks still agree with each other (each folds the same gathered
    gradients), and the gate against the one-process mesh must fail."""
    planted = [ranks[r]["planted"] for r in range(WORLD)]
    want = one_process(cells.PLANT_CELL)
    assert _same(planted[0], planted[1])
    assert not _same(planted[0], want)
    assert planted[0]["losses"][0] != want["losses"][0]
    assert all(planted[0]["digest"][n] != h for n, h in want["digest"].items()
               if n.startswith(("in_proj", "mid_proj.weight")))


def test_dryrun_over_two_processes_runs_every_mesh_cell(ranks):
    """``dryrun_multichip(8)`` in the group runs every cell: the mesh cells
    on meshes over both processes, each within the reference's band of its
    unsharded value (the dryrun's own gate) and bitwise the same cells on
    one process's 8 members; the two single-batcher cells whole in each
    process."""
    from beholder_tpu_torch import dryrun

    want = dryrun.dryrun_multichip(8, ["cpu"] * 8)
    assert list(want) == list(dryrun.CELLS)
    for r in range(WORLD):
        assert ranks[r]["dryrun"] == want, r
    assert set(dryrun.ACROSS_PROCESSES) == set(dryrun.CELLS) - {"paged serving",
                                                                  "what-if fork"}


# -- collectives across processes inside a forward --------------------------------


def _forward_same(got: dict, want: dict) -> bool:
    if "losses" in want:
        return _same(got, want)
    return got["digest"] == want["digest"]


@pytest.mark.parametrize("name", list(cells.FORWARD_CELLS))
def test_forward_cells_are_bitwise_the_one_process_mesh(ranks, one_process_forward, name):
    """Each process computes its own members and the collectives cross
    between them: outputs and gradients (a training cell's losses, whole
    parameters and Adam moments) bitwise the other process's and the
    one-process mesh's."""
    want = one_process_forward(name)
    for r in range(WORLD):
        assert _forward_same(ranks[r][name], want), (r, name)
    if "losses" in want:
        assert np.isfinite(want["losses"]).all()
    else:
        assert all(torch.isfinite(t.float()).all() for t in want["out"])


def test_four_processes_run_the_ring_over_sub_groups(four_ranks):
    """One member a process: the ring step on (dp, sp) = (2, 2), whose sp
    and dp groups each cross two of the four processes, and 1F1B on (pp,
    tp) = (2, 2), whose stages' tp pairs each cross two and whose hops
    between stages all cross; their collectives run over a process group
    of those two. Each bitwise the one-process mesh."""
    for name in cells.FOUR_CELLS:
        want = cells.run_forward_cell(name, cells.forward_mesh(name))
        for r in range(4):
            assert _forward_same(four_ranks[r][name], want), (r, name)
        mesh = cells.forward_mesh(name, 4, 0)
        if cells.cell_spec(name)[0] == "sp-step":
            assert mesh.layout("sp", 0).owners == (0, 1)
            assert mesh.layout("dp", 0).owners == (0, 2)
        else:
            assert mesh.layout("tp", 0).owners == (0, 1)
            assert mesh.layout("pp", 0).owners == (0, 2)


@pytest.mark.parametrize("op", list(cells.ALONG_OPS))
def test_along_over_a_split_group_is_bitwise_one_process(ranks, op):
    """``along`` over one group of 4 members, 2 in each process: every
    member's output and input gradient (of its output weighted, some
    weights ``-0.0``) bitwise the one-process group's, byte for byte."""
    want = cells.run_along(op, cells.along_mesh())
    seen = set()
    for r in range(WORLD):
        for i, (out, grad) in ranks[r]["along"][op].items():
            w_out, w_grad = want[i]
            assert out.shape == w_out.shape and grad.shape == w_grad.shape
            assert torch.equal(out.view(torch.uint8), w_out.view(torch.uint8)), (op, i)
            assert torch.equal(grad.view(torch.uint8), w_grad.view(torch.uint8)), (op, i)
            seen.add(i)
    assert seen == set(range(4))


@pytest.mark.parametrize("name", list(cells.BLOCK_CELLS))
def test_block_stages_with_a_split_tp_group_are_bitwise_one_process(ranks, name):
    """The model's flash blocks as 1F1B stages on (pp, tp) = (2, 2), each
    stage's tp pair split between the two processes (its megatron blocks'
    collectives cross them): the loss and every stacked gradient bitwise
    the other process's and the one-process mesh's."""
    shape, names, _ = cells.BLOCK_CELLS[name]
    want = cells.run_block_cell(name, cells.cut_mesh(shape, names, "tp"))
    for r in range(WORLD):
        assert ranks[r]["blocks"][name]["digest"] == want["digest"], (r, name)


@pytest.mark.parametrize("name", list(cells.BLOCK_CELLS))
def test_block_stages_with_a_split_tp_group_match_the_sequential_blocks(ranks, name):
    """The same cell against the model's blocks applied in sequence to each
    microbatch under autograd (the mean loss over the microbatches), in the
    dryrun's bf16 bands that ``tests/test_torch_pipeline.py`` holds the
    block stages to (``__graft_entry__.py:271-286``): the loss within rel
    1e-3, every gradient within 5e-2 x max(1, max |g|). The blocks' products
    round to bf16 (``Dense(dtype=bf16)``), and a tp member's product over
    its half of the hidden units rounds apart from the whole one's."""
    from beholder_tpu_torch.models import pipeline_stages

    model, h, y, loss_fn = cells.block_inputs()
    stage_fn, params = pipeline_stages(model, 2)
    leaves = [{n: t.clone().requires_grad_() for n, t in p.items()} for p in params]
    losses = []
    for j in range(h.shape[0]):
        z = h[j]
        for p in leaves:
            z = stage_fn(p, z)
        losses.append(loss_fn(z, y[j]))
    loss = torch.stack(losses).mean()
    flat = [t for p in leaves for t in p.values()]
    grads = dict(zip([(i, n) for i, p in enumerate(leaves) for n in p],
                     torch.autograd.grad(loss, flat)))
    got = ranks[0]["blocks"][name]
    ref = float(loss.detach())
    assert abs(float(got["out"][0]) - ref) <= 1e-3 * max(1.0, abs(ref))
    for n, g in zip(got["names"], got["out"][1:]):
        want = torch.stack([grads[i, n] for i in range(len(leaves))])
        err = float((g.float() - want.float()).abs().max())
        assert err <= 5e-2 * max(1.0, float(want.abs().max())), (n, err)


def test_planted_ring_hop_fails_the_bitwise_gate(ranks, one_process_forward):
    """Rank 1 keeps the k block it sent in its first ring hop between
    processes: the ranks still agree (every member's gradients and losses
    are gathered), and the gate against the one-process mesh fails."""
    planted = [ranks[r]["planted ring"] for r in range(WORLD)]
    want = one_process_forward(cells.PLANT_RING)
    assert _same(planted[0], planted[1])
    assert not _same(planted[0], want)
    assert planted[0]["losses"][0] != want["losses"][0]


# -- the reference ----------------------------------------------------------------


def _jax_mesh(shape, names):
    return JaxMesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


def _jax_state(params: dict, tx):
    params = jax.tree.map(jnp.asarray, params)
    return JaxTrainState(params, tx.init(params), jnp.int32(0))


@pytest.fixture(scope="module")
def reference():
    """Per cell kind (flash cells share their full-attention twin's): the
    reference's losses and params after STEPS sharded steps from the port's
    initial params."""
    import optax

    done = {}

    def run(name):
        kind, shape, kw = cells.CELLS[name]
        key = (kind, shape, kw.get("seq_shard", False))
        if key in done:
            return done[key]
        tx = optax.adam(cells.LR)
        if kind == "mlp":
            data = [jnp.asarray(t.numpy()) for t in cells.mlp_data()]
            jmesh = _jax_mesh(shape, ("dp", "tp"))
            state = _jax_state(init_params(ProgressAnomalyModel(device="cpu"), 0), tx)
            step = jax_mesh_mod.sharded_train_step(tx, jmesh, state)
            state = jax_mesh_mod.place_state(state, jmesh)
        else:
            rng = np.random.default_rng(5)
            prog = np.cumsum(1.5 + rng.normal(0, 0.1, (cells.B, cells.T + 1)), axis=-1)
            data = jax_stream_features(jnp.asarray(prog),
                                       jnp.asarray(np.full((cells.B, cells.T + 1), 2)))
            params = init_params(TelemetrySequenceModel(**cells.SEQ_MODEL, device="cpu"), 0)
            state = _jax_state(params, tx)
            if kind == "seq":
                jmesh = _jax_mesh(shape, ("dp", "tp"))
                seq_shard = kw.get("seq_shard", False)
                model = JaxSeqModel(**cells.SEQ_MODEL, seq_shard=seq_shard,
                                    **({"mesh": jmesh} if seq_shard else {}))
                step = jax_mesh_mod.sharded_seq_train_step(model, tx, jmesh, state)
                state = jax_mesh_mod.place_seq_state(state, jmesh)
            else:
                jmesh = _jax_mesh(shape, ("dp",))
                model = JaxSeqModel(**cells.SEQ_MODEL, remat=kw.get("remat", False))
                stage3 = kind == "zero3"
                state = jax_zero.place_zero_state(state, jmesh, shard_params=stage3)
                step = jax_zero.zero_train_step(
                    tx, jmesh, state, lambda p, f, t: jax_seq_loss(model, p, f, t),
                    shard_params=stage3)
        losses = []
        for _ in range(cells.STEPS):
            state, loss = step(state, *data)
            losses.append(float(loss))
        done[key] = dict(losses=losses, params=jax.tree.map(np.asarray, state.params))
        return done[key]

    return run


@pytest.mark.parametrize("name", list(cells.CELLS))
def test_processes_within_the_reference_bands(ranks, reference, name):
    got, want = ranks[0][name], reference(name)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-2)
    kind = cells.CELLS[name][0]
    model = (ProgressAnomalyModel(device="cpu") if kind == "mlp"
             else TelemetrySequenceModel(**cells.SEQ_MODEL, device="cpu"))
    ref = flax_named(model, want["params"])
    atol = 1e-4 if kind == "mlp" else 5e-3
    names = [n for n, p in got["params"].items()
             if (kind == "mlp" and n == "in_proj.weight")
             or (n.startswith("blocks.0.") and n.endswith("weight") and p.ndim == 2)]
    assert names
    for n in names:
        np.testing.assert_allclose(got["params"][n].numpy(), ref[n].numpy(), rtol=2e-2,
                                   atol=atol, err_msg=n)


def _stage_tree(stacked_np: dict) -> dict:
    return jax.tree.map(jnp.asarray, stacked_np)


def _j_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _j_loss(out, y):
    return jnp.mean((out - y) ** 2)


def _j_megatron(p, z):
    h = jax.nn.gelu(jax_tp_replicate(z) @ p["w1"])
    return z + jax_tp_all_reduce(h @ p["w2"])


def _jax_train(name: str) -> dict:
    """The reference's sharded step of a training cell, STEPS steps from
    the port's initial params: losses and params after."""
    import optax

    kind, shape, names, _, kw = cells.cell_spec(name)
    jmesh = _jax_mesh(shape, names)
    if kind == "moe":
        port = TelemetrySequenceModel(**cells.MOE_MODEL, **kw, device="cpu")
        data = cells.moe_data()
    else:
        port = TelemetrySequenceModel(**cells.RING_MODEL, device="cpu")
        data = cells.sp_data()
    feats, targets = (jnp.asarray(t.numpy()) for t in data)
    tx = optax.adam(cells.LR)
    state = _jax_state(init_params(port, 0), tx)
    jkw = cells.MOE_MODEL if kind == "moe" else cells.RING_MODEL
    model = JaxSeqModel(**jkw, **kw, mesh=jmesh)
    if kind == "moe":
        state_sh = jax_moe.expert_shardings(state, jmesh)
        data_sh = NamedSharding(jmesh, PartitionSpec("dp"))
        step = jax.jit(lambda st, f, t: jax_seq_train_step(model, tx, st, f, t),
                       in_shardings=(state_sh, data_sh, data_sh),
                       out_shardings=(state_sh, NamedSharding(jmesh, PartitionSpec())))
        state = jax.device_put(state, state_sh)
    else:
        step = jax_mesh_mod.sharded_seq_train_step(model, tx, jmesh, state)
        state = jax_mesh_mod.place_seq_state(state, jmesh)
    losses = []
    for _ in range(cells.STEPS):
        state, loss = step(state, feats, targets)
        losses.append(float(loss))
    return dict(losses=losses, params=flax_named(port, jax.tree.map(np.asarray, state.params)))


def _jax_forward(name: str) -> list:
    """The reference's results of a forward cell, on a JAX mesh of the
    cell's shape, in the order of the port's (``run_forward_cell``)."""
    kind, shape, names, _, kw = cells.cell_spec(name)
    jmesh = _jax_mesh(shape, names)
    if kind == "gpipe":
        tree = _stage_tree(cells.pipe_stages(4, shape[-1]))
        x = jnp.asarray(cells.pipe_data(5))

        def both(p):
            out = jpipe.pipeline_forward(_j_stage, p, x, jmesh)
            return out, jax.grad(
                lambda p: jnp.sum(jpipe.pipeline_forward(_j_stage, p, x, jmesh) ** 2))(p)

        out, grads = jax.jit(both)(tree)
        named = flax_stage_params(jax.tree.map(np.asarray, grads))
        return [np.asarray(out), *(named[n].numpy() for n in ("w", "b"))]
    if kind in ("1f1b", "1f1b-tp"):
        x, y = cells.pipe_data(11), cells.pipe_data(12)
        if kind == "1f1b":
            tree, stage, jspecs = _stage_tree(cells.pipe_stages(10, shape[-1])), _j_stage, None
        else:
            params, _ = cells.megatron_stages()
            tree, stage = _stage_tree(params), _j_megatron
            jspecs = {"w1": PartitionSpec("pp", None, "tp"), "w2": PartitionSpec("pp", "tp", None)}
        loss, grads = jax.jit(lambda p, a, b: jpipe.pipeline_train_step(
            stage, _j_loss, p, a, b, jmesh, param_specs=jspecs, **kw))(tree, x, y)
        named = flax_stage_params(jax.tree.map(np.asarray, grads))
        return [np.asarray(loss), *(named[n].numpy() for n in sorted(named))]
    if kind == "serving":
        from beholder_tpu.ops import NUM_STATUSES as J_STATUSES

        port = TelemetrySequenceModel(**cells.SERVE_MODEL, device="cpu")
        jparams = jax.tree.map(jnp.asarray, init_params(port, 3))
        jmodel = JaxSeqModel(**cells.SERVE_MODEL)
        jspecs = jax_seq_state_shardings(jparams, jmesh) if kw.get("megatron") else None
        jp = jax.device_put(jparams, jspecs) if jspecs else jparams
        progress, statuses = (jnp.asarray(t.numpy()) for t in cells.serve_data())
        feats, _ = jax_stream_features(progress, statuses)
        pre = jax_sharded_prefill(jmodel, jmesh, cells.SERVE_T + cells.SERVE_HORIZON,
                                  params_shardings=jspecs)
        step = jax_sharded_decode_step(jmodel, jmesh, params_shardings=jspecs)
        _, cache = pre(jp, feats[:, :cells.SERVE_SPLIT])
        tf = []
        for i in range(cells.SERVE_SPLIT, cells.SERVE_T):
            pred, cache = step(jp, cache, feats[:, i])
            tf.append(np.asarray(pred))
        status = jax.nn.one_hot(statuses[:, -1], J_STATUSES)
        delta, cache = pre(jp, feats)
        deltas = []
        for _ in range(cells.SERVE_HORIZON):
            deltas.append(np.asarray(delta))
            delta, cache = step(jp, cache, jnp.concatenate([delta[:, None], status], -1))
        return [np.stack(tf, 1), np.stack(deltas, 1)]
    q, k, v = (jnp.asarray(a) for a in cells.attend_inputs())
    out = jax_flash(q, k, v, causal=True)
    grads = jax.grad(lambda *a: jnp.sum(jax_flash(*a, causal=True) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    return [np.asarray(out), *(np.asarray(g) for g in grads)]


#: the band of each forward cell's results against the reference's, in the
#: cell's order: (rtol, atol) per result
FORWARD_BANDS = {
    "gpipe": [(0, 1e-5), (0, 1e-4), (0, 1e-4)],
    "1f1b": [(1e-5, 0), (0, 1e-5), (0, 1e-5)],
    "1f1b-tp": [(1e-5, 0), (0, 1e-5), (0, 1e-5)],
    "serving": [(2e-2, 5e-3), (2e-2, 5e-3)],
    "attend": [(2e-4, 2e-5), (1e-3, 1e-4), (1e-3, 1e-4), (1e-3, 1e-4)],
}


@pytest.fixture(scope="module")
def forward_reference():
    """The reference's results per forward cell, shared by the cells of one
    global shape and settings (the two cuts of a MoE cell; the attention
    cells, all held to the reference's flash attention)."""
    done = {}

    def run(name):
        kind, shape, names, _, kw = cells.cell_spec(name)
        key = (kind, "flash") if kind == "attend" else (kind, shape, names, str(kw))
        if key not in done:
            done[key] = _jax_train(name) if kind in ("moe", "sp-step") else _jax_forward(name)
        return done[key]

    return run


@pytest.mark.parametrize("name", list(cells.FORWARD_CELLS))
def test_forward_cells_within_the_reference_bands(ranks, forward_reference, name):
    """Each forward cell over the two processes against the reference on a
    JAX mesh of the same shape, in its one-process test's bands."""
    kind = cells.cell_spec(name)[0]
    got = ranks[0][name]
    want = forward_reference(name)
    if kind in ("moe", "sp-step"):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-2)
        names = [n for n, t in got["params"].items()
                 if n.startswith("blocks.0.") and n.endswith("weight") and t.ndim >= 2]
        assert names
        for n in names:
            np.testing.assert_allclose(got["params"][n].numpy(), want["params"][n].numpy(),
                                       rtol=2e-2, atol=5e-3, err_msg=n)
        return
    for i, ((rtol, atol), w) in enumerate(zip(FORWARD_BANDS[kind], want)):
        np.testing.assert_allclose(got["out"][i].float().numpy(), w, rtol=rtol, atol=atol,
                                   err_msg=f"{name} result {i}")


def test_four_process_1f1b_within_the_reference_bands(four_ranks, forward_reference):
    """The four-process 1F1B cell (each stage's tp pair split between two
    processes) against the reference's ``pipeline_train_step`` on a JAX
    (pp, tp) = (2, 2) mesh, in the 1F1B bands: loss rtol 1e-5, gradients
    atol 1e-5."""
    name = "1f1b pp=2 tp=2 four processes"
    want = forward_reference(name)
    for i, ((rtol, atol), w) in enumerate(zip(FORWARD_BANDS["1f1b-tp"], want)):
        np.testing.assert_allclose(four_ranks[0][name]["out"][i].float().numpy(), w,
                                   rtol=rtol, atol=atol, err_msg=f"{name} result {i}")


# -- make_hybrid_mesh over processes ----------------------------------------------


def test_hybrid_mesh_over_two_processes_matches_the_reference(ranks, monkeypatch):
    """The global ("dp", "tp") grid over 2 x 4 CPU members, the reference's
    shape, ``dp`` rows [4p/2, 4(p+1)/2) on process p (its ``dcn_mesh_shape=
    (2, 1)``); its refusals word for word the reference's with two
    processes over 8 devices."""
    ref = ref_make_hybrid_mesh(ici_tp=2)
    for r in range(WORLD):
        facts = ranks[r]["mesh"]
        assert facts["rank"] == r
        assert facts["shape"] == ref.devices.shape == (4, 2)
        assert facts["axis_names"] == tuple(ref.axis_names)
        assert facts["shape_tp1"] == ref_make_hybrid_mesh(ici_tp=1).devices.shape
        assert facts["owners"] == (0,) * 4 + (1,) * 4
        assert facts["local"] == tuple(range(4 * r, 4 * r + 4))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    texts = {}
    for ici_tp in (8, 3):
        with pytest.raises(ValueError) as err:
            ref_make_hybrid_mesh(ici_tp=ici_tp)
        texts[f"ici_tp={ici_tp}"] = str(err.value)
    assert "divisible by ici_tp" in texts["ici_tp=8"]
    for r in range(WORLD):
        errors = ranks[r]["mesh"]["errors"]
        assert errors["ici_tp=8"] == texts["ici_tp=8"]
        assert errors["ici_tp=3"] == texts["ici_tp=3"]
        # 2 and 6 devices: the reference's text for 8 over 2 at ici_tp=2
        assert errors["uneven"] == texts["ici_tp=8"].replace("ici_tp=8", "ici_tp=2")


# -- along's member lists -----------------------------------------------------------


def test_along_runs_the_groups_of_this_process_and_checks_its_count():
    """``along`` runs the groups this process holds whole and skips the ones
    it holds none of (a mesh over two processes as rank 0 sees it); a list
    of another length than this process's members raises."""
    mesh = Mesh(np.full((2, 2), "cpu", dtype=object).tolist(), ("dp", "tp"),
                owners=[0, 0, 1, 1], rank=0)
    xs = [torch.full((2,), float(i)) for i in range(2)]
    out = collectives.along(mesh, "tp", collectives.all_reduce, xs)
    assert all(torch.equal(o, torch.ones(2)) for o in out)
    assert mesh.layout("dp", 0).owners == (0, 1) and mesh.layout("dp", 0).local == (0,)
    with pytest.raises(ValueError, match="lies inside one process"):
        mesh.layout("tp", 0)
    with pytest.raises(ValueError, match="2 members of this process"):
        collectives.along(mesh, "tp", collectives.all_reduce, xs * 2)
