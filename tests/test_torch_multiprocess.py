"""The port's mesh over processes (``make_hybrid_mesh`` in a process group)
against the port's one-process mesh and against the JAX package.

Two ``gloo`` processes on a free local port run ``tests/torch_mp_cells.py``
(the port only, one torch thread each): the anomaly MLP on a global (dp, tp)
= (4, 2), two (2, 2) halves; the transformer (dim 64, 2 layers, T 64) on
(2, 2), two (1, 2) halves, full and flash attention (the plain version on
the CPU), ``seq_shard`` off and on; ZeRO-2, and ZeRO-3 with remat and
flash, on dp = 4, two halves of 2. Each takes two Adam steps from a numpy
seed. The parent waits with a limit of its own (:data:`WAIT_S`), so a hang
fails these tests and does not hold the suite. Tolerances, with their
reasons:

- the two processes against each other and against the one-process mesh of
  the same global shape on ``["cpu"] * n``: bitwise, losses and a hash of
  every whole parameter and Adam moment after the steps. A sum over ``dp``
  gathers every member's gradient and folds them in member order on each
  process, the one-process step's adds;
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
- ``make_hybrid_mesh``'s layout and error texts: exact, the texts word for
  word with the reference's (``jax.process_count`` patched to 2);
- a planted control, rank 1 given the wrong dp rows, must fail the bitwise
  gate; and every mesh over processes that needs a collective across
  processes inside a forward must raise ``NotImplementedError``.
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

import torch_mp_cells as cells
from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxSeqModel
from beholder_tpu.models.sequence import seq_loss as jax_seq_loss
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu.models.train import TrainState as JaxTrainState
from beholder_tpu.parallel import make_hybrid_mesh as ref_make_hybrid_mesh
from beholder_tpu.parallel import mesh as jax_mesh_mod
from beholder_tpu.parallel import zero as jax_zero
from beholder_tpu_torch.models import ProgressAnomalyModel, TelemetrySequenceModel
from beholder_tpu_torch.models.bridge import flax_named, init_params
from beholder_tpu_torch.parallel import Mesh, collectives

WORLD = 2
#: seconds the parent waits for both processes (they take about 10 here)
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results: the two processes run every cell, then the
    planted control."""
    out = tmp_path_factory.mktemp("mp")
    port = free_port()
    script = Path(cells.__file__)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD), str(port),
                               str(out / f"rank{r}.pt"), "--plant"],
                              cwd=script.parent.parent, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WAIT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"the {WORLD} processes did not finish in {WAIT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process():
    """The same cells on the one-process mesh of the same global shape."""
    done = {}

    def run(name):
        if name not in done:
            done[name] = cells.run_cell(name, cells.cell_mesh(name))
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


def test_dryrun_over_two_processes_runs_the_cells_that_span_them(ranks):
    """``dryrun_multichip(8)`` in the group runs dp x tp, tp and ZeRO-3 on
    meshes over both processes, bitwise the same cells on one process's 8
    members; the rest it skips."""
    from beholder_tpu_torch import dryrun

    run = dryrun._Run(8, ["cpu"] * 8)
    want = {"dp×tp": dryrun._mlp(run), "tp": dryrun._tp(run), "zero3": dryrun._zero3(run)}
    for r in range(WORLD):
        assert ranks[r]["dryrun"] == want, r
    assert set(dryrun.ACROSS_PROCESSES) == set(want)


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


# -- refusals -----------------------------------------------------------------------


def _split_mesh(shape, names):
    """A mesh over two processes as rank 0 sees it: the first half of the
    members is this process's."""
    n = int(np.prod(shape))
    return Mesh(np.full(shape, "cpu", dtype=object).tolist(), names,
                owners=[0] * (n // 2) + [1] * (n // 2), rank=0)


def _moe(mesh):
    from beholder_tpu_torch.models import init_seq_state
    from beholder_tpu_torch.parallel import place_seq_state, sharded_seq_train_step

    model = TelemetrySequenceModel(dim=16, heads=2, layers=1, ffn="moe", num_experts=2,
                                   mesh=mesh, device="cpu")
    feats, targets = cells.seq_data()
    sharded_seq_train_step(place_seq_state(init_seq_state(0, model), mesh), feats[:, :16],
                           targets[:, :16])


def _gpipe(mesh):
    from beholder_tpu_torch.parallel import pipeline_forward

    pipeline_forward(lambda p, x: x * p["w"], {"w": torch.ones(2, 3)}, torch.ones(4, 1, 3),
                     mesh)


def _one_f_one_b(mesh):
    from beholder_tpu_torch.parallel import pipeline_train_step

    pipeline_train_step(lambda p, x: x * p["w"], lambda o, y: ((o - y) ** 2).mean(),
                        {"w": torch.ones(2, 3)}, torch.ones(4, 1, 3), torch.ones(4, 1, 3),
                        mesh)


def _serving(mesh):
    from beholder_tpu_torch.models.decode import sharded_prefill

    sharded_prefill(TelemetrySequenceModel(dim=16, heads=2, layers=1, device="cpu"), mesh, 16)


def _attention(fn):
    def call(mesh):
        from beholder_tpu_torch.ops import attention

        q = torch.ones(1, 2, 8, 4)
        getattr(attention, fn)(q, q, q, mesh, causal=True)
    return call


def _sharded_ring(mesh):
    from beholder_tpu_torch.models import init_seq_state
    from beholder_tpu_torch.parallel import place_seq_state, sharded_seq_train_step

    model = TelemetrySequenceModel(dim=16, heads=2, layers=1, attention="ring", mesh=mesh,
                                   device="cpu")
    feats, targets = cells.seq_data()
    sharded_seq_train_step(place_seq_state(init_seq_state(0, model), mesh), feats[:, :16],
                           targets[:, :16])


REFUSALS = {
    "moe": ((2, 2), ("dp", "ep"), _moe),
    "gpipe": ((2,), ("pp",), _gpipe),
    "1f1b": ((2, 2), ("dp", "pp"), _one_f_one_b),
    "sharded-serving": ((2,), ("dp",), _serving),
    "ring": ((2,), ("sp",), _attention("ring_attention")),
    "ulysses": ((2,), ("sp",), _attention("ulysses_attention")),
    "sharded-ring-step": ((2, 1, 2), ("dp", "tp", "sp"), _sharded_ring),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_collectives_across_processes_inside_a_forward_refuse(case):
    shape, names, call = REFUSALS[case]
    with pytest.raises(NotImplementedError, match=collectives.ACROSS_PROCESSES_ITEM):
        call(_split_mesh(shape, names))


def test_a_group_split_between_processes_refuses():
    """``along`` runs the groups this process holds whole, skips the ones it
    holds none of, and refuses one it holds part of."""
    mesh = _split_mesh((2, 2), ("dp", "tp"))
    xs = [torch.full((2,), float(i)) for i in range(2)]
    out = collectives.along(mesh, "tp", collectives.all_reduce, xs)
    assert all(torch.equal(o, torch.ones(2)) for o in out)
    with pytest.raises(NotImplementedError, match=collectives.ACROSS_PROCESSES_ITEM):
        collectives.along(mesh, "dp", collectives.all_reduce, xs)
    with pytest.raises(ValueError, match="2 members of this process"):
        collectives.along(mesh, "tp", collectives.all_reduce, xs * 2)
