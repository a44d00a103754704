"""The cells of ``tests/test_torch_multiprocess.py``: the port's sharded
steps, ZeRO, and the collectives across processes inside a forward (MoE
expert parallelism, GPipe and 1F1B, dp-sharded serving, ring and Ulysses
attention, ``along`` over a split group) on a mesh over processes, at small
sizes on the CPU.

Imported by the test (the one-process runs of the same cells) and run as a
script, one process a rank of a ``gloo`` group::

    python tests/torch_mp_cells.py RANK WORLD PORT OUT [--plant] [--four]

Each rank joins the group through the port's ``initialize``, runs every
cell of :data:`CELLS` on ``make_hybrid_mesh`` over the group, every cell of
:data:`FORWARD_CELLS` on its mesh cut between the processes as the cell
says, ``along`` over a split group for each of :data:`ALONG_OPS`, the model's
blocks as 1F1B stages with each stage's tp pair split (:data:`BLOCK_CELLS`),
and ``dryrun_multichip(8)`` over the group, and writes its results
(``torch.save``) to ``OUT``. ``--plant`` also runs the two negative
controls of the bitwise gate: :data:`PLANT_CELL` with rank 1 given the
wrong dp rows, and :data:`PLANT_RING` with rank 1 keeping the k block it
sent in its first hop between processes where it should take the one it
received. ``--four`` (four processes) runs :data:`FOUR_CELLS` only. The
script imports the port only.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from beholder_tpu_torch.dryrun import dryrun_multichip  # noqa: E402
from beholder_tpu_torch.models import (  # noqa: E402
    TelemetrySequenceModel,
    anomaly,
    init_seq_state,
    stream_features,
)
from beholder_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    collectives,
    gather_state,
    make_hybrid_mesh,
    pipeline_forward,
    pipeline_train_step,
    place_seq_state,
    place_state,
    place_zero_state,
    sharded_seq_train_step,
    sharded_train_step,
    stack_stage_grads,
    stage_specs,
    zero_train_step,
)

#: steps a cell takes (live Adam moments from the second on)
STEPS = 2
LR = 1e-3
#: the transformer cells' model
SEQ_MODEL = dict(dim=64, heads=4, kv_heads=2, layers=2)
B, T = 4, 64
#: name -> (kind, global mesh shape: (dp, tp) or (dp,), model kwargs)
CELLS = {
    "mlp dp=4 tp=2": ("mlp", (4, 2), {}),
    "tp full seq_shard=off": ("seq", (2, 2), dict(attention="full")),
    "tp full seq_shard=on": ("seq", (2, 2), dict(attention="full", seq_shard=True)),
    "tp flash seq_shard=off": ("seq", (2, 2), dict(attention="flash")),
    "tp flash seq_shard=on": ("seq", (2, 2), dict(attention="flash", seq_shard=True)),
    "zero-2 dp=4": ("zero2", (4,), dict(attention="full")),
    "zero-3 dp=4 remat flash": ("zero3", (4,), dict(attention="flash", remat=True)),
}
#: the planted control's cell (an MLP cell: its data is ``mlp_data()``)
PLANT_CELL = "mlp dp=4 tp=2"


def mlp_data():
    """256 windows of one job's progress (the chip leg's MLP data)."""
    rng = np.random.default_rng(3)
    progress = torch.from_numpy(np.cumsum(1.0 + rng.normal(0, 0.05, 256 + anomaly.WINDOW + 1)))
    return anomaly.make_windows(progress, torch.full((progress.shape[0],), 2))


def seq_data():
    rng = np.random.default_rng(5)
    prog = np.cumsum(1.5 + rng.normal(0, 0.1, (B, T + 1)), axis=-1)
    return stream_features(torch.from_numpy(prog), torch.from_numpy(np.full((B, T + 1), 2)))


def make_state(name: str):
    kind, _, kw = CELLS[name]
    if kind == "mlp":
        return anomaly.init_train_state(0, LR, device="cpu")
    model = TelemetrySequenceModel(**SEQ_MODEL, **kw, device="cpu")
    return init_seq_state(0, model, LR)


def cell_mesh(name: str, per_process: int | None = None):
    """The cell's mesh: over the process group with ``per_process`` CPU
    members a process, else (None) one process holding every member."""
    _, shape, _ = CELLS[name]
    tp = shape[1] if len(shape) == 2 else 1
    n = int(np.prod(shape))
    mesh = make_hybrid_mesh(tp, devices=["cpu"] * (per_process or n))
    return mesh.take(tp=0) if len(shape) == 1 else mesh


def digest(state) -> dict:
    """Per leaf, sha256 of the whole parameter's and Adam moments' bytes."""
    out = {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        h = hashlib.sha256()
        for t in (p.detach(), st["exp_avg"], st["exp_avg_sq"]):
            h.update(t.contiguous().cpu().numpy().tobytes())
        out[name] = h.hexdigest()
    return out


def run_cell(name: str, mesh, rows=None) -> dict:
    """STEPS steps of the cell on ``mesh``: the losses, the digest of the
    gathered state and its parameters. ``rows`` permutes the batch this
    process passes (the planted control)."""
    kind = CELLS[name][0]
    windows, targets = mlp_data() if kind == "mlp" else seq_data()
    if rows is not None:
        windows, targets = windows[rows], targets[rows]
    if kind == "mlp":
        state, step = place_state(make_state(name), mesh), sharded_train_step
    elif kind == "seq":
        state, step = place_seq_state(make_state(name), mesh), sharded_seq_train_step
    else:
        state = place_zero_state(make_state(name), mesh, shard_params=kind == "zero3")
        step = zero_train_step
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, windows, targets)
        losses.append(loss.item())
    whole = gather_state(state)
    return dict(losses=losses, digest=digest(whole),
                params={n: p.detach().clone() for n, p in whole.model.named_parameters()})


# -- collectives across processes inside a forward --------------------------------

#: name -> (kind, global mesh shape, axis names, the axis whose coordinate
#: names a member's process ("member": its flat index), kwargs). Each cell
#: runs on that mesh cut between the processes, and on one process
MOE_MODEL = dict(dim=16, heads=2, layers=1, ffn="moe", num_experts=4)
RING_MODEL = dict(dim=32, heads=4, kv_heads=2, layers=1)
SERVE_MODEL = dict(dim=32, heads=2, layers=2)
FORWARD_CELLS = {
    **{f"moe {r} along {cut}": ("moe", (2, 2), ("dp", "ep"), cut, kw)
       for cut in ("dp", "ep")
       for r, kw in (("top1", dict(moe_topk=1)), ("top2", dict(moe_topk=2)),
                     ("experts", dict(moe_router="experts")))},
    "gpipe pp=2": ("gpipe", (2,), ("pp",), "pp", {}),
    "gpipe dp=2 pp=2": ("gpipe", (2, 2), ("dp", "pp"), "pp", {}),
    "gpipe pp=4": ("gpipe", (4,), ("pp",), "pp", {}),
    "1f1b pp=2": ("1f1b", (2,), ("pp",), "pp", {}),
    "1f1b pp=4": ("1f1b", (4,), ("pp",), "pp", {}),
    "1f1b dp=2 pp=2": ("1f1b", (2, 2), ("dp", "pp"), "pp", dict(dp_axis="dp")),
    "1f1b dp=2 pp=2 tp=2": ("1f1b-tp", (2, 2, 2), ("dp", "pp", "tp"), "pp",
                            dict(dp_axis="dp")),
    # each stage's tp pair split between the two processes
    "1f1b pp=2 tp=2 along tp": ("1f1b-tp", (2, 2), ("pp", "tp"), "tp", {}),
    "serving dp=2": ("serving", (2,), ("dp",), "dp", {}),
    "serving dp=2 tp=2": ("serving", (2, 2), ("dp", "tp"), "dp", dict(megatron=True)),
    "ring sp=2 flash": ("attend", (2,), ("sp",), "sp", dict(fn="ring", backend="flash")),
    "ring sp=2 einsum": ("attend", (2,), ("sp",), "sp", dict(fn="ring", backend="einsum")),
    "ulysses sp=2 flash": ("attend", (2,), ("sp",), "sp", dict(fn="ulysses", backend="flash")),
    "ulysses sp=2 full": ("attend", (2,), ("sp",), "sp", dict(fn="ulysses", backend="full")),
    "ring step dp=2 tp=1 sp=2": ("sp-step", (2, 1, 2), ("dp", "tp", "sp"), "sp",
                                 dict(attention="ring")),
    "ulysses step dp=2 tp=1 sp=2": ("sp-step", (2, 1, 2), ("dp", "tp", "sp"), "sp",
                                    dict(attention="ulysses")),
}
#: the cells four processes run, one member each: every sp group crosses
#: two of the four, so its collectives run over a sub-group
FOUR_CELLS = {
    "ring step dp=2 sp=2 four processes": ("sp-step", (2, 2), ("dp", "sp"), "member",
                                           dict(attention="ring")),
    # one member a process: each stage's tp pair split between two of them,
    # every hop between stages crossing processes
    "1f1b pp=2 tp=2 four processes": ("1f1b-tp", (2, 2), ("pp", "tp"), "member", {}),
}
#: the model's own blocks as 1F1B stages (``pipeline_stages``) on (pp, tp)
#: = (2, 2), each stage's tp pair split between the two processes: the
#: stage runs its megatron blocks over the group's processes
#: (``mesh.members_mesh``); the flash model, cut along tp
BLOCK_CELLS = {"1f1b blocks pp=2 tp=2 along tp": ((2, 2), ("pp", "tp"), "tp")}
BLOCK_MODEL = dict(dim=32, heads=4, kv_heads=2, layers=2, attention="flash")
#: the second planted control's cell
PLANT_RING = "ring step dp=2 tp=1 sp=2"
#: the collectives ``along`` runs over one group of 4 members split 2 / 2
ALONG_OPS = {
    "all_reduce": {},
    "all_gather": dict(dim=0),
    "reduce_scatter": dict(dim=0),
    "all_to_all": dict(split_dim=0, concat_dim=1),
    "ring_shift": dict(shift=1),
    "tp_all_reduce": {},
    "tp_replicate": {},
    "scatter_to_members": dict(dim=0),
    "gather_from_members": dict(dim=1),
}
#: pipeline stages: S tanh layers of width PIPE_DIM; M microbatches of
#: PIPE_BM rows
PIPE_DIM, PIPE_M, PIPE_BM = 8, 4, 4
#: serving: streams, observed steps, prefill split, forecast horizon
SERVE_B, SERVE_T, SERVE_SPLIT, SERVE_HORIZON = 4, 16, 8, 6
#: attention inputs: (B, H, Hkv, T, Dh)
ATTEND_SHAPE = (1, 4, 2, 64, 8)


def cut_mesh(shape, names, cut: str, world: int = 1, rank: int = 0) -> Mesh:
    """The ``["cpu"]`` mesh of ``shape``: on one process when ``world`` is
    1, else cut ``world`` ways along ``cut`` (a member's process is its
    coordinate there times ``world`` over the axis' size; "member": its
    flat index)."""
    n = int(np.prod(shape))
    if world == 1:
        return Mesh(np.full(shape, "cpu", dtype=object).tolist(), names)
    coords = list(np.ndindex(*shape))
    if cut == "member":
        owners = [i * world // n for i in range(n)]
    else:
        k = names.index(cut)
        owners = [c[k] * world // shape[k] for c in coords]
    return Mesh(np.full(shape, "cpu", dtype=object).tolist(), names, owners=owners, rank=rank)


def cell_spec(name: str) -> tuple:
    return {**FORWARD_CELLS, **FOUR_CELLS}[name]


def forward_mesh(name: str, world: int = 1, rank: int = 0) -> Mesh:
    _, shape, names, cut, _ = cell_spec(name)
    return cut_mesh(shape, names, cut, world, rank)


def tensors_digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def moe_data():
    """4 streams of 16 steps: two dp rows of 32 tokens, four groups of 16."""
    rng = np.random.default_rng(9)
    prog = np.cumsum(1.5 + rng.normal(0, 0.1, (4, 17)), axis=-1)
    return stream_features(torch.from_numpy(prog), torch.from_numpy(np.full((4, 17), 2)))


def sp_data():
    rng = np.random.default_rng(8)
    prog = np.cumsum(1.5 + rng.normal(0, 0.1, (4, 33)), axis=-1)
    return stream_features(torch.from_numpy(prog), torch.from_numpy(np.full((4, 33), 2)))


def train_model(name: str, mesh) -> TelemetrySequenceModel:
    kind, _, _, _, kw = cell_spec(name)
    if kind == "moe":
        return TelemetrySequenceModel(**MOE_MODEL, **kw, mesh=mesh, device="cpu")
    return TelemetrySequenceModel(**RING_MODEL, **kw, mesh=mesh, device="cpu")


def pipe_stages(seed: int, n: int) -> dict:
    """``n`` stacked ``{"w", "b"}`` tanh stages, numpy from a seed."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(n, PIPE_DIM, PIPE_DIM)) / np.sqrt(PIPE_DIM)).astype(np.float32),
            "b": (rng.normal(size=(n, PIPE_DIM)) * 0.1).astype(np.float32)}


def megatron_stages() -> tuple:
    """Two stacked megatron stages (``w1`` column-, ``w2`` row-parallel)
    and their specs."""
    rng = np.random.default_rng(20)
    params = {"w1": (rng.normal(size=(2, PIPE_DIM, 16)) * 0.3).astype(np.float32),
              "w2": (rng.normal(size=(2, 16, PIPE_DIM)) * 0.3).astype(np.float32)}
    return params, {"w1": ("pp", None, "tp"), "w2": ("pp", "tp", None)}


def pipe_data(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(PIPE_M, PIPE_BM, PIPE_DIM)).astype(np.float32)


def t_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def t_loss(out, y):
    return torch.mean((out - y) ** 2)


def megatron_stage(ps, xs):
    """Megatron's pair over the stage's tp group: ``xs`` the members'
    inputs this process holds (a ``Members`` where the group is split
    between processes, which the lists handed to the collectives keep)."""
    hs = [torch.nn.functional.gelu(a @ p["w1"], approximate="tanh")
          for a, p in zip(collectives.tp_replicate(xs), ps)]
    parts = collectives.tp_all_reduce(collectives.like(xs, [h @ p["w2"]
                                                            for h, p in zip(hs, ps)]))
    return [a + b for a, b in zip(xs, parts)]


def serve_data():
    rng = np.random.default_rng(1)
    prog = np.cumsum(2.0 + rng.normal(0, 0.3, (SERVE_B, SERVE_T + 1)), axis=-1)
    return (torch.from_numpy(prog.astype(np.float32)),
            torch.from_numpy(np.full((SERVE_B, SERVE_T + 1), 2)))


def serve_model() -> TelemetrySequenceModel:
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params

    model = TelemetrySequenceModel(**SERVE_MODEL, device="cpu")
    return load_flax_params(model, init_params(model, 3))


def attend_inputs():
    b, h, hkv, t, d = ATTEND_SHAPE
    rng = np.random.default_rng(12)
    q = rng.normal(size=(b, h, t, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, t, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _train(state, step, data, steps: int = STEPS) -> dict:
    losses = []
    for _ in range(steps):
        state, loss = step(state, *data)
        losses.append(loss.item())
    whole = gather_state(state)
    return dict(losses=losses, digest=digest(whole),
                params={n: p.detach().clone() for n, p in whole.model.named_parameters()})


def run_forward_cell(name: str, mesh) -> dict:
    """The cell on ``mesh``: ``out`` its results (tensors, the same on every
    process), ``digest`` their bytes' hash; a training cell's ``losses``
    and per-leaf ``digest`` as :func:`run_cell` gives them."""
    from beholder_tpu_torch.models import (
        serving_params, sharded_decode_step, sharded_forecast_eta, sharded_prefill,
    )
    from beholder_tpu_torch.models.sequence import one_hot
    from beholder_tpu_torch.ops import NUM_STATUSES
    from beholder_tpu_torch.ops.attention import ring_attention, ulysses_attention
    from beholder_tpu_torch.parallel import seq_state_shardings, stack_stage_params

    kind, shape, names, _, kw = cell_spec(name)
    if kind in ("moe", "sp-step"):
        data = moe_data() if kind == "moe" else sp_data()
        state = place_seq_state(init_seq_state(0, train_model(name, mesh)), mesh)
        return _train(state, sharded_seq_train_step, data)
    if kind == "gpipe":
        stacked = {n: t.requires_grad_() for n, t in _port_stages(pipe_stages(4, shape[-1]))
                   .items()}
        out = pipeline_forward(t_stage, stacked, torch.from_numpy(pipe_data(5)), mesh)
        grads = torch.autograd.grad((out ** 2).sum(), list(stacked.values()))
        res = [out.detach(), *grads]
    elif kind in ("1f1b", "1f1b-tp"):
        if kind == "1f1b":
            stacked, specs, stage = _port_stages(pipe_stages(10, shape[-1])), None, t_stage
        else:
            params, specs = megatron_stages()
            stacked, stage = {n: torch.from_numpy(a) for n, a in params.items()}, megatron_stage
        x, y = torch.from_numpy(pipe_data(11)), torch.from_numpy(pipe_data(12))
        loss, grads = pipeline_train_step(stage, t_loss, stacked, x, y, mesh,
                                          param_specs=specs, **kw)
        specs = specs or stage_specs(stacked)
        whole = stack_stage_grads(grads, mesh, specs)
        res = [loss.detach(), *(whole[n] for n in sorted(whole))]
    elif kind == "serving":
        model = serve_model()
        specs = seq_state_shardings(model, mesh) if kw.get("megatron") else None
        params = serving_params(model, mesh, specs)
        progress, statuses = serve_data()
        feats, _ = stream_features(progress, statuses)
        pre = sharded_prefill(model, mesh, SERVE_T + SERVE_HORIZON, params_shardings=specs)
        step = sharded_decode_step(model, mesh, params_shardings=specs)
        with torch.no_grad():
            _, cache = pre(params, feats[:, :SERVE_SPLIT])
            tf = []
            for i in range(SERVE_SPLIT, SERVE_T):
                p, cache = step(params, cache, feats[:, i])
                tf.append(p)
            status = one_hot(statuses[:, -1], NUM_STATUSES)
            delta, cache = pre(params, feats)
            deltas = []
            for _ in range(SERVE_HORIZON):
                deltas.append(delta)
                delta, cache = step(params, cache, torch.cat([delta[:, None], status], -1))
            deltas = torch.stack(deltas, 1)
            target = float((progress[:, -1] + deltas.sum(-1)).median())
            eta, reached = sharded_forecast_eta(model, mesh, SERVE_HORIZON, target,
                                                params_shardings=specs)(params, progress,
                                                                        statuses)
        res = [torch.stack(tf, 1), deltas, eta, reached]
    else:
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in attend_inputs())
        fn = ring_attention if kw["fn"] == "ring" else ulysses_attention
        out = fn(q, k, v, mesh, causal=True, backend=kw["backend"])
        grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
        res = [out.detach(), *grads]
    return dict(out=[t.detach().clone() for t in res], digest=tensors_digest(res))


def block_inputs():
    """The block cell's model (seed 0, frozen), stage inputs (M=2 of 2
    rows, T=16, dim 32), targets and loss (its ``ln`` + ``head`` + MSE)."""
    from beholder_tpu_torch.models import TelemetrySequenceModel

    model = init_seq_state(0, TelemetrySequenceModel(**BLOCK_MODEL, device="cpu")).model
    model.requires_grad_(False)
    rng = np.random.default_rng(21)
    h = torch.from_numpy(rng.normal(size=(2, 2, 16, BLOCK_MODEL["dim"])).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 2, 16)).astype(np.float32))

    def loss_fn(out, target):
        return ((model.head(model.ln(out))[..., 0] - target) ** 2).mean()

    return model, h, y, loss_fn


def run_block_cell(name: str, mesh) -> dict:
    """The block cell on ``mesh``: ``out`` the loss and the whole stacked
    gradients (sorted by name), ``digest`` their bytes' hash."""
    from beholder_tpu_torch.models import pipeline_stages
    from beholder_tpu_torch.parallel import stack_stage_params
    from beholder_tpu_torch.parallel.sharding import seq_spec

    model, h, y, loss_fn = block_inputs()
    stage_fn, params = pipeline_stages(model, mesh.shape["pp"])
    stacked = stack_stage_params(params)
    specs = stage_specs(stacked, rule=seq_spec)
    loss, grads = pipeline_train_step(stage_fn, loss_fn, stacked, h, y, mesh,
                                      param_specs=specs)
    whole = stack_stage_grads(grads, mesh, specs)
    res = [loss.detach(), *(whole[n] for n in sorted(whole))]
    return dict(out=[t.detach().clone() for t in res], names=sorted(whole),
                digest=tensors_digest(res))


def _port_stages(stacked_np: dict) -> dict:
    from beholder_tpu_torch.models.bridge import flax_stage_params

    return flax_stage_params(stacked_np)


def along_inputs(i: int):
    """Member ``i``'s input and the weights of its output in the loss
    (some ``-0.0``), from numpy seeds."""
    rng = np.random.default_rng(30 + i)
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    w = rng.normal(size=(4, 8)).astype(np.float32)
    w[0, :3] = -0.0
    return x, w


def run_along(op: str, mesh) -> dict:
    """``along(mesh, "x", op)`` on the members this process holds, forward
    and backward (the gradient of each output times its member's
    weights, summed): ``{member: (output, input gradient)}``."""
    xs = [along_inputs(i)[0].requires_grad_() for i in mesh.local]
    outs = collectives.along(mesh, "x", getattr(collectives, op), xs, **ALONG_OPS[op])
    loss = sum((o * torch.from_numpy(np.resize(along_inputs(i)[1], o.shape))).sum()
               for i, o in zip(mesh.local, outs))
    grads = torch.autograd.grad(loss, xs)
    return {i: (o.detach().clone(), g.clone()) for i, o, g in zip(mesh.local, outs, grads)}


def along_mesh(world: int = 1, rank: int = 0) -> Mesh:
    return cut_mesh((4,), ("x",), "x", world, rank)


class planted_ring:
    """Rank 1 keeps, in its first ring hop between processes, the k
    block it sent where it should take the one it received (the second
    negative control)."""

    def __init__(self, rank: int):
        from beholder_tpu_torch.ops import attention

        self.attention, self.rank, self.real = attention, rank, attention._rotate

    def __enter__(self):
        done = []

        def rotate(blocks):
            out = self.real(blocks)
            if self.rank == 1 and not done and isinstance(blocks, collectives.Members):
                done.append(True)
                return collectives.Members(list(blocks), blocks.group)
            return out

        self.attention._rotate = rotate
        return self

    def __exit__(self, *exc):
        self.attention._rotate = self.real


def mesh_facts(per_process: int) -> dict:
    """The global mesh's layout over the group, and the texts of the
    refusals ``make_hybrid_mesh`` gives (every rank takes part in each)."""
    from beholder_tpu_torch.parallel import process_index

    mesh = make_hybrid_mesh(2, devices=["cpu"] * per_process)
    out = dict(shape=tuple(mesh.grid.shape), axis_names=mesh.axis_names, owners=mesh.owners,
               local=mesh.local, rank=process_index(), shape_tp1=tuple(
                   make_hybrid_mesh(1, devices=["cpu"] * per_process).grid.shape))
    errors = {}
    for key, ici_tp, devices in (("ici_tp=8", 8, per_process), ("ici_tp=3", 3, per_process),
                                 ("uneven", 2, 2 + 4 * process_index())):
        try:
            make_hybrid_mesh(ici_tp, devices=["cpu"] * devices)
        except ValueError as err:
            errors[key] = str(err)
    out["errors"] = errors
    return out


def main(argv: list[str]) -> None:
    import torch.distributed as dist

    from beholder_tpu_torch.parallel import initialize

    rank, world, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", num_processes=world, process_id=rank, device="cpu",
               timeout_s=60)
    try:
        if "--four" in argv:
            results = {name: run_forward_cell(name, forward_mesh(name, world, rank))
                       for name in FOUR_CELLS}
            torch.save(results, out)
            return
        results = {"mesh": mesh_facts(4)}
        for name, (_, shape, _) in CELLS.items():
            results[name] = run_cell(name, cell_mesh(name, int(np.prod(shape)) // world))
        for name in FORWARD_CELLS:
            results[name] = run_forward_cell(name, forward_mesh(name, world, rank))
        results["along"] = {op: run_along(op, along_mesh(world, rank)) for op in ALONG_OPS}
        results["blocks"] = {name: run_block_cell(name, cut_mesh(shape, names, cut, world, rank))
                             for name, (shape, names, cut) in BLOCK_CELLS.items()}
        results["dryrun"] = dryrun_multichip(8, devices=["cpu"] * (8 // world))
        if "--plant" in argv:
            n = mlp_data()[0].shape[0]
            rows = torch.arange(n).roll(n // 2) if rank == 1 else None
            shape = CELLS[PLANT_CELL][1]
            results["planted"] = run_cell(
                PLANT_CELL, cell_mesh(PLANT_CELL, int(np.prod(shape)) // world), rows)
            with planted_ring(rank):
                results["planted ring"] = run_forward_cell(
                    PLANT_RING, forward_mesh(PLANT_RING, world, rank))
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
