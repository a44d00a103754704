"""The cells of ``tests/test_torch_multiprocess.py``: the port's sharded
steps and ZeRO on a mesh over processes, at small sizes on the CPU.

Imported by the test (the one-process runs of the same cells) and run as a
script, one process a rank of a ``gloo`` group::

    python tests/torch_mp_cells.py RANK WORLD PORT OUT [--plant]

Each rank joins the group through the port's ``initialize``, runs every
cell of :data:`CELLS` on ``make_hybrid_mesh`` over the group, and writes
its results (``torch.save``) to ``OUT``, then ``dryrun_multichip(8)``
over the group (its cells that may span processes). ``--plant`` also runs
:data:`PLANT_CELL` with rank 1 given the wrong dp rows (the negative
control of the bitwise gate). The script imports the port only.
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
    gather_state,
    make_hybrid_mesh,
    place_seq_state,
    place_state,
    place_zero_state,
    sharded_seq_train_step,
    sharded_train_step,
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
        results = {"mesh": mesh_facts(4)}
        for name, (_, shape, _) in CELLS.items():
            results[name] = run_cell(name, cell_mesh(name, int(np.prod(shape)) // world))
        results["dryrun"] = dryrun_multichip(8, devices=["cpu"] * (8 // world))
        if "--plant" in argv:
            n = mlp_data()[0].shape[0]
            rows = torch.arange(n).roll(n // 2) if rank == 1 else None
            shape = CELLS[PLANT_CELL][1]
            results["planted"] = run_cell(
                PLANT_CELL, cell_mesh(PLANT_CELL, int(np.prod(shape)) // world), rows)
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
