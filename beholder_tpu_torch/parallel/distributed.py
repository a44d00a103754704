"""The multi-process runtime entry and the hybrid ``(dp, tp)`` mesh: the
port's counterpart of the reference's ``parallel/distributed.py``.

1. every process calls :func:`initialize` (``torch.distributed``'s process
   group; a no-op for single-process runs, so one entry point serves a
   workstation and a cluster);
2. :func:`make_hybrid_mesh` builds the ``("dp", "tp")`` mesh whose ``tp``
   axis holds neighbouring devices (one host's NVLink domain) and whose
   ``dp`` axis spans the rest: over every process's devices when a group of
   more than one process was joined, ``dp`` across processes and ``tp``
   inside each, as the reference's hybrid ICI/DCN mesh;
3. the training steps run on that mesh as on one process's: each process
   drives the members it holds (:attr:`Mesh.local`), and the sums over
   ``dp`` gather across processes in member order, so the model code does
   not change.

Every path runs on a mesh over processes: the sharded steps and ZeRO, MoE
expert parallelism, GPipe and 1F1B, dp-sharded serving, and ring and
Ulysses attention. Each process computes its own members only; the
collectives of a group split between processes move bytes through the
process group and repeat the one-process member-order sums
(:mod:`~beholder_tpu_torch.parallel.collectives`), so the results are
bitwise the one-process mesh's. Any mesh over processes is a ``Mesh`` given
``owners`` (one rank a member, row-major) and this process's ``rank``;
:func:`make_hybrid_mesh` lays out two axes with the first across processes.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

from beholder_tpu_torch.device import resolve_device

from .mesh import Mesh, _visible_devices

#: torch's launcher default for ``MASTER_PORT``
DEFAULT_PORT = 29500


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float | None = None,
) -> None:
    """Join the process group when running multi-process.

    ``coordinator_address`` is ``host`` or ``host:port``; omitted, it is
    ``MASTER_ADDR`` (and the port ``MASTER_PORT``, default 29500), and
    ``num_processes`` / ``process_id`` default to ``WORLD_SIZE`` / ``RANK``
    (1 and 0), torch's launcher variables. With no address at all this is
    a no-op. The backend follows ``device``: ``nccl`` on the card (``None``,
    raising when there is none), ``gloo`` only when the caller names the
    CPU. ``timeout_s`` bounds the rendezvous and every collective."""
    address = coordinator_address or os.environ.get("MASTER_ADDR")
    if address is None:
        return  # single-process
    host, _, port = address.rpartition(":") if ":" in address else (address, "", "")
    port = port or os.environ.get("MASTER_PORT", str(DEFAULT_PORT))
    # NB: `x or env` would silently override an explicit process_id=0 with
    # a stale env var, corrupting cluster membership — test for None
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{host}:{port}",
        world_size=num_processes,
        rank=process_id,
        **kwargs,
    )


def process_count() -> int:
    """The process group's size, 1 when none was joined (the counterpart
    of ``jax.process_count()``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the group, 0 when none was joined (the
    counterpart of ``jax.process_index()``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def make_hybrid_mesh(ici_tp: int = 2, axis_names=("dp", "tp"), devices=None) -> Mesh:
    """A 2-D mesh of shape ``(n // ici_tp, ici_tp)`` over ``devices`` (this
    process's: every visible CUDA device when None, raising when there is
    none), so ``tp`` holds neighbouring devices and ``dp`` spans the rest. A
    single process gets a plain mesh with the same axis names, as in the
    reference, so calling code never branches.

    In a group of P processes ``n`` counts every process's devices (the
    processes gather their lists first): each must bring ``n / P`` of them,
    divisible by ``ici_tp``, and process ``p`` holds dp rows ``[p * R, (p +
    1) * R)`` with ``R = n / P / ici_tp``, as the reference's
    ``dcn_mesh_shape=(P, 1)`` lays them out. A one-axis ``("dp",)`` mesh over
    processes, ZeRO's, is ``make_hybrid_mesh(1).take(tp=0)``."""
    devices = _visible_devices(devices)
    procs = process_count()
    if procs == 1:
        n = len(devices)
        if ici_tp > n or n % ici_tp:
            raise ValueError(f"ici_tp={ici_tp} does not divide device count {n}")
        return Mesh([devices[r * ici_tp:(r + 1) * ici_tp] for r in range(n // ici_tp)],
                    tuple(axis_names))
    lists = [None] * procs
    dist.all_gather_object(lists, [str(d) for d in devices])
    n = sum(len(ds) for ds in lists)
    if ici_tp > n or n % ici_tp:
        raise ValueError(f"ici_tp={ici_tp} does not divide device count {n}")
    # one slice a process, as the reference assumes: each process's share
    # of dp must be a whole number of tp groups
    per_slice = n // procs
    if any(len(ds) != per_slice for ds in lists) or per_slice % ici_tp:
        raise ValueError(
            f"{n} devices over {procs} processes with ici_tp={ici_tp}: "
            "need devices evenly split per process and divisible by "
            "ici_tp; for multi-host-per-slice topologies build the "
            "hybrid mesh explicitly with mesh_utils"
        )
    rows = [ds[r * ici_tp:(r + 1) * ici_tp] for ds in lists for r in range(per_slice // ici_tp)]
    owners = [p for p in range(procs) for _ in range(per_slice)]
    return Mesh(rows, tuple(axis_names), owners=owners, rank=dist.get_rank())

