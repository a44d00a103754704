"""The multi-process runtime entry and the hybrid ``(dp, tp)`` mesh: the
port's counterpart of the reference's ``parallel/distributed.py``.

1. every process calls :func:`initialize` (``torch.distributed``'s process
   group; a no-op for single-process runs, so one entry point serves a
   workstation and a cluster);
2. :func:`make_hybrid_mesh` builds the ``("dp", "tp")`` mesh whose ``tp``
   axis holds neighbouring devices (one host's NVLink domain) and whose
   ``dp`` axis spans the rest.

The port's :class:`~beholder_tpu_torch.parallel.mesh.Mesh` is
single-controller: one process holds every member and drives each in turn.
The reference's mesh over every process's devices has no counterpart yet,
so :func:`make_hybrid_mesh` refuses a process group of more than one
process (``NotImplementedError``) instead of building a mesh that spans
only this process's cards.
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


def make_hybrid_mesh(ici_tp: int = 2, axis_names=("dp", "tp"), devices=None) -> Mesh:
    """A 2-D mesh of shape ``(n // ici_tp, ici_tp)`` over ``devices``
    (every visible CUDA device when None, raising when there is none), so
    ``tp`` holds neighbouring devices and ``dp`` spans the rest. A single
    process gets a plain mesh with the same axis names, as in the
    reference, so calling code never branches."""
    devices = _visible_devices(devices)
    n = len(devices)
    if ici_tp > n or n % ici_tp:
        raise ValueError(f"ici_tp={ici_tp} does not divide device count {n}")
    procs = process_count()
    if procs > 1:
        raise NotImplementedError(
            f"make_hybrid_mesh over {procs} processes: the port's Mesh is "
            "single-controller and spans one process's devices; a mesh over "
            "every process's devices is not ported"
        )
    return Mesh([devices[r * ici_tp:(r + 1) * ici_tp] for r in range(n // ici_tp)],
                tuple(axis_names))

