"""A device mesh with one sequence-parallel axis: the port's counterpart of
the ``jax.sharding.Mesh(devices, ("sp",))`` that the reference's ring
attention runs on.

The port drives the mesh from one process, as JAX's single controller
does: the caller holds every shard, runs each ring step for every shard,
and moves a block to the next device with :meth:`Mesh.to`. That move is a
peer copy when two devices differ and nothing when they are the same. A
device may repeat, so ``Mesh(["cuda:0"] * 4)`` runs a ring of four shards
on one card (the counterpart of the virtual CPU devices the reference's
ring tests use); such a ring moves no bytes between devices. Data and
tensor parallel axes (``dp``, ``tp``) are not ported.

:func:`serving_shard_devices` places the serving cluster's workers
(:mod:`beholder_tpu_torch.cluster`) the same way: one process, one device
per worker, cycling over the devices it is given.
"""

from __future__ import annotations

import torch


class Mesh:
    """Ordered devices along the ``sp`` axis. ``shape["sp"]`` is the ring
    size, ``devices[i]`` holds shard ``i`` (rows ``i*T/P .. (i+1)*T/P``)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = ("sp",)
        self.shape = {"sp": len(self.devices)}

    def to(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """``x`` on the mesh's device ``i`` (the same tensor when it is
        there already)."""
        return x.to(self.devices[i])


def serving_shard_devices(n_workers: int, group_size: int = 1, devices=None) -> list:
    """One device per serving worker (decode shards first, then prefill
    workers), cycling over ``devices``: every visible CUDA device when
    ``None`` (raising when there is none), or the list given, e.g.
    ``["cpu"]``. More workers than devices share them round-robin, and a
    transfer between two workers on one device moves no bytes.
    ``group_size > 1`` (group-parallel decode) is not ported yet."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    if group_size > 1:
        raise NotImplementedError(
            "group-parallel decode (group_size > 1) is not ported yet (ROADMAP A.4)"
        )
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: serving workers run on the card by default; "
                "pass devices=['cpu'] to run the plain PyTorch path"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("serving_shard_devices needs at least one device")
    return [devices[i % len(devices)] for i in range(n_workers)]
