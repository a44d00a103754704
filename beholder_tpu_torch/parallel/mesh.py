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
