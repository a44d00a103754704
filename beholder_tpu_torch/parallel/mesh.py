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
tensor parallel axes (``dp``, ``tp``) are not ported as mesh axes.

:func:`serving_shard_devices` places the serving cluster's workers
(:mod:`beholder_tpu_torch.cluster`) the same way: one process, one device
(or one group of devices) per worker, cycling over the devices it is
given. :func:`seq_param_slices` is the reference's megatron rule
(``_seq_spec_for``) over the port's ``state_dict`` names, which a decode
group (:mod:`beholder_tpu_torch.cluster.group`) keeps its weights in.
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

    ``group_size=N`` (group-parallel decode) returns N-tuples instead:
    worker ``i`` owns the contiguous block ``[i*N, (i+1)*N)`` (mod the
    device count), so blocks never straddle the wrap-around. The device
    count must divide by N. A device may repeat, so ``["cuda:0"] * 4``
    gives two groups of two on one card."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
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
    if group_size == 1:
        return [devices[i % len(devices)] for i in range(n_workers)]
    if len(devices) % group_size:
        raise ValueError(
            f"group_size {group_size} does not divide the device count {len(devices)}"
        )
    return [
        tuple(devices[(i * group_size + m) % len(devices)] for m in range(group_size))
        for i in range(n_workers)
    ]


#: megatron tensor parallelism over the port's ``state_dict`` names:
#: column-parallel layers split their output features, row-parallel ones
#: their input features. ``nn.Linear.weight`` is (out, in), the transpose of
#: flax's kernel, so a column layer splits dim 0 of its weight (and its
#: bias) and a row layer dim 1 (its bias stays whole).
_COLUMN = ("q_proj", "k_proj", "v_proj", "up")
_ROW = ("proj", "down")


def seq_split_dim(name: str, tensor: torch.Tensor) -> int | None:
    """The dim the reference's ``_seq_spec_for`` shards ``name`` along over
    the ``tp`` axis, in the port's layout, or None for a replicated leaf
    (embedding, head, LayerNorms, row-layer biases)."""
    parts = name.split(".")
    if any(p in _COLUMN for p in parts):
        if tensor.ndim == 2 and parts[-1] == "weight":
            return 0
        if tensor.ndim == 1 and parts[-1] == "bias":
            return 0
    if any(p in _ROW for p in parts) and tensor.ndim == 2 and parts[-1] == "weight":
        return 1
    return None


def seq_param_slices(state_dict: dict, size: int, devices=None) -> list[dict]:
    """Member ``m``'s slice of every parameter under the megatron rule
    (:func:`seq_split_dim`): ``size`` dicts, each a copy of its own on
    ``devices[m]`` (where it already lies when None). Concatenating the
    members' slices along each leaf's split dim
    (:func:`seq_params_from_slices`) gives back the full tensors bit for
    bit."""
    out = []
    for m in range(size):
        member = {}
        dev = devices[m] if devices is not None else None
        for name, t in state_dict.items():
            dim = seq_split_dim(name, t)
            if dim is not None:
                if t.shape[dim] % size:
                    raise ValueError(
                        f"{name}: dim {dim} of {tuple(t.shape)} does not split {size} ways"
                    )
                w = t.shape[dim] // size
                t = t.narrow(dim, m * w, w)
            member[name] = t.to(dev if dev is not None else t.device, copy=True).contiguous()
        out.append(member)
    return out


def seq_params_from_slices(slices: list[dict], device) -> dict:
    """The full parameters on ``device`` from member slices: a bitwise copy,
    each split leaf concatenated along its split dim, each replicated leaf
    taken from member 0."""
    out = {}
    for name, t in slices[0].items():
        dim = seq_split_dim(name, t)
        if dim is None:
            out[name] = t.to(device)
        else:
            out[name] = torch.cat([s[name].to(device) for s in slices], dim=dim)
    return out
