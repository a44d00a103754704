"""Specs and the cutting of a ``state_dict`` into member shards: the port's
counterpart of the reference's ``parallel/sharding.py``.

A spec is a leaf's split: a tuple with one entry a dim, each a mesh axis
name or None (the counterpart of a ``PartitionSpec``; ``()`` is
replicated). It is given over the port's ``state_dict`` names and layout:
an ``nn.Linear`` weight is ``(out, in)``, the transpose of flax's kernel, so
a column-parallel layer splits dim 0 where the reference's kernel splits
dim 1. A spec rule maps ``(name, tensor)`` to a spec; the rules here are the
reference's: the anomaly MLP's (:func:`mlp_spec`), megatron's for the
transformer (:func:`seq_spec`), the expert stacks' (:func:`expert_spec`),
ZeRO's shape rule (:func:`zero_leaf_spec`) and the pipeline's stacked
stages (:func:`leading_axis_spec`, :func:`stage_spec`: the leading stage dim
over ``pp``, with a rule for the rest of each stage's leaf).

:func:`shard_tensors` cuts named tensors (params, or Adam moments keyed the
same way) into one dict a mesh member, each slice a copy of its own on the
member's device; :func:`unshard_tensors` puts them back, bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch

Spec = tuple

#: leaves smaller than this stay replicated under ZeRO: a collective a step
#: costs more than the bytes it would save (the reference's own rule)
MIN_SHARD_ELEMENTS = 1024

#: megatron tensor parallelism: column-parallel layers split their output
#: features, row-parallel ones their input features (the reference's
#: ``_COLUMN`` / ``_ROW``)
COLUMN = ("q_proj", "k_proj", "v_proj", "up")
ROW = ("proj", "down")


def seq_split_dim(name: str, tensor: torch.Tensor) -> int | None:
    """The dim the reference's ``_seq_spec_for`` shards ``name`` along over
    the ``tp`` axis, in the port's layout, or None for a replicated leaf
    (embedding, head, LayerNorms, row-layer biases)."""
    parts = name.split(".")
    if any(p in COLUMN for p in parts):
        if tensor.ndim == 2 and parts[-1] == "weight":
            return 0
        if tensor.ndim == 1 and parts[-1] == "bias":
            return 0
    if any(p in ROW for p in parts) and tensor.ndim == 2 and parts[-1] == "weight":
        return 1
    return None


def _split(ndim: int, dim: int | None, axis: str) -> Spec:
    if dim is None:
        return ()
    return tuple(axis if i == dim else None for i in range(ndim))


def seq_spec(name: str, tensor: torch.Tensor) -> Spec:
    """Megatron over ``tp`` (the reference's ``_seq_spec_for``): q/k/v/up
    split their output features with their bias, proj/down their input
    features; the rest is replicated."""
    return _split(tensor.ndim, seq_split_dim(name, tensor), "tp")


def mlp_spec(name: str, tensor: torch.Tensor) -> Spec:
    """The anomaly MLP over ``tp`` (the reference's ``_spec_for``):
    ``in_proj`` column-parallel (weight dim 0 and its bias), ``mid_proj``
    row-parallel (weight dim 1; its bias is added once, after the sum)."""
    parts = name.split(".")
    if parts[0] == "in_proj":
        return _split(tensor.ndim, 0, "tp")
    if parts[0] == "mid_proj" and parts[-1] == "weight":
        return _split(tensor.ndim, 1, "tp")
    return ()


def is_expert(name: str) -> bool:
    return any(p.startswith("expert_") for p in name.split("."))


def expert_spec(name: str, tensor: torch.Tensor, axis: str = "ep") -> Spec:
    """Expert stacks (``expert_up`` (E, D, F), ``expert_down`` (E, F, D) and
    their biases) split along E over ``axis``; the rest replicated (the
    reference's ``expert_specs``)."""
    return _split(tensor.ndim, 0, axis) if is_expert(name) and tensor.ndim else ()


def zero_leaf_spec(tensor: torch.Tensor, dp: int, axis: str = "dp") -> Spec:
    """ZeRO: the largest dim divisible by ``dp`` (the first of equals), or
    replicated below :data:`MIN_SHARD_ELEMENTS` or when none divides."""
    shape = tuple(tensor.shape)
    if not shape or tensor.numel() < MIN_SHARD_ELEMENTS:
        return ()
    divisible = [i for i, d in enumerate(shape) if d % dp == 0 and d >= dp]
    if not divisible:
        return ()
    return _split(len(shape), max(divisible, key=lambda i: shape[i]), axis)


def leading_axis_spec(tensor: torch.Tensor, axis: str) -> Spec:
    """``(axis, None, ...)`` over the leading dim; replicated for a 0-d
    tensor, which has no dim to split."""
    return _split(tensor.ndim, 0, axis) if tensor.ndim else ()


def stage_spec(name: str, stacked: torch.Tensor, axis: str = "pp",
               rule: Callable[[str, torch.Tensor], Spec] | None = None) -> Spec:
    """A stacked stage leaf's spec: the leading (stage) dim over ``axis``,
    and each stage's own leaf (``stacked[0]``) split by ``rule`` when given
    (megatron's :func:`seq_spec` for tensor parallelism inside the stages),
    else replicated."""
    inner = tuple(rule(name, stacked[0])) if rule is not None else ()
    return (axis,) + (inner or (None,) * (stacked.ndim - 1))


def specs_for(tensors: dict, rule: Callable[[str, torch.Tensor], Spec]) -> dict:
    return {name: tuple(rule(name, t)) for name, t in tensors.items()}


def _index(mesh, coords: tuple, axis: str) -> int:
    return coords[mesh.axis_names.index(axis)]


def _slice(tensor: torch.Tensor, spec: Spec, mesh, coords: tuple) -> torch.Tensor:
    """The slice of ``tensor`` that the member at ``coords`` holds (a view)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if tensor.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(tensor.shape)} does not split {n} ways over {axis!r}"
            )
        w = tensor.shape[dim] // n
        tensor = tensor.narrow(dim, _index(mesh, coords, axis) * w, w)
    return tensor


def shard_tensors(tensors: dict, specs: dict, mesh) -> list[dict]:
    """One dict a member this process holds (``mesh.local``, row-major
    order): each tensor's slice under its spec, a contiguous copy of its own
    on the member's device."""
    return [
        {name: _slice(t, specs[name], mesh, c).to(dev, copy=True).contiguous()
         for name, t in tensors.items()}
        for c, dev in zip(mesh.local_coords(), mesh.local_devices)
    ]


def _unshard(members: list[dict], name: str, spec: Spec, mesh, device) -> torch.Tensor:
    """The whole tensor ``name`` on ``device`` from every mesh member's
    slices (one dict a member, all of them: on a mesh over processes, what
    :func:`~.collectives.process_gather` returns): concatenated along each
    split dim, taken at coordinate 0 of every axis it is replicated over. A
    bitwise copy."""
    coords = mesh.coords()

    def build(fixed: dict, dims: list) -> torch.Tensor:
        if not dims:
            at = tuple(fixed.get(a, 0) for a in mesh.axis_names)
            return members[coords.index(at)][name].to(device)
        dim, axis = dims[0]
        return torch.cat(
            [build({**fixed, axis: i}, dims[1:]) for i in range(mesh.shape[axis])], dim=dim
        )

    return build({}, [(d, a) for d, a in enumerate(spec) if a is not None])


def unshard_tensors(members: list[dict], specs: dict, mesh, device) -> dict:
    return {name: _unshard(members, name, specs[name], mesh, device) for name in specs}


def batch_slices(mesh, x: torch.Tensor, axis: str = "dp") -> list:
    """The slice of the whole batch ``x`` (dim 0) of each member this
    process holds, by its global ``axis`` coordinate (the whole batch on a
    mesh without that axis), on its device. Every process of a mesh over
    processes passes the same whole batch."""
    n = mesh.shape.get(axis, 1)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split {n} ways over {axis}")
    k = mesh.axis_names.index(axis) if axis in mesh.axis_names else None
    chunks = x.chunk(n, dim=0)
    return [chunks[c[k] if k is not None else 0].to(dev)
            for c, dev in zip(mesh.local_coords(), mesh.local_devices)]
