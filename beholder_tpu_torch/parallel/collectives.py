"""Collectives over a list of member tensors: the port's counterpart of the
``shard_map`` collectives and of what GSPMD inserts in the reference.

One process holds every member's tensor of a group and a collective is a
function from the members' inputs to the members' outputs, each output on
its member's device (the input's device). Sums run in member
order 0..N-1 on member 0's device, so every member gets the same bits, and
a move between two members on one device copies nothing. Each op is a
``torch.autograd.Function`` whose backward is the adjoint of its forward:

- :func:`all_reduce` (sum) and its adjoint, the same sum of the cotangents;
- :func:`all_gather` (cat along ``dim``) and :func:`reduce_scatter` (sum,
  then member ``i`` keeps chunk ``i`` along ``dim``), each other's adjoint;
- :func:`all_to_all` (member ``i`` splits along ``split_dim``; member ``j``
  concatenates the ``j``-th chunks along ``concat_dim``), whose adjoint is
  the reverse exchange;
- :func:`ring_shift` (member ``j`` receives member ``j - shift``'s tensor),
  whose adjoint is the shift back.

Megatron's conjugate pair is built on them for tensor parallelism, where
every member computes the replicated layers itself and back-propagates its
own copy of the loss: :func:`tp_all_reduce` (*g*: sum forward, identity
backward) after a row-parallel product and :func:`tp_replicate` (*f*:
identity forward, sum backward) before a column-parallel one.
:func:`scatter_to_members` and :func:`gather_from_members` are the same pair
for work split along a dim of a replicated tensor (the MoE layer's token
groups over ``ep``): own chunk forward and all-gather backward, all-gather
forward and own chunk backward.

:func:`along` applies any of them along one named axis of a
:class:`~beholder_tpu_torch.parallel.mesh.Mesh`, over members listed in the
mesh's row-major order. On a mesh over processes only the groups that stay
inside this process run there; a group that crosses processes inside a
forward is refused (:func:`refuse_across_processes`). The sharded steps
sum across processes outside autograd instead, with
:func:`process_gather`: every member's tensors on every process, then the
same member-order fold on each.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.autograd import Function

#: the queue item of every collective over processes inside a forward
ACROSS_PROCESSES_ITEM = "ROADMAP C.29"

#: bytes each tensor's slot in a gathered buffer is padded to, so every
#: slot starts aligned for any dtype
_ALIGN = 16


def member_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``xs[0] + xs[1] + ...`` in that order, on ``xs[0]``'s device."""
    dev = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(dev)
    return acc


def _to_each(x: torch.Tensor, like: Sequence[torch.Tensor]) -> tuple:
    """A copy of ``x`` on each member's device (a copy of its own even where
    the device is ``x``'s: outputs of one op never share storage)."""
    return tuple(x.to(m.device, copy=True) for m in like)


def _chunks(x: torch.Tensor, n: int, dim: int) -> tuple:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    return x.chunk(n, dim=dim)


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, *xs):
        return _to_each(member_sum(xs), xs)

    @staticmethod
    def backward(ctx, *gs):
        return _to_each(member_sum(gs), gs)


class _AllGather(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.sizes = dim, [x.shape[dim] for x in xs]
        return tuple(torch.cat([x.to(m.device) for x in xs], dim=dim) for m in xs)

    @staticmethod
    def backward(ctx, *gs):
        out, start = [], 0
        for j, size in enumerate(ctx.sizes):
            out.append(member_sum([g.narrow(ctx.dim, start, size) for g in gs]).to(gs[j].device))
            start += size
        return (None, *out)


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        n = len(xs)
        parts = [_chunks(x, n, dim) for x in xs]
        return tuple(
            member_sum([p[j] for p in parts]).to(xs[j].device).contiguous() for j in range(n)
        )

    @staticmethod
    def backward(ctx, *gs):
        return (None, *(torch.cat([g.to(m.device) for g in gs], dim=ctx.dim) for m in gs))


def _exchange(xs, split_dim: int, concat_dim: int) -> tuple:
    n = len(xs)
    parts = [_chunks(x, n, split_dim) for x in xs]
    return tuple(
        torch.cat([p[j].to(xs[j].device) for p in parts], dim=concat_dim) for j in range(n)
    )


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, split_dim, concat_dim, *xs):
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return _exchange(xs, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_exchange(gs, ctx.concat_dim, ctx.split_dim))


def shifted(xs: Sequence[torch.Tensor], shift: int = 1, *, copy: bool = True) -> list:
    """:func:`ring_shift`'s forward outside autograd: member ``j`` gets
    member ``(j - shift) mod N``'s tensor on its own device. ``copy=False``
    hands over a tensor whose device does not change as it is (the ring
    attention's hop, whose blocks are never written in place)."""
    n = len(xs)
    return [xs[(j - shift) % n].to(xs[j].device, copy=copy) for j in range(n)]


class _RingShift(Function):
    @staticmethod
    def forward(ctx, shift, *xs):
        ctx.shift = shift
        return tuple(shifted(xs, shift))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *shifted(gs, -ctx.shift))


class _TpAllReduce(Function):
    @staticmethod
    def forward(ctx, *xs):
        return _to_each(member_sum(xs), xs)

    @staticmethod
    def backward(ctx, *gs):
        return gs


class _TpReplicate(Function):
    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return _to_each(member_sum(gs), gs)


class _ScatterToMembers(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        n = len(xs)
        return tuple(_chunks(x, n, dim)[j].contiguous() for j, x in enumerate(xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *(torch.cat([g.to(m.device) for g in gs], dim=ctx.dim) for m in gs))


class _GatherFromMembers(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        return tuple(torch.cat([x.to(m.device) for x in xs], dim=dim) for m in xs)

    @staticmethod
    def backward(ctx, *gs):
        n = len(gs)
        return (None, *(_chunks(g, n, ctx.dim)[j].contiguous() for j, g in enumerate(gs)))


def all_reduce(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each member gets ``xs[0] + ... + xs[N-1]`` (summed in that order)."""
    return list(_AllReduce.apply(*xs))


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Each member gets the members' tensors concatenated along ``dim``."""
    return list(_AllGather.apply(dim, *xs))


def reduce_scatter(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Member ``j`` gets chunk ``j`` (along ``dim``) of the members' sum."""
    return list(_ReduceScatter.apply(dim, *xs))


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int) -> list[torch.Tensor]:
    """Member ``j`` gets chunk ``j`` (along ``split_dim``) of every member's
    tensor, concatenated in member order along ``concat_dim``."""
    return list(_AllToAll.apply(split_dim, concat_dim, *xs))


def ring_shift(xs: Sequence[torch.Tensor], shift: int = 1) -> list[torch.Tensor]:
    """Member ``j`` gets member ``(j - shift) mod N``'s tensor (the
    reference's ``ppermute`` ``i -> i + shift``)."""
    return list(_RingShift.apply(shift, *xs))


def tp_all_reduce(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Megatron's *g*: all-reduce forward, identity backward (each member's
    cotangent is already the whole one, its loss being replicated)."""
    return list(_TpAllReduce.apply(*xs))


def tp_replicate(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Megatron's *f*: identity forward, all-reduce backward (each member's
    column shard contributes its part of the input's gradient)."""
    return list(_TpReplicate.apply(*xs))


def scatter_to_members(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Member ``j`` keeps chunk ``j`` along ``dim`` of its replicated
    tensor; backward all-gathers the chunks' cotangents."""
    return list(_ScatterToMembers.apply(dim, *xs))


def gather_from_members(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """All-gather along ``dim`` into a replicated tensor; backward keeps
    each member's own chunk of its own cotangent."""
    return list(_GatherFromMembers.apply(dim, *xs))


def refuse_across_processes(mesh, what: str) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` spans processes: ``what``
    needs a collective over processes that is not ported."""
    if getattr(mesh, "crosses_processes", False):
        raise NotImplementedError(
            f"{what} on a mesh over {len(set(mesh.owners))} processes: its collectives "
            f"across processes are not ported ({ACROSS_PROCESSES_ITEM})"
        )


def along(mesh, axis: str, op: Callable, xs: Sequence, **kw) -> list:
    """``op`` over each group of members that differ only in their ``axis``
    coordinate: ``xs`` lists one tensor a member this process holds
    (``mesh.local``, every member of a one-process mesh) in row-major
    order, and so does the result. An axis the mesh lacks, or of size 1,
    leaves ``xs`` as they are. A group split between processes raises."""
    if len(xs) != len(mesh.local):
        raise ValueError(f"{len(xs)} tensors for the {len(mesh.local)} members of this process")
    if mesh.shape.get(axis, 1) == 1:
        return list(xs)
    out = [None] * len(xs)
    for group in mesh.groups(axis):
        slots = [mesh.slot(i) for i in group]
        if all(j is None for j in slots):
            continue
        if None in slots:
            raise NotImplementedError(
                f"a collective along {axis!r} over members of more than one process is not "
                f"ported ({ACROSS_PROCESSES_ITEM})"
            )
        for j, y in zip(slots, op([xs[j] for j in slots], **kw)):
            out[j] = y
    return out


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def process_gather(mesh, local: Sequence[Sequence[torch.Tensor]]) -> list:
    """Every member's tensors, on every process of ``mesh``'s group:
    ``local[j]`` lists the tensors of this process's ``j``-th member (each
    member the same shapes and dtypes, as a leaf's slices are); the result
    lists one such list a mesh member, in member order, this process's own
    as given and the others' received, on the device of ``local[0][0]``.
    One ``all_gather`` of the members' bytes packed into one buffer: CUDA
    tensors as they are in a ``nccl`` group, through host memory in a
    ``gloo`` one (``dist.get_backend()``). The bytes arrive unchanged, so
    a fold over the result is the same on every process."""
    counts = {o: mesh.owners.count(o) for o in set(mesh.owners)}
    if (sorted(counts) != list(range(dist.get_world_size())) or len(set(counts.values())) != 1
            or len(local) != len(mesh.local)):
        raise ValueError(f"members per process {counts}: an all_gather needs an equal share "
                         f"on each of the group's {dist.get_world_size()} processes")
    like = list(local[0])
    dev = like[0].device
    pieces = []
    for member in local:
        if [(t.shape, t.dtype) for t in member] != [(t.shape, t.dtype) for t in like]:
            raise ValueError("every member must give tensors of the same shapes and dtypes")
        for t in member:
            b = _as_bytes(t)
            pieces.append(b)
            if b.numel() % _ALIGN:
                pieces.append(b.new_zeros(_ALIGN - b.numel() % _ALIGN))
    buf = torch.cat(pieces)
    backend = dist.get_backend()
    if backend == "gloo":
        buf = buf.cpu()
    elif backend != "nccl":
        raise ValueError(f"process_gather runs over nccl or gloo, not {backend!r}")
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(out, buf)
    result: list = [None] * mesh.size
    for rank, got in enumerate(out):
        got, at = got.to(dev), 0
        for i in (i for i, o in enumerate(mesh.owners) if o == rank):
            member = []
            for t in like:
                n = t.numel() * t.element_size()
                member.append(got[at:at + n].view(t.dtype).reshape(t.shape))
                at += -(-n // _ALIGN) * _ALIGN
            result[i] = member
    for j, i in enumerate(mesh.local):
        result[i] = list(local[j])
    return result
