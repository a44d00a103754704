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
mesh's row-major order. On a mesh over processes each process runs the
groups it holds members of. A group that lies inside this process runs the
one-process form above. A group split between processes gives ``op`` a
:class:`Members`: this process's tensors of the group, in group order, with
the group's :class:`Group` layout (its member ids, their owners, this
rank and the processes' group). Every op then takes its cross-process form,
one ``torch.autograd.Function`` whose backward is the adjoint collective
over the same group, written out:

- a move (all_to_all, ring_shift, all_gather, scatter_to_members,
  gather_from_members) delivers each member's bytes unchanged;
- a sum (all_reduce, reduce_scatter, tp_all_reduce, tp_replicate's
  backward) gathers every member's tensor of the group and repeats the
  one-process left fold in member order on each process, so no
  backend's own reduction order enters a result;
- each process computes only its own members' outputs.

The transport is one packed ``all_gather`` of the members' bytes over the
group's processes (:func:`exchange`): CUDA tensors as they are in a
``nccl`` group, through host memory in a ``gloo`` one
(``dist.get_backend()``). The sharded steps sum across processes outside
autograd with :func:`process_gather`: every member's tensors on every
process, then the same member-order fold on each.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.autograd import Function

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
    attention's hop, whose blocks are never written in place). A
    :class:`Members` gets its share from every process of its group."""
    if isinstance(xs, Members):
        every, n = _every(xs), xs.group.size
        return Members([every[(p - shift) % n].to(x.device, copy=copy)
                        for p, x in zip(xs.group.local, xs)], xs.group)
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
    if isinstance(xs, Members):
        return _across(xs, _sum_each, _sum_each)
    return list(_AllReduce.apply(*xs))


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Each member gets the members' tensors concatenated along ``dim``."""
    if isinstance(xs, Members):
        return _across(xs, _gather_cat(dim), _narrow_sum(dim))
    return list(_AllGather.apply(dim, *xs))


def reduce_scatter(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Member ``j`` gets chunk ``j`` (along ``dim``) of the members' sum."""
    if isinstance(xs, Members):
        return _across(xs, _chunk_sum(dim), _gather_cat(dim))
    return list(_ReduceScatter.apply(dim, *xs))


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int) -> list[torch.Tensor]:
    """Member ``j`` gets chunk ``j`` (along ``split_dim``) of every member's
    tensor, concatenated in member order along ``concat_dim``."""
    if isinstance(xs, Members):
        return _across(xs, _swap(split_dim, concat_dim), _swap(concat_dim, split_dim))
    return list(_AllToAll.apply(split_dim, concat_dim, *xs))


def ring_shift(xs: Sequence[torch.Tensor], shift: int = 1) -> list[torch.Tensor]:
    """Member ``j`` gets member ``(j - shift) mod N``'s tensor (the
    reference's ``ppermute`` ``i -> i + shift``)."""
    if isinstance(xs, Members):
        return _across(xs, _shift_fwd(shift), _shift_fwd(-shift))
    return list(_RingShift.apply(shift, *xs))


def tp_all_reduce(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Megatron's *g*: all-reduce forward, identity backward (each member's
    cotangent is already the whole one, its loss being replicated)."""
    if isinstance(xs, Members):
        return _across(xs, _sum_each, list)
    return list(_TpAllReduce.apply(*xs))


def tp_replicate(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Megatron's *f*: identity forward, all-reduce backward (each member's
    column shard contributes its part of the input's gradient)."""
    if isinstance(xs, Members):
        return _across(xs, _identity, _sum_each)
    return list(_TpReplicate.apply(*xs))


def scatter_to_members(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Member ``j`` keeps chunk ``j`` along ``dim`` of its replicated
    tensor; backward all-gathers the chunks' cotangents."""
    if isinstance(xs, Members):
        return _across(xs, _own_chunk(dim), _gather_cat(dim))
    return list(_ScatterToMembers.apply(dim, *xs))


def gather_from_members(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """All-gather along ``dim`` into a replicated tensor; backward keeps
    each member's own chunk of its own cotangent."""
    if isinstance(xs, Members):
        return _across(xs, _gather_cat(dim), _own_chunk(dim))
    return list(_GatherFromMembers.apply(dim, *xs))


class Group:
    """The layout of a group of mesh members that spans processes: ``ids``
    the members' flat indices in group order, ``owners`` each one's process
    rank, ``rank`` this process's, and ``pg`` the process group of the
    owners (None: the default group, when they are every process).
    ``local`` lists the positions this process holds, in order."""

    def __init__(self, ids, owners, rank: int, pg=None):
        self.ids, self.owners, self.rank, self.pg = tuple(ids), tuple(owners), rank, pg
        self.ranks = tuple(sorted(set(self.owners)))
        self.local = tuple(p for p, o in enumerate(self.owners) if o == rank)

    @property
    def size(self) -> int:
        return len(self.ids)

    def __repr__(self) -> str:
        return f"Group(ids={self.ids}, owners={self.owners}, rank={self.rank})"


class Members(list):
    """This process's tensors of a group split between processes, in group
    order (``group.local``), with the group's :class:`Group` layout."""

    def __init__(self, xs, group: Group):
        super().__init__(xs)
        if len(self) != len(group.local):
            raise ValueError(f"{len(self)} tensors for the {len(group.local)} members this "
                             f"process holds of {group}")
        self.group = group


def like(xs: Sequence, ys) -> list:
    """``ys`` as a member list of the same kind as ``xs``: a
    :class:`Members` of ``xs``'s group, or a plain list."""
    return Members(ys, xs.group) if isinstance(xs, Members) else list(ys)


def unzip(xs: Sequence) -> list:
    """A member list of tuples as one member list a field, each of the same
    kind as ``xs``."""
    return [like(xs, col) for col in zip(*xs)]


def group_size(xs: Sequence) -> int:
    """The number of members in ``xs``'s group (every one's tensor is in a
    plain list; a :class:`Members` holds this process's share)."""
    return xs.group.size if isinstance(xs, Members) else len(xs)


def positions(xs: Sequence) -> tuple:
    """The group positions of the entries of ``xs``, in order."""
    return xs.group.local if isinstance(xs, Members) else tuple(range(len(xs)))


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def exchange(items: Sequence[tuple], mine: dict, device, pg=None,
             ranks: Sequence[int] | None = None) -> dict:
    """Every item's tensor on every process of ``ranks`` (every process
    when None; ``pg`` their process group, None the default one). ``items``
    lists ``(key, source rank, shape, dtype)`` in an order all of them
    share; ``mine`` maps the keys this process is the source of to their
    tensors. One ``all_gather`` of each process's tensors packed into one
    buffer (padded to the largest process's): CUDA tensors as they are in a
    ``nccl`` group, through host memory in a ``gloo`` one. Returns ``{key:
    tensor}`` on ``device``, each a tensor of its own, this process's own
    items as given; the bytes arrive unchanged."""
    ranks = tuple(range(dist.get_world_size())) if ranks is None else tuple(ranks)
    me = dist.get_rank()
    fill = {r: 0 for r in ranks}
    spans = {}
    for key, src, shape, dtype in items:
        n = math.prod(shape) * dtype.itemsize
        spans[key] = (src, fill[src], n, tuple(shape), dtype)
        fill[src] += _padded(n)
    width = max(fill.values(), default=0)
    out = {k: mine[k] for k, (src, *_) in spans.items() if src == me}
    if width == 0:
        return {**{k: torch.empty(s[3], dtype=s[4], device=device) for k, s in spans.items()},
                **out}
    pieces = []
    for key, (src, _, n, shape, dtype) in spans.items():
        if src != me:
            continue
        t = mine[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype}, the plan says {shape} {dtype}")
        b = _as_bytes(t).to(device)
        pieces.append(b)
        if _padded(n) > n:
            pieces.append(b.new_zeros(_padded(n) - n))
    buf = torch.cat(pieces) if pieces else torch.empty(0, dtype=torch.uint8, device=device)
    if buf.numel() < width:
        buf = torch.cat([buf, buf.new_zeros(width - buf.numel())])
    backend = dist.get_backend(pg)
    if backend == "gloo":
        buf = buf.cpu()
    elif backend != "nccl":
        raise ValueError(f"collectives over processes run over nccl or gloo, not {backend!r}")
    got = [torch.empty_like(buf) for _ in ranks]
    dist.all_gather(got, buf, group=pg)
    for key, (src, at, n, shape, dtype) in spans.items():
        if src == me:
            continue
        b = got[ranks.index(src)][at:at + n]
        b = b.to(device) if b.device != torch.device(device) else b.clone()
        out[key] = b.view(dtype).reshape(shape)
    return out


def gather_every(group: Group, local: Sequence[Sequence[torch.Tensor]]) -> list:
    """Every member's tensors of ``group``, on each of its processes:
    ``local[i]`` lists the tensors of this process's ``i``-th member (each
    member the same shapes and dtypes); the result lists one such list a
    group position, this process's own as given, on ``local[0][0]``'s
    device."""
    like_ = list(local[0])
    for member in local:
        if [(t.shape, t.dtype) for t in member] != [(t.shape, t.dtype) for t in like_]:
            raise ValueError("every member must give tensors of the same shapes and dtypes")
    mine = {(p, k): t for p, member in zip(group.local, local) for k, t in enumerate(member)}
    items = [((p, k), o, tuple(t.shape), t.dtype) for p, o in enumerate(group.owners)
             for k, t in enumerate(like_)]
    got = exchange(items, mine, like_[0].device, group.pg, group.ranks)
    return [[got[p, k] for k in range(len(like_))] for p in range(group.size)]


def _every(xs: "Members") -> list:
    """Every member's tensor of ``xs``'s group, on this process."""
    return [m[0] for m in gather_every(xs.group, [[x] for x in xs])]


class _Across(Function):
    """One collective over a group split between processes: ``fwd`` and
    ``bwd`` map this process's members' tensors (a :class:`Members`) to
    their outputs, and their outputs' cotangents to their inputs'."""

    @staticmethod
    def forward(ctx, group, fwd, bwd, *xs):
        ctx.group, ctx.bwd = group, bwd
        return tuple(fwd(Members(xs, group)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *ctx.bwd(Members(gs, ctx.group)))


def _across(xs: "Members", fwd: Callable, bwd: Callable) -> list:
    return Members(_Across.apply(xs.group, fwd, bwd, *xs), xs.group)


def _sum_each(xs: "Members") -> list:
    return list(_to_each(member_sum(_every(xs)), xs))


def _gather_cat(dim: int) -> Callable:
    def fwd(xs):
        every = _every(xs)
        return [torch.cat([e.to(x.device) for e in every], dim=dim) for x in xs]
    return fwd


def _own_chunk(dim: int) -> Callable:
    def fwd(xs):
        n = xs.group.size
        return [_chunks(x, n, dim)[p].contiguous() for p, x in zip(xs.group.local, xs)]
    return fwd


def _narrow_sum(dim: int) -> Callable:
    def bwd(gs):
        every = _every(gs)
        size = every[0].shape[dim] // gs.group.size
        return [member_sum([g.narrow(dim, p * size, size) for g in every]).to(x.device)
                for p, x in zip(gs.group.local, gs)]
    return bwd


def _chunk_sum(dim: int) -> Callable:
    def fwd(xs):
        every, n = _every(xs), xs.group.size
        parts = [_chunks(e, n, dim) for e in every]
        return [member_sum([q[p] for q in parts]).to(x.device).contiguous()
                for p, x in zip(xs.group.local, xs)]
    return fwd


def _swap(split_dim: int, concat_dim: int) -> Callable:
    def fwd(xs):
        every, n = _every(xs), xs.group.size
        parts = [_chunks(e, n, split_dim) for e in every]
        return [torch.cat([q[p].to(x.device) for q in parts], dim=concat_dim)
                for p, x in zip(xs.group.local, xs)]
    return fwd


def _shift_fwd(shift: int) -> Callable:
    def fwd(xs):
        return list(shifted(xs, shift))
    return fwd


def _identity(xs):
    return [x.view_as(x) for x in xs]


def along(mesh, axis: str, op: Callable, xs: Sequence, **kw) -> list:
    """``op`` over each group of members that differ only in their ``axis``
    coordinate: ``xs`` lists one tensor a member this process holds
    (``mesh.local``, every member of a one-process mesh) in row-major
    order, and so does the result. An axis the mesh lacks, or of size 1,
    leaves ``xs`` as they are. ``op`` gets a group this process holds whole
    as a plain list, and a group split between processes as a
    :class:`Members` of this process's share with the group's layout
    (:meth:`~.mesh.Mesh.layout`); groups run in the mesh's order, the same
    on every process."""
    if len(xs) != len(mesh.local):
        raise ValueError(f"{len(xs)} tensors for the {len(mesh.local)} members of this process")
    if mesh.shape.get(axis, 1) == 1:
        return list(xs)
    out = [None] * len(xs)
    for index, group in enumerate(mesh.groups(axis)):
        slots = [mesh.slot(i) for i in group]
        if all(j is None for j in slots):
            continue
        held = [j for j in slots if j is not None]
        if len(held) < len(slots):
            ins = Members([xs[j] for j in held], mesh.layout(axis, index))
        else:
            ins = [xs[j] for j in held]
        for j, y in zip(held, op(ins, **kw)):
            out[j] = y
    return out


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    x = t.detach().reshape(-1)
    if x.numel() and x.stride(0) != 1:
        # one element may carry any stride, which view() refuses
        x = x.clone(memory_format=torch.contiguous_format)
    return x.view(torch.uint8)


def process_gather(mesh, local: Sequence[Sequence[torch.Tensor]]) -> list:
    """Every member's tensors, on every process of ``mesh`` (whose members
    must lie in every process of the default group): ``local[j]`` lists
    the tensors of this process's ``j``-th member (each member the same
    shapes and dtypes, as a leaf's slices are); the result lists one such
    list a mesh member, in member order, this process's own as given and
    the others' received (:func:`gather_every` over the whole mesh). The
    bytes arrive unchanged, so a fold over the result is the same on every
    process."""
    world = dist.get_world_size()
    if sorted(set(mesh.owners)) != list(range(world)) or len(local) != len(mesh.local):
        raise ValueError(f"a mesh owned by processes {sorted(set(mesh.owners))} and "
                         f"{len(local)} members given: process_gather needs every one of "
                         f"the group's {world} processes and this one's "
                         f"{len(mesh.local)} members")
    return gather_every(Group(range(mesh.size), mesh.owners, mesh.rank), local)
