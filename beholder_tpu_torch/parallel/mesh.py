"""A device mesh with named axes, and the sharded training steps that run
over it: the port's counterpart of the reference's ``parallel/mesh.py``.

One process drives the members it holds, each in turn; a tensor moves to a
member's device with :meth:`Mesh.to` (a peer copy between two devices,
nothing on the same one), and every collective is an explicit,
differentiable op with a fixed member order
(:mod:`beholder_tpu_torch.parallel.collectives`). A device may repeat, so
``make_mesh(8, devices=["cuda:0"] * 8)`` runs a (4, 2) mesh on one card
(the counterpart of the virtual CPU devices the reference's tests use);
such a mesh moves no bytes between devices.

A mesh may span processes (:func:`~.distributed.make_hybrid_mesh`, or a
``Mesh`` given ``owners``: the counterpart of JAX's multi-controller
mesh): ``owners`` names each member's process, and this process holds
:attr:`Mesh.local`. The member order, :meth:`Mesh.coords`,
:meth:`Mesh.groups` and :attr:`Mesh.shape` stay global; every list of
member tensors lists the local members only, in member order. Each process
runs its own members' forward, backward and kernels. A group along an axis
that is split between processes has a layout (:meth:`Mesh.layout`: its
member ids, their owners, the process group of those owners, made once
per mesh), and the collectives run across processes on it
(:func:`~.collectives.along`), so every path runs on such a mesh with no
change to the model code. The sharded steps sum gradients over groups that
cross processes by gathering every member's tensor from every process and
folding them in member order (:func:`~.collectives.process_gather`), the
same adds on every process, so the result is bitwise the one-process
mesh's.

Axes are named from ``dp`` (data), ``tp`` (megatron tensor), ``sp``
(sequence: ring or Ulysses attention), ``ep`` (experts) and ``pp``
(pipeline stages, :mod:`beholder_tpu_torch.parallel.pipeline`).
``Mesh(devices)`` is one ``sp`` axis, the mesh ring attention runs on.

Sharded training (:func:`place_state` / :func:`sharded_train_step` for the
anomaly MLP, :func:`place_seq_state` / :func:`sharded_seq_train_step` for
the transformer): each member holds its own slice of every parameter (its
own copy of a replicated one) and of its Adam moments, as a
:class:`ShardedState`. A step runs every member's forward in lockstep,
back-propagates each member's loss, sums each gradient over the members
that computed parts of it (in member order, so every replica gets the same
bits), and lets one Adam update every member's leaves; the replicas of a
parameter therefore stay bitwise equal. :func:`gather_state` puts the
whole parameters and moments back into a :class:`TrainState`.

:func:`serving_shard_devices` places the serving cluster's workers
(:mod:`beholder_tpu_torch.cluster`) the same way: one device (or one group
of devices) a worker; a decode group (:mod:`beholder_tpu_torch.cluster.group`)
keeps its weights in the megatron split over :func:`group_mesh`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .collectives import Group, Members, member_sum, process_gather
from .sharding import (
    expert_spec,
    mlp_spec,
    seq_spec,
    shard_tensors,
    specs_for,
    unshard_tensors,
)


class Mesh:
    """Devices on a grid with named axes. ``devices`` is an N-d nested list
    (or array) of devices, ``axis_names`` one name a dim; ``Mesh(devices)``
    of a flat list is one ``sp`` axis. ``shape[name]`` is an axis' size and
    ``devices`` the flat tuple in row-major order: member ``i`` sits on
    ``devices[i]`` at ``coords()[i]``. ``owners`` (row-major, one process
    rank a member; every member this process's when None) and ``rank``
    (this process's) place a mesh over processes: this process holds
    :attr:`local`, and a list of member tensors lists those members, in
    order."""

    def __init__(self, devices, axis_names=("sp",), owners=None, rank: int = 0):
        grid = np.empty(np.shape(np.array(devices, dtype=object)), dtype=object)
        for idx in np.ndindex(grid.shape):
            d = devices
            for i in idx:
                d = d[i]
            grid[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(axis_names) != grid.ndim or len(set(axis_names)) != len(axis_names):
            raise ValueError(
                f"axis names {axis_names} do not name the {grid.ndim} dims of the device grid"
            )
        self.grid = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.devices = tuple(grid.reshape(-1))
        self.size = grid.size
        self.rank = rank
        self.owners = tuple(int(o) for o in np.reshape(
            np.array(owners if owners is not None else [rank] * grid.size, dtype=object), -1))
        if len(self.owners) != self.size:
            raise ValueError(f"{len(self.owners)} owners for a mesh of {self.size} members")
        #: the flat indices of the members this process holds, in order
        self.local = tuple(i for i, o in enumerate(self.owners) if o == rank)
        self._slot = {i: j for j, i in enumerate(self.local)}
        self._layouts = self._group_layouts() if self.crosses_processes else {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    @property
    def crosses_processes(self) -> bool:
        """Whether members of this mesh live in more than one process."""
        return len(set(self.owners)) > 1

    def _group_layouts(self) -> dict:
        """``{axis: [a Group or None, one a group of mesh.groups(axis)]}``:
        the layout of every group split between processes. The process
        group of a group's owners is made here, once per set of owners, by
        every process alike (``dist.new_group`` needs them all), and is
        None when the owners are every process of the default group."""
        owners = {}
        for axis in self.axis_names:
            for group in self.groups(axis):
                ranks = tuple(sorted({self.owners[i] for i in group}))
                if len(ranks) > 1:
                    owners[axis, tuple(group)] = ranks
        pgs = {ranks: _process_group(ranks) for ranks in sorted(set(owners.values()))}
        out = {}
        for axis in self.axis_names:
            out[axis] = []
            for group in self.groups(axis):
                ranks = owners.get((axis, tuple(group)))
                out[axis].append(None if ranks is None else Group(
                    group, [self.owners[i] for i in group], self.rank, pgs[ranks]))
        return out

    def layout(self, axis: str, index: int) -> Group:
        """The layout of ``groups(axis)[index]``, a group split between
        processes."""
        found = self._layouts.get(axis, [None] * (index + 1))[index]
        if found is None:
            raise ValueError(f"group {index} along {axis!r} of {self} lies inside one process")
        return found

    def slot(self, i: int) -> int | None:
        """Member ``i``'s position in this process's member lists (None
        when another process holds it)."""
        return self._slot.get(i)

    def local_coords(self) -> list[tuple]:
        """The coordinates of this process's members, in member order."""
        coords = self.coords()
        return [coords[i] for i in self.local]

    @property
    def local_devices(self) -> tuple:
        return tuple(self.devices[i] for i in self.local)

    def to(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """``x`` on member ``i``'s device (the same tensor when it is there
        already)."""
        return x.to(self.devices[i])

    def coords(self) -> list[tuple]:
        """Every member's coordinates, in row-major order."""
        return list(np.ndindex(self.grid.shape))

    def device_at(self, coords) -> torch.device:
        """The device at ``coords``: a tuple in axis order or a dict by name."""
        if isinstance(coords, dict):
            coords = tuple(coords.get(a, 0) for a in self.axis_names)
        return self.grid[tuple(coords)]

    def groups(self, *axes: str) -> list[list[int]]:
        """The members (flat indices) that differ only in their ``axes``
        coordinates, one list a group, each in row-major order."""
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        out: dict = {}
        for i, c in enumerate(self.coords()):
            out.setdefault(tuple(c[k] for k in keep), []).append(i)
        return list(out.values())

    def take(self, **fixed: int) -> "Mesh":
        """The mesh over the remaining axes at the ``fixed`` coordinates."""
        index = tuple(fixed.get(a, slice(None)) for a in self.axis_names)
        names = tuple(a for a in self.axis_names if a not in fixed)
        owners = np.array(self.owners, dtype=object).reshape(self.grid.shape)[index]
        return Mesh(self.grid[index].tolist() if names else [self.grid[index]],
                    names or ("sp",), owners=np.reshape(owners, -1).tolist(), rank=self.rank)

    def axis_mesh(self, axis: str, at: dict | None = None) -> "Mesh":
        """The one-axis mesh along ``axis``, the other axes at ``at``
        (coordinate 0 where not given): e.g. the ``sp`` ring inside one
        (dp, tp) member."""
        at = at or {}
        return self.take(**{a: at.get(a, 0) for a in self.axis_names if a != axis})


#: the process group of each set of ranks smaller than the default group,
#: made once in this process (in the same order in every process)
_PROCESS_GROUPS: dict = {}


def _process_group(ranks: tuple):
    """The process group of ``ranks``: None (the default group) when they
    are every process or no group was joined, else one made once by every
    process (``dist.new_group`` with the default group's timeout)."""
    import torch.distributed as dist

    if not dist.is_initialized() or ranks == tuple(range(dist.get_world_size())):
        return None
    if ranks not in _PROCESS_GROUPS:
        _PROCESS_GROUPS[ranks] = dist.new_group(list(ranks), timeout=_default_timeout())
    return _PROCESS_GROUPS[ranks]


def _default_timeout():
    """The default group's timeout, so a sub-group's waits are bounded
    alike."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    device = torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")
    return c10d._get_default_group()._get_backend(device).options._timeout


def _visible_devices(devices) -> list:
    """``devices`` as ``torch.device``s; every visible CUDA device when None,
    raising when there is none (the port never drops to the CPU unasked)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: meshes and serving workers lie on the card by default; "
                "pass devices=['cpu'] * n to run the plain PyTorch path"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(n_devices: int | None = None, tp: int | None = None, devices=None) -> Mesh:
    """A 2-D ``("dp", "tp")`` mesh over the first ``n_devices`` of
    ``devices`` (every visible CUDA device when None, raising when there is
    none). ``tp`` defaults to 2 when the count is even, else 1 (pure dp)."""
    devices = _visible_devices(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if n % tp:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    return Mesh([devices[r * tp:(r + 1) * tp] for r in range(n // tp)], ("dp", "tp"))


def group_mesh(devices, axis: str = "tp") -> Mesh:
    """The one-group mesh ``(1, N)``: a ``dp`` axis of 1 (so the dp x tp
    specs apply as they are) and the group's members along ``axis``."""
    devices = tuple(devices)
    if not devices:
        raise ValueError("group_mesh needs at least one device")
    return Mesh([list(devices)], ("dp", axis))


def members_mesh(xs, axis: str = "tp") -> Mesh:
    """The one-group mesh :func:`group_mesh` of a member list: each member
    on its tensor's device. A :class:`~.collectives.Members` (this
    process's share of a group split between processes, as the pipelines
    hand a stage) gives a mesh over the group's processes, its owners the
    group's and this process holding its share, so the collectives of
    :func:`~.collectives.along` over it cross them; the group's process
    group was made with the mesh the group came from, and is found again
    here without a collective. A member another process holds sits on a
    local member's device in this mesh, which nothing reads."""
    if not isinstance(xs, Members):
        return group_mesh([x.device for x in xs], axis)
    g = xs.group
    devices = [xs[g.local.index(p)].device if p in g.local else xs[0].device
               for p in range(g.size)]
    return Mesh([devices], ("dp", axis), owners=list(g.owners), rank=g.rank)


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
    devices = _visible_devices(devices)
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


# -- sharded training ---------------------------------------------------------


class ShardedState(NamedTuple):
    """A training state laid out on ``mesh``: ``members[i]`` maps each
    parameter name to member ``i``'s slice under ``specs`` (a leaf with
    gradients on, on the member's device); ``optimizer`` is one Adam over
    every member's leaves, holding each leaf's moments. ``model`` carries
    the configuration; its own parameters are not kept up to date (see
    :func:`gather_state`)."""

    model: torch.nn.Module
    mesh: Mesh
    specs: dict
    members: list
    optimizer: torch.optim.Optimizer
    step: int


def _adam_state(state) -> dict:
    """``{name: (step, exp_avg, exp_avg_sq)}`` of a state's Adam (empty
    before its first step)."""
    out = {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p)
        if st:
            out[name] = (st["step"], st["exp_avg"], st["exp_avg_sq"])
    return out


def _set_moments(optimizer, leaves: list[dict], moments: dict, specs: dict, mesh) -> None:
    """Each leaf's Adam moments from the whole ones, cut like the leaves."""
    if not moments:
        return
    avg = shard_tensors({n: m[1] for n, m in moments.items()}, specs, mesh)
    sq = shard_tensors({n: m[2] for n, m in moments.items()}, specs, mesh)
    for member, a, q in zip(leaves, avg, sq):
        for name, leaf in member.items():
            optimizer.state[leaf] = {"step": moments[name][0].clone(), "exp_avg": a[name],
                                     "exp_avg_sq": q[name]}


def _place(state, mesh: Mesh, specs: dict) -> ShardedState:
    from beholder_tpu_torch.models.train import adam

    tensors = {n: p.detach() for n, p in state.model.named_parameters()}
    members = shard_tensors(tensors, specs, mesh)
    for member in members:
        for leaf in member.values():
            leaf.requires_grad_(True)
    lr = state.optimizer.param_groups[0]["lr"]
    optimizer = adam([leaf for member in members for leaf in member.values()], lr)
    _set_moments(optimizer, members, _adam_state(state), specs, mesh)
    return ShardedState(state.model, mesh, specs, members, optimizer, state.step)


def every_member(mesh: Mesh, local: list[dict]) -> list[dict]:
    """One dict of tensors a mesh member, from one dict a member this
    process holds: ``local`` itself on a one-process mesh, else every
    member's, gathered from every process (:func:`process_gather`)."""
    if not mesh.crosses_processes:
        return local
    names = list(local[0])
    return [dict(zip(names, got))
            for got in process_gather(mesh, [[m[n] for n in names] for m in local])]


def gather_state(sstate: ShardedState, device=None):
    """The whole training state back from the members: parameters (written
    into ``sstate.model``, on ``device`` or the model's own) and a fresh Adam
    holding the whole moments. A bitwise copy of the members' slices; on a
    mesh over processes every process gets the whole state."""
    from beholder_tpu_torch.models.train import TrainState, adam

    model, mesh, specs = sstate.model, sstate.mesh, sstate.specs
    device = device or next(model.parameters()).device
    first = sstate.members[0]
    moments = bool(sstate.optimizer.state.get(next(iter(first.values()))))
    local = []
    for m in sstate.members:
        d = {("p", n): t.detach() for n, t in m.items()}
        if moments:
            for n, t in m.items():
                st = sstate.optimizer.state[t]
                d["a", n], d["q", n] = st["exp_avg"], st["exp_avg_sq"]
        local.append(d)
    every = every_member(mesh, local)

    def whole(kind):
        return unshard_tensors([{n: m[kind, n] for n in specs} for m in every], specs, mesh,
                               device)

    full = whole("p")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = full[name].clone()
    optimizer = adam(model.parameters(), sstate.optimizer.param_groups[0]["lr"])
    if moments:
        avg, sq = whole("a"), whole("q")
        for name, p in model.named_parameters():
            optimizer.state[p] = {"step": sstate.optimizer.state[first[name]]["step"].clone(),
                                  "exp_avg": avg[name].clone(), "exp_avg_sq": sq[name].clone()}
    return TrainState(model, optimizer, sstate.step)


def _grad(x: torch.Tensor) -> torch.Tensor:
    return x.grad if x.grad is not None else torch.zeros_like(x)


def _reduce_grads(mesh: Mesh, members: list[dict], axes_of: Callable[[str], tuple]) -> None:
    """Sum each leaf's gradient over the members that differ only along
    ``axes_of(name)``, in member order, and give every one of them the sum
    (the same bits on each). A missing gradient counts as zeros. On a mesh
    over processes every member's gradients come from every process first,
    and each process folds every group its members are in."""
    plan = {}
    for name in members[0]:
        axes = [a for a in axes_of(name) if mesh.shape.get(a, 1) > 1]
        if axes:
            plan[name] = mesh.groups(*axes)
    if not plan:
        return
    every = every_member(mesh, [{n: _grad(m[n]) for n in plan} for m in members])
    for name, groups in plan.items():
        for group in groups:
            slots = [mesh.slot(i) for i in group]
            if all(j is None for j in slots):
                continue
            total = member_sum([every[i][name] for i in group])
            for j in slots:
                if j is not None:
                    leaf = members[j][name]
                    leaf.grad = total.to(leaf.device, copy=True)


def _representatives(mesh: Mesh, replicated: tuple) -> list[int]:
    """The members at coordinate 0 of every axis in ``replicated``."""
    idx = [mesh.axis_names.index(a) for a in replicated if a in mesh.axis_names]
    return [i for i, c in enumerate(mesh.coords()) if all(c[k] == 0 for k in idx)]


def member_losses(mesh: Mesh, losses: list, members: list[int]) -> list:
    """The detached losses of the mesh members ``members`` (flat indices), on
    the first local loss's device, from every process on a mesh over
    processes."""
    every = every_member(mesh, [{"loss": x.detach()} for x in losses])
    dev = losses[0].device
    return [every[i]["loss"].to(dev) for i in members]


def _step(sstate: ShardedState, losses: list, replicated: tuple,
          axes_of: Callable[[str], tuple]) -> tuple[ShardedState, torch.Tensor]:
    """Back-propagate every local member's loss (each weighted 1/dp, so the
    dp sum of the gradients is their mean), reduce the gradients, take one
    Adam step. The loss returned is the mean over dp of the
    representatives'."""
    mesh = sstate.mesh
    dp = mesh.shape.get("dp", 1)
    total = member_sum([loss / dp for loss in losses])
    total.backward()
    _reduce_grads(mesh, sstate.members, axes_of)
    sstate.optimizer.step()
    loss = member_sum(member_losses(mesh, losses, _representatives(mesh, replicated))) / dp
    return sstate._replace(step=sstate.step + 1), loss


def state_shardings(state, mesh: Mesh) -> dict:
    """The anomaly MLP's spec of every parameter name (its Adam moments are
    keyed, and cut, the same way): ``in_proj`` column-parallel over ``tp``,
    ``mid_proj`` row-parallel, the rest replicated."""
    return specs_for(dict(state.model.named_parameters()), mlp_spec)


param_shardings = state_shardings


def place_state(state, mesh: Mesh) -> ShardedState:
    """The anomaly MLP's state on a ``("dp", "tp")`` mesh (parameters and
    Adam moments cut by :func:`state_shardings`)."""
    return _place(state, mesh, state_shardings(state, mesh))


def sharded_train_step(sstate: ShardedState, windows: torch.Tensor,
                       targets: torch.Tensor) -> tuple[ShardedState, torch.Tensor]:
    """One Adam step of the anomaly MLP over its mesh: the batch split over
    ``dp``, ``in_proj`` column- and ``mid_proj`` row-parallel over ``tp``
    (megatron's *f* and *g*; the row bias added once, after the sum), the
    gradients averaged over ``dp``. Returns the state and the loss."""
    sstate.optimizer.zero_grad(set_to_none=True)
    losses = sstate.model.members_loss(sstate.members, windows, targets, sstate.mesh)
    return _step(sstate, losses, ("tp",), lambda name: ("dp",))


def seq_state_shardings(state, mesh: Mesh) -> dict:
    """The transformer's spec of every parameter name (Adam moments keyed
    the same way): megatron over ``tp`` (:func:`~.sharding.seq_spec`) and,
    on a mesh with ``ep``, the expert stacks along E
    (:func:`~.sharding.expert_spec`). ``state`` is a training state or the
    model itself (sharded serving)."""
    model = getattr(state, "model", state)

    def rule(name, t):
        if "ep" in mesh.shape and expert_spec(name, t):
            return expert_spec(name, t)
        return seq_spec(name, t) if "tp" in mesh.shape else ()

    return specs_for(dict(model.named_parameters()), rule)


def place_seq_state(state, mesh: Mesh) -> ShardedState:
    """The transformer's state on a mesh of ``dp``, ``tp``, ``sp`` (or
    ``dp``, ``ep``) axes, cut by :func:`seq_state_shardings`."""
    return _place(state, mesh, seq_state_shardings(state, mesh))


def _seq_grad_axes(model, specs: dict) -> Callable[[str], tuple]:
    """The axes each transformer gradient is summed over: ``dp`` and ``sp``
    always (members hold other rows or other positions); ``tp`` for a
    replicated leaf under ``seq_shard`` (used on each member's T-slice;
    without it every tp member computes the replicated layers itself and
    megatron's *f* already sums what reaches them); ``ep`` for the router
    (each ep member routes its own token groups)."""
    def axes(name: str) -> tuple:
        out = ("dp", "sp")
        if model.seq_shard and "tp" not in specs[name]:
            out += ("tp",)
        if ".moe.router." in name:
            out += ("ep",)
        return out

    return axes


def sharded_seq_train_step(sstate: ShardedState, feats: torch.Tensor,
                           targets: torch.Tensor) -> tuple[ShardedState, torch.Tensor]:
    """One Adam step of the transformer over its mesh: the batch over
    ``dp``; megatron over ``tp`` (q/k/v/up column layers, proj/down row
    layers, a row bias added once after the member sum; with
    ``model.seq_shard`` the residual stream and the LayerNorms as T-slices,
    reduce-scattered after a row layer and all-gathered before a column
    one); on an ``sp`` axis the sequence split too, attention by ring or
    Ulysses over ``sp`` inside each (dp, tp) member; on an ``ep`` axis the
    expert stacks and token groups split (MoE). The model's ``attention``,
    ``seq_shard``, ``remat`` and FFN settings apply; the mesh is the
    state's. Returns the state and the loss, the unsharded ``seq_loss``'s
    counterpart."""
    mesh, model = sstate.mesh, sstate.model
    sstate.optimizer.zero_grad(set_to_none=True)
    losses = model.members_loss(sstate.members, feats, targets, mesh)
    replicated = ("ep",) if model.seq_shard else ("tp", "ep")
    return _step(sstate, losses, replicated, _seq_grad_axes(model, sstate.specs))


