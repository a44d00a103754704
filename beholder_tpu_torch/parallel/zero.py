"""ZeRO: optimizer state (and optionally parameters) sharded over the data
parallel axis, the port's counterpart of the reference's
``parallel/zero.py``.

Each leaf is cut along its largest dim divisible by the dp size
(:func:`~beholder_tpu_torch.parallel.sharding.zero_leaf_spec`; replicated
below ``MIN_SHARD_ELEMENTS`` or when none divides). Member ``j`` owns slice
``j`` of every cut leaf and its Adam moments, and updates only those:

- stage 2 (default): every member also holds the whole parameters (its own
  replica). A step back-propagates each member's batch slice, reduce-scatters
  the gradients in member order (member ``j`` gets the sum of slice ``j``),
  lets one Adam update the owned slices, and all-gathers them into every
  replica.
- stage 3 (``shard_params=True``): the members hold only their slices; the
  whole parameters are all-gathered before the forward and dropped after the
  step.

Adam is elementwise, and the sums are the plain dp step's
(:func:`~beholder_tpu_torch.parallel.mesh.sharded_seq_train_step` on the
same ``("dp",)`` mesh: an all-reduce in member order), so a ZeRO step gives
the plain dp step's parameters and moments bit for bit. It composes with
``remat=True`` and ``attention="flash"``: the forward is the model's own
lockstep forward (``members_loss``).

The gathers and sums run outside autograd on every mesh member's tensors
(:func:`~beholder_tpu_torch.parallel.mesh.every_member`): on a ``("dp",)``
mesh over processes (``make_hybrid_mesh(1).take(tp=0)``) each process
holds and updates its own members' slices, gets every member's from every
process and runs the same adds, so the step stays bitwise the one-process
one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .collectives import member_sum
from .mesh import Mesh, _adam_state, _grad, _set_moments, every_member, member_losses
from .sharding import shard_tensors, zero_leaf_spec

class ZeroState(NamedTuple):
    """A ZeRO training state on a ``("dp",)`` mesh: ``members[j]`` maps each
    parameter name to member ``j``'s owned slice (the whole leaf where it is
    replicated), the leaves ``optimizer`` updates; ``replicas[j]`` is member
    ``j``'s whole parameters under stage 2, None under stage 3.
    :func:`~beholder_tpu_torch.parallel.mesh.gather_state` gives the whole
    state back."""

    model: torch.nn.Module
    mesh: Mesh
    specs: dict
    members: list
    optimizer: torch.optim.Optimizer
    step: int
    replicas: list | None


def zero_state_specs(state, mesh: Mesh, axis: str = "dp", shard_params: bool = False) -> dict:
    """``{"params": {name: spec}, "moments": {name: spec}}``: the moments cut
    by :func:`zero_leaf_spec`, the parameters too under stage 3 (else
    replicated, ``()``)."""
    dp = mesh.shape[axis]
    moments = {n: zero_leaf_spec(p, dp, axis) for n, p in state.model.named_parameters()}
    params = dict(moments) if shard_params else {n: () for n in moments}
    return {"params": params, "moments": moments}


def place_zero_state(state, mesh: Mesh, axis: str = "dp", shard_params: bool = False) -> ZeroState:
    """``state`` (a ``TrainState``, its Adam moments included) laid out for
    ZeRO stage 2, or 3 with ``shard_params``, on a one-axis ``dp`` mesh."""
    from beholder_tpu_torch.models.train import adam

    if mesh.axis_names != (axis,):
        raise ValueError(f"ZeRO runs on a one-axis ({axis!r},) mesh, got {mesh.axis_names}")
    specs = zero_state_specs(state, mesh, axis, shard_params)["moments"]
    tensors = {n: p.detach() for n, p in state.model.named_parameters()}
    owned = shard_tensors(tensors, specs, mesh)
    for member in owned:
        for leaf in member.values():
            leaf.requires_grad_(True)
    replicas = None
    if not shard_params:
        replicas = shard_tensors(tensors, {n: () for n in tensors}, mesh)
        for member in replicas:
            for leaf in member.values():
                leaf.requires_grad_(True)
    optimizer = adam([leaf for member in owned for leaf in member.values()],
                     state.optimizer.param_groups[0]["lr"])
    _set_moments(optimizer, owned, _adam_state(state), specs, mesh)
    return ZeroState(state.model, mesh, specs, owned, optimizer, state.step, replicas)


def _split_dim(spec: tuple) -> int | None:
    return next((d for d, a in enumerate(spec) if a is not None), None)


def _gathered(zstate: ZeroState) -> dict:
    """Each local member's whole parameters, ``{name: [one a member]}``: the
    owned slices of every mesh member (from every process on a mesh over
    processes) concatenated in member order, a copy a member; a replicated
    leaf as it is."""
    every = every_member(zstate.mesh, [{n: m[n].detach() for n in zstate.specs}
                                       for m in zstate.members])
    out = {}
    for name, spec in zstate.specs.items():
        leaves = [m[name].detach() for m in zstate.members]
        dim = _split_dim(spec)
        if dim is None:
            out[name] = leaves
            continue
        whole = torch.cat([e[name] for e in every], dim=dim)
        out[name] = [whole.to(x.device, copy=True) for x in leaves]
    return out


def _reduced(zstate: ZeroState, params: list) -> list:
    """Each local member's owned gradient of every leaf: its slice of the
    member-order sum of every mesh member's gradient (the whole sum where
    the leaf is replicated): the plain dp step's all-reduce, cut."""
    mesh, specs = zstate.mesh, zstate.specs
    grads = [{n: _grad(p[n]) for n in specs} for p in params]
    every = every_member(mesh, grads)
    out = [{} for _ in params]
    for name, spec in specs.items():
        dim = _split_dim(spec)
        if dim is None:
            total = member_sum([e[name] for e in every])
            owned = [total.to(g[name].device, copy=True) for g in grads]
        else:
            owned = [member_sum([e[name].chunk(mesh.size, dim=dim)[i] for e in every])
                     .to(g[name].device).contiguous() for i, g in zip(mesh.local, grads)]
        for o, g in zip(out, owned):
            o[name] = g
    return out


def zero_train_step(zstate: ZeroState, feats: torch.Tensor,
                    targets: torch.Tensor) -> tuple[ZeroState, torch.Tensor]:
    """One ZeRO step of ``zstate.model`` (its ``members_loss`` over the dp
    mesh, each member a batch slice). Returns the state and the loss, the
    mean over dp of the members' losses."""
    mesh, model = zstate.mesh, zstate.model
    dp = mesh.size
    zstate.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        if zstate.replicas is None:
            gathered = _gathered(zstate)
            params = [{n: gathered[n][j].requires_grad_(True) for n in zstate.specs}
                      for j in range(len(mesh.local))]
        else:
            params = zstate.replicas
            for member in params:
                for leaf in member.values():
                    leaf.grad = None
    losses = model.members_loss(params, feats, targets, mesh)
    member_sum([loss / dp for loss in losses]).backward()
    with torch.no_grad():
        for member, owned in zip(zstate.members, _reduced(zstate, params)):
            for name, g in owned.items():
                member[name].grad = g
    zstate.optimizer.step()
    if zstate.replicas is not None:
        with torch.no_grad():
            for name, wholes in _gathered(zstate).items():
                for replica, whole in zip(zstate.replicas, wholes):
                    replica[name].copy_(whole)
    loss = member_sum(member_losses(mesh, losses, list(range(dp)))) / dp
    return zstate._replace(step=zstate.step + 1), loss
