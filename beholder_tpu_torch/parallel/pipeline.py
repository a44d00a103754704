"""Pipeline parallelism over a ``pp`` mesh axis: the port's counterpart of
the reference's ``parallel/pipeline.py`` (the GPipe forward, the 1F1B
training step, dp x pp, and tensor parallelism inside the stages).

One process runs every stage it holds on its member's device, an
activation or a cotangent hops to the neighbouring stage with
:meth:`~.mesh.Mesh.to`, and every sum over members runs in member order
(:func:`~.collectives.member_sum`). On a mesh over processes each process
runs the units of the stage members it holds; a stage whose tp group is
split between processes runs its tp collectives across them (the
``Members`` forms of :mod:`~.collectives`, over the group's layout), every
process meeting the cells in one order. At the end of a tick the hops
whose two members lie in different processes go in one exchange
(:func:`~.collectives.exchange`, the bytes unchanged) that every process
takes part in; the losses and the gradient sums over ``dp`` gather every
member's values and fold them in member order, so each process gets the
one-process mesh's bits.

- Per-stage parameters are stacked along a new leading stage dim
  (:func:`stack_stage_params`, a dict of ``(S, ...)`` tensors) and placed one
  stage a ``pp`` member (:func:`stage_shardings`): a member holds its own
  stage's slice only.
- The schedules run tick by tick as the reference's ``lax.scan`` does. The
  reference computes every unit of every tick and masks the dead ones (a
  unit whose microbatch lies outside ``[0, M)``) with ``where``; here a dead
  unit is skipped. Adding a masked zero is exact, so the results are the
  same, and a stage's kernels launch once a live unit.
- :func:`pipeline_train_step` is the rematerialised 1F1B schedule: tick
  ``t`` runs stage ``i``'s forward unit for microbatch ``t - i`` and its
  backward unit for microbatch ``t - 2(S-1) + i``, over ``M + 2(S-1)``
  ticks. A stage keeps only its stage inputs, in a ring of
  ``min(2(S-1)+1, M)`` slots, and its backward unit recomputes the stage
  from the stored input (a forward with gradients on, then
  ``torch.autograd.grad``), so activation memory is O(S), independent of M.
  Gradients accumulate in f32, microbatch by microbatch in order, on the
  stage's own members.

``stats`` (a dict, when given) receives what the schedule did: ``ticks``,
the live ``forward_units`` and ``backward_units``, and the 1F1B ring's
``residual_peak`` (its most occupied slots, counted on the host).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.autograd import Function

from .collectives import Members, exchange, member_sum
from .mesh import every_member
from .sharding import Spec, shard_tensors, stage_spec, unshard_tensors


def stack_stage_params(stage_params: list[dict]) -> dict:
    """S per-stage parameter dicts (the same names and shapes in each: the
    uniform-block case pipelines are built for) as one dict of ``(S, ...)``
    tensors."""
    names = list(stage_params[0])
    for i, params in enumerate(stage_params[1:], 1):
        if list(params) != names:
            raise ValueError(f"stage {i} has parameters {sorted(params)}, stage 0 {sorted(names)}")
    return {n: torch.stack([params[n] for params in stage_params]) for n in names}


def stage_specs(stacked: dict, axis: str = "pp",
                rule: Callable[[str, torch.Tensor], Spec] | None = None) -> dict:
    """Every stacked leaf's spec: the leading (stage) dim over ``axis``; each
    stage's own leaf split by ``rule`` when given (e.g.
    :func:`~.sharding.seq_spec` for megatron inside the stages), else
    replicated."""
    return {n: stage_spec(n, t, axis, rule) for n, t in stacked.items()}


def _stage_count(stacked: dict, mesh, axis: str) -> int:
    s = mesh.shape[axis]
    for t in stacked.values():
        if t.shape[0] != s:
            raise ValueError(f"stage leaf has leading dim {t.shape[0]}, mesh {axis}={s}")
    return s


def stage_shardings(stacked: dict, mesh, axis: str = "pp", specs: dict | None = None) -> list:
    """The stacked parameters placed on ``mesh``: one dict a member (in the
    mesh's row-major order), each leaf its member's slice under ``specs``
    (default :func:`stage_specs`: its stage, leading dim 1), a copy of its
    own on the member's device."""
    _stage_count(stacked, mesh, axis)
    return shard_tensors({n: t.detach() for n, t in stacked.items()},
                         specs if specs is not None else stage_specs(stacked, axis), mesh)


def stack_stage_grads(grads: list, mesh, specs: dict, device=None) -> dict:
    """The whole ``(S, ...)`` gradients from :func:`pipeline_train_step`'s
    per-member ones (cut under ``specs``), on ``device`` (this process's
    first member's when None): a bitwise copy, for comparison. On a mesh
    over processes every member's come from every process."""
    return unshard_tensors(every_member(mesh, grads), specs, mesh,
                           device or mesh.local_devices[0])


def split_microbatches(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...), the microbatch stack the pipelines take."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by num_microbatches={num_microbatches}")
    return x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])


def merge_microbatches(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`split_microbatches`: (M, Bm, ...) -> (M*Bm, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """The idle share of :func:`pipeline_train_step`'s schedule: each stage
    runs M forward and M backward units over ``M + 2(S-1)`` ticks of one F
    and one B slot, so ``2(S-1) / (M + 2(S-1))`` of its slots are empty."""
    s, m = num_stages, num_microbatches
    return (2 * (s - 1)) / (m + 2 * (s - 1)) if s > 1 else 0.0


def _stage_member(mesh, axis: str, i: int) -> int:
    """The member that runs stage ``i`` of a GPipe: coordinate ``i`` along
    ``axis``, 0 along the others."""
    return mesh.coords().index(tuple(i if a == axis else 0 for a in mesh.axis_names))


def _sum_pieces(gs: list) -> torch.Tensor:
    """The whole gradient of a tensor whose pieces along dim 0 were each
    used once, from the pieces' cotangents: stacked, with autograd's own sum
    of the zero-padded pieces (each element gets ``+ 0.0``, which turns
    ``-0.0`` into ``+0.0``) when there is more than one."""
    whole = torch.stack(gs)
    return whole + 0.0 if len(gs) > 1 else whole


class _Pieces(Function):
    """The pieces along dim 0 of whole tensors that every process holds:
    ``plan`` lists ``(tensor, piece, owner, device)`` for every piece.
    Forward returns the chain token and a copy of each piece this process
    owns, on its device; backward gathers every piece's cotangent from its
    owner (every process takes part) and gives each whole tensor its
    gradient (:func:`_sum_pieces`)."""

    @staticmethod
    def forward(ctx, plan, token, *whole):
        ctx.plan, ctx.like = plan, [(t.shape, t.dtype, t.device) for t in whole]
        me = dist.get_rank()
        return (token.new_empty(0), *(whole[n][k].to(dev, copy=True)
                                      for n, k, owner, dev in plan if owner == me))

    @staticmethod
    def backward(ctx, g_token, *gs):
        me = dist.get_rank()
        keys = [(n, k) for n, k, owner, _ in ctx.plan if owner == me]
        items = [((n, k), owner, tuple(ctx.like[n][0][1:]), ctx.like[n][1])
                 for n, k, owner, _ in ctx.plan]
        got = exchange(items, dict(zip(keys, gs)), ctx.like[0][2])
        return (None, torch.zeros_like(g_token),
                *(_sum_pieces([got[n, k].to(device) for k in range(shape[0])])
                  for n, (shape, _, device) in enumerate(ctx.like)))


class _Hops(Function):
    """One tick's hops between processes: ``plan`` lists ``(key, source,
    destination, shape, dtype)``. Forward sends the tensors this process is
    the source of and returns the chain token and those it is the
    destination of, in plan order; backward sends their cotangents back to
    the sources. Every process takes part in both."""

    @staticmethod
    def forward(ctx, plan, device, token, *mine):
        me = dist.get_rank()
        ctx.plan, ctx.device = plan, device
        got = exchange([(k, src, shape, dtype) for k, src, _, shape, dtype in plan],
                       dict(zip([k for k, src, *_ in plan if src == me], mine)), device)
        return (token.new_empty(0), *(got[k] for k, _, dst, *_ in plan if dst == me))

    @staticmethod
    def backward(ctx, g_token, *gs):
        me = dist.get_rank()
        got = exchange([(k, dst, shape, dtype) for k, _, dst, shape, dtype in ctx.plan],
                       dict(zip([k for k, _, dst, *_ in ctx.plan if dst == me], gs)),
                       ctx.device)
        return (None, None, torch.zeros_like(g_token),
                *(got[k] for k, src, *_ in ctx.plan if src == me))


class _Outputs(Function):
    """The last stage's M outputs, stacked, on every process: forward
    gathers them from ``owner``, the last stage's process (every process
    takes part); backward keeps the owner's own cotangent, the loss over
    them being replicated."""

    @staticmethod
    def forward(ctx, owner, shape, dtype, device, token, *mine):
        ctx.owner, ctx.m = owner, shape[0]
        got = exchange([(j, owner, tuple(shape[1:]), dtype) for j in range(shape[0])],
                       dict(enumerate(mine)), device)
        return torch.stack([got[j] for j in range(shape[0])])

    @staticmethod
    def backward(ctx, g):
        mine = tuple(g[j] for j in range(ctx.m)) if dist.get_rank() == ctx.owner else ()
        return (None, None, None, None, g.new_zeros(0), *mine)


def _pipeline_forward_across(stage_fn: Callable, stacked_params: dict, x: torch.Tensor, mesh,
                             axis: str, s: int) -> tuple[torch.Tensor, int]:
    """:func:`pipeline_forward` on a mesh over processes: each process runs
    the units of the stages it holds; a token threads every collective of
    the call in program order, so autograd reaches each one's backward on
    every process, in the same (reverse) order."""
    m, me = x.shape[0], mesh.rank
    ids = [_stage_member(mesh, axis, i) for i in range(s)]
    owners = [mesh.owners[k] for k in ids]
    devices = [mesh.devices[k] for k in ids]
    names = list(stacked_params)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, *stacked_params.values()])
    token = torch.zeros(0, device=x.device, requires_grad=grad)
    plan = [(n, i, owners[i], devices[i]) for n in range(len(names)) for i in range(s)]
    token, *mine = _Pieces.apply(plan, token, *stacked_params.values())
    params, mine = {}, iter(mine)
    for n, i, owner, _ in plan:
        if owner == me:
            params.setdefault(i, {})[names[n]] = next(mine)
    home = mesh.local_devices[0] if mesh.local else x.device
    outs, inbox, units = {}, {}, 0
    for t in range(m + s - 1):
        nxt, sends, live = {}, {}, [i for i in range(s) if 0 <= t - i < m]
        for i in live:
            if owners[i] != me:
                continue
            j = t - i
            y = stage_fn(params[i], x[j].to(devices[i]) if i == 0 else inbox[i])
            units += 1
            if i == s - 1:
                outs[j] = y
            elif owners[i + 1] == me:
                nxt[i + 1] = y.to(devices[i + 1])
            else:
                sends[i + 1] = y
        hops = [(i + 1, owners[i], owners[i + 1], tuple(x.shape[1:]), x.dtype)
                for i in live if i < s - 1 and owners[i] != owners[i + 1]]
        if hops:
            token, *got = _Hops.apply(hops, home, token,
                                      *(sends[k] for k, src, *_ in hops if src == me))
            for (k, *_), y in zip([h for h in hops if h[2] == me], got):
                nxt[k] = y.to(devices[k])
        inbox = nxt
    mine = [outs[j].to(x.device) for j in range(m)] if owners[-1] == me else []
    return _Outputs.apply(owners[-1], tuple(x.shape), x.dtype, x.device, token, *mine), units


def pipeline_forward(stage_fn: Callable, stacked_params: dict, x: torch.Tensor, mesh,
                     axis: str = "pp", stats: dict | None = None) -> torch.Tensor:
    """Microbatches through S = ``mesh.shape[axis]`` stages, GPipe's
    fill-and-drain: ``stage_fn(params, x)`` (one stage's dict, leading dim
    stripped, and a (Bm, ...) microbatch) keeps shape and dtype;
    ``stacked_params`` leaves carry the leading stage dim S; ``x`` is the
    (M, Bm, ...) stack. Tick ``t`` runs stage ``i`` on microbatch ``t - i``,
    over ``M + S - 1`` ticks. Returns the last stage's (M, Bm, ...) outputs
    on ``x``'s device: the S stages applied in sequence. Differentiable: the
    gradients flow back through the hops to each stage's slice of
    ``stacked_params``.

    On a mesh over processes stage ``i`` runs on the process holding its
    member (coordinate ``i`` along ``axis``, 0 along the others); every
    process returns the whole outputs, and ``stacked_params`` gets its whole
    gradient on every process, bitwise the one-process mesh's. ``x`` gets
    its gradient on the process of stage 0."""
    s = _stage_count(stacked_params, mesh, axis)
    m = x.shape[0]
    if mesh.crosses_processes:
        out, units = _pipeline_forward_across(stage_fn, stacked_params, x, mesh, axis, s)
        if stats is not None:
            stats.update(ticks=m + s - 1, forward_units=units)
        return out
    devices = [mesh.device_at({axis: i}) for i in range(s)]
    params = [{n: t[i].to(dev) for n, t in stacked_params.items()}
              for i, dev in enumerate(devices)]
    outs, inbox, units = [None] * m, [None] * s, 0
    for t in range(m + s - 1):
        nxt = [None] * s
        for i in range(s):
            j = t - i
            if not 0 <= j < m:
                continue
            y = stage_fn(params[i], x[j].to(devices[i]) if i == 0 else inbox[i])
            units += 1
            if i == s - 1:
                outs[j] = y.to(x.device)
            else:
                nxt[i + 1] = y.to(devices[i + 1])
        inbox = nxt
    if stats is not None:
        stats.update(ticks=m + s - 1, forward_units=units)
    return torch.stack(outs)


def _cells(mesh, axis: str, dp_axis: str | None) -> dict:
    """``{(dp replica, stage): the members there}``: one member, or the
    stage's tp group in row-major order."""
    names = mesh.axis_names
    out: dict = {}
    for i, c in enumerate(mesh.coords()):
        d = c[names.index(dp_axis)] if dp_axis is not None else 0
        out.setdefault((d, c[names.index(axis)]), []).append(i)
    return out


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable, stacked_params: dict,
                        x: torch.Tensor, y: torch.Tensor, mesh, axis: str = "pp",
                        dp_axis: str | None = None, param_specs: dict | None = None,
                        stats: dict | None = None) -> tuple[torch.Tensor, list]:
    """One 1F1B step over S = ``mesh.shape[axis]`` stages (see the module's
    docstring for the schedule). ``x`` and ``y`` are (M, Bm, ...) stacks;
    ``loss_fn(out_mb, y_mb)`` is a scalar, applied on the last stage, whose
    cotangent seeds the backward in the same tick. Returns ``(loss, grads)``:
    the mean of ``loss_fn`` over the microbatches (a 0-d tensor on the last
    stage's device), and one dict a mesh member this process holds of its
    gradients, each cut like its parameter (leading dim 1) and lying on the
    member's device, as :func:`stage_shardings` places them;
    :func:`stack_stage_grads` puts them together. The gradients equal the
    sequential S stages' under autograd with the same mean-over-microbatches
    loss. On a mesh over processes each process runs the members it holds
    of each cell (a stage's tp group may be split between processes) and
    returns the loss (on its first member's device) and its members'
    gradients, bitwise the one-process mesh's.

    ``dp_axis`` (a second axis): each dp replica pipelines its own slice of
    every microbatch (dim 1), and the losses and gradients are summed over
    dp in member order and divided by ``M * dp`` (so ``loss_fn`` should be a
    mean over its batch dim), the dp replicas getting the same bits.

    ``param_specs`` overrides :func:`stage_specs`: specs that also split the
    stage leaves over a ``tp`` axis put tensor parallelism inside the
    stages. On a mesh with a ``tp`` axis, ``stage_fn(params, xs)`` takes the
    stage's tp group as lists, one parameter dict and one input a member
    (each input a copy of the whole activation), and returns the members'
    outputs; it runs megatron's pair, :func:`~.collectives.tp_replicate`
    before a column-parallel product and :func:`~.collectives.tp_all_reduce`
    after a row-parallel one, and the gradients come back tp-split. Where
    the stage's tp group is split between processes, ``xs`` is a
    :class:`~.collectives.Members` of this process's members (their inputs,
    ``params`` theirs), and each list the stage hands a collective keeps
    that kind (:func:`~.collectives.like`), so the collective runs across
    the group."""
    s = mesh.shape[axis]
    m = x.shape[0]
    if y.shape[0] != m:
        raise ValueError(f"x has {m} microbatches, y has {y.shape[0]}")
    dp = 1
    if dp_axis is not None:
        if dp_axis not in mesh.axis_names:
            raise ValueError(f"dp_axis {dp_axis!r} not in mesh axes {mesh.axis_names}")
        dp = mesh.shape[dp_axis]
        for name, arr in (("x", x), ("y", y)):
            if arr.ndim < 2 or arr.shape[1] % dp:
                raise ValueError(
                    f"{name} microbatch dim {tuple(arr.shape[1:2])} not divisible by "
                    f"{dp_axis}={dp}")
    _stage_count(stacked_params, mesh, axis)
    other = set(mesh.axis_names) - {axis, dp_axis, "tp"}
    if other:
        raise ValueError(f"mesh axes {sorted(other)} are not pipeline, dp or tp axes")
    tp = "tp" in mesh.axis_names
    specs = param_specs if param_specs is not None else stage_specs(stacked_params, axis)
    members = stage_shardings(stacked_params, mesh, axis, specs)
    # each local member's stage leaves (leading dim stripped), by member id:
    # plain for the forward units, leaves with gradients on for the backward
    # units' recompute
    plain = {k: {n: t[0] for n, t in p.items()} for k, p in zip(mesh.local, members)}
    leaves = {k: {n: t.detach().requires_grad_() for n, t in p.items()} for k, p in plain.items()}
    gacc = {k: {n: torch.zeros_like(t, dtype=torch.float32) for n, t in p.items()}
            for k, p in plain.items()}
    cells = _cells(mesh, axis, dp_axis)
    # each cell's members this process holds, by position in the cell's tp
    # group; a group split between processes runs its collectives on the
    # group's layout (a Members of this process's share)
    held = {c: [p for p, k in enumerate(group) if mesh.slot(k) is not None]
            for c, group in cells.items()}
    tp_index = {tuple(g): n for n, g in enumerate(mesh.groups("tp"))} if tp else {}
    layouts = {c: mesh.layout("tp", tp_index[tuple(group)]) for c, group in cells.items()
               if held[c] and len(held[c]) < len(group)}
    me = mesh.rank
    home = mesh.local_devices[0] if mesh.local else x.device
    n_ticks = m + 2 * (s - 1)
    r = min(2 * (s - 1) + 1, m)              # residual ring slots actually reachable

    def owner_of(c, p: int) -> int:
        return mesh.owners[cells[c][p]]

    def members(c, xs: list) -> list:
        return Members(xs, layouts[c]) if c in layouts else xs

    def run(c, ps, xs):
        return list(stage_fn(ps, members(c, xs))) if tp else [stage_fn(ps[0], xs[0])]

    def rows(arr, j, d, c):
        return [arr[j].chunk(dp)[d].to(mesh.devices[cells[c][p]]) for p in held[c]]

    def hops(t: int) -> list:
        """This tick's hops between two members of neighbouring stages in
        different processes, in cell and position order: ``((kind, dest
        cell, position), source, dest, shape, dtype)``; a stage's input,
        output and input cotangent all take ``x``'s row shape and dtype."""
        out = []
        for (d, i), group in cells.items():
            shape = tuple(x[0].chunk(dp)[d].shape)
            for p in range(len(group)):
                src = owner_of((d, i), p)
                if 0 <= t - i < m and i < s - 1 and src != owner_of((d, i + 1), p):
                    out.append((("f", (d, i + 1), p), src, owner_of((d, i + 1), p), shape,
                                x.dtype))
                if 0 <= t - 2 * (s - 1) + i < m and i > 0 and src != owner_of((d, i - 1), p):
                    out.append((("b", (d, i - 1), p), src, owner_of((d, i - 1), p), shape,
                                x.dtype))
        return out

    def hand_on(kind: str, c, p: int, y, into: dict, sends: dict) -> None:
        """Member ``p``'s output (or input cotangent) ``y`` to position ``p``
        of cell ``c``: in place when this process holds it, else queued for
        the tick's exchange."""
        k = cells[c][p]
        if mesh.slot(k) is not None:
            into.setdefault(c, {})[p] = y.to(mesh.devices[k])
        else:
            sends[kind, c, p] = y.detach()

    ring = {c: {} for c in cells}
    lacc = [0.0] * dp
    fwd_in, bwd_in = {}, {}
    f_units = b_units = peak = 0
    with torch.enable_grad():
        for t in range(n_ticks):
            f_next, b_next, sends = {}, {}, {}
            for (d, i), group in cells.items():
                c = (d, i)
                if not held[c]:
                    continue
                local = [group[p] for p in held[c]]
                seed = None
                jf = t - i
                if 0 <= jf < m:
                    x_in = rows(x, jf, d, c) if i == 0 else \
                        [fwd_in[c][p] for p in held[c]]
                    out = run(c, [plain[k] for k in local], x_in)
                    ring[c][jf % r] = x_in
                    peak = max(peak, len(ring[c]))
                    f_units += 1
                    if i == s - 1:
                        # the last stage seeds its backward unit (the same
                        # microbatch, this tick) from the loss
                        seed = []
                        for p, o, y_k in zip(held[c], out, rows(y, jf, d, c)):
                            o = o.detach().requires_grad_()
                            loss = loss_fn(o, y_k)
                            seed.append(torch.autograd.grad(loss, o)[0])
                            if p == 0:
                                lacc[d] = lacc[d] + loss.detach().float()
                    else:
                        for p, o in zip(held[c], out):
                            hand_on("f", (d, i + 1), p, o, f_next, sends)
                jb = t - 2 * (s - 1) + i
                if 0 <= jb < m:
                    x_res = [v.detach().requires_grad_() for v in ring[c].pop(jb % r)]
                    cot = seed if i == s - 1 else [bwd_in[c][p] for p in held[c]]
                    ps = [leaves[k] for k in local]
                    flat = [leaf for q in ps for leaf in q.values()]
                    grads = torch.autograd.grad(run(c, ps, x_res), flat + x_res, cot,
                                                allow_unused=True, materialize_grads=True)
                    pos = 0
                    for k in local:
                        for n in gacc[k]:
                            gacc[k][n] += grads[pos].float()
                            pos += 1
                    b_units += 1
                    if i > 0:
                        for p, g in zip(held[c], grads[pos:]):
                            hand_on("b", (d, i - 1), p, g, b_next, sends)
            plan = hops(t) if mesh.crosses_processes else []
            if plan:
                got = exchange([(key, src, shape, dtype) for key, src, _, shape, dtype in plan],
                               sends, home)
                for (kind, c, p), _, dst, *_ in plan:
                    if dst == me:
                        into = f_next if kind == "f" else b_next
                        into.setdefault(c, {})[p] = got[kind, c, p].to(
                            mesh.devices[cells[c][p]])
            fwd_in, bwd_in = f_next, b_next
    if mesh.crosses_processes:
        # each replica's loss from the process of its last stage's first member
        first = [owner_of((d, s - 1), 0) for d in range(dp)]
        mine = {d: lacc[d] for d in range(dp) if first[d] == me}
        got = exchange([(d, first[d], (), torch.float32) for d in range(dp)], mine, home)
        lacc = [got[d] for d in range(dp)]
    loss = member_sum(lacc) / (m * dp)
    # each member with its dp replicas (alone without dp_axis)
    groups = mesh.groups(dp_axis)
    every = gacc
    if any(len({mesh.owners[k] for k in group}) > 1 for group in groups):
        every = dict(enumerate(every_member(mesh, [gacc[k] for k in mesh.local])))
    out_grads = {}
    for group in groups:
        local = [k for k in group if mesh.slot(k) is not None]
        if not local:
            continue
        for n in gacc[local[0]]:
            total = member_sum([every[k][n] for k in group]) / (m * dp)
            for k in local:
                dev, dtype = mesh.devices[k], plain[k][n].dtype
                out_grads.setdefault(k, {})[n] = total.to(dev, dtype, copy=True)[None]
    out_grads = [out_grads[k] for k in mesh.local]
    if stats is not None:
        stats.update(ticks=n_ticks, forward_units=f_units, backward_units=b_units,
                     residual_peak=peak)
    return loss, out_grads
