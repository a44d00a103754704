"""Pipeline parallelism over a ``pp`` mesh axis: the port's counterpart of
the reference's ``parallel/pipeline.py`` (the GPipe forward, the 1F1B
training step, dp x pp, and tensor parallelism inside the stages).

One process runs every stage on its member's device, an activation or a
cotangent hops to the neighbouring stage with :meth:`~.mesh.Mesh.to`, and
every sum over members runs in member order
(:func:`~.collectives.member_sum`). A mesh over processes is refused: its
hops would cross processes inside the schedule.

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

from .collectives import member_sum, refuse_across_processes
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
    per-member ones (cut under ``specs``), on ``device`` (member 0's when
    None): a bitwise copy, for comparison."""
    return unshard_tensors(grads, specs, mesh, device or mesh.devices[0])


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
    ``stacked_params``."""
    refuse_across_processes(mesh, "a pipeline (GPipe)")
    s = _stage_count(stacked_params, mesh, axis)
    m = x.shape[0]
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
    stage's device), and one dict a mesh member of its gradients, each cut like
    its parameter (leading dim 1) and lying on the member's device, as
    :func:`stage_shardings` places them; :func:`stack_stage_grads` puts them
    together. The gradients equal the sequential S stages' under autograd
    with the same mean-over-microbatches loss.

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
    after a row-parallel one, and the gradients come back tp-split."""
    refuse_across_processes(mesh, "a pipeline (1F1B)")
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
    # each member's stage leaves (leading dim stripped): plain for the
    # forward units, leaves with gradients on for the backward units' recompute
    plain = [{n: t[0] for n, t in p.items()} for p in members]
    leaves = [{n: t.detach().requires_grad_() for n, t in p.items()} for p in plain]
    gacc = [{n: torch.zeros_like(t, dtype=torch.float32) for n, t in p.items()} for p in plain]
    cells = _cells(mesh, axis, dp_axis)
    n_ticks = m + 2 * (s - 1)
    r = min(2 * (s - 1) + 1, m)              # residual ring slots actually reachable

    def run(ps, xs):
        return list(stage_fn(ps, xs)) if tp else [stage_fn(ps[0], xs[0])]

    def rows(arr, j, d, group):
        return [arr[j].chunk(dp)[d].to(mesh.devices[k]) for k in group]

    ring = {c: {} for c in cells}
    lacc = [0.0] * dp
    fwd_in, bwd_in = {}, {}
    f_units = b_units = peak = 0
    with torch.enable_grad():
        for t in range(n_ticks):
            f_next, b_next = {}, {}
            for (d, i), group in cells.items():
                seed = None
                jf = t - i
                if 0 <= jf < m:
                    x_in = rows(x, jf, d, group) if i == 0 else fwd_in.pop((d, i))
                    out = run([plain[k] for k in group], x_in)
                    ring[(d, i)][jf % r] = x_in
                    peak = max(peak, len(ring[(d, i)]))
                    f_units += 1
                    if i == s - 1:
                        # the last stage seeds its backward unit (the same
                        # microbatch, this tick) from the loss
                        seed = []
                        for k, (o, y_k) in enumerate(zip(out, rows(y, jf, d, group))):
                            o = o.detach().requires_grad_()
                            loss = loss_fn(o, y_k)
                            seed.append(torch.autograd.grad(loss, o)[0])
                            if k == 0:
                                lacc[d] = lacc[d] + loss.detach().float()
                    else:
                        nxt = cells[(d, i + 1)]
                        f_next[(d, i + 1)] = [o.to(mesh.devices[k]) for o, k in zip(out, nxt)]
                jb = t - 2 * (s - 1) + i
                if 0 <= jb < m:
                    x_res = [v.detach().requires_grad_() for v in ring[(d, i)].pop(jb % r)]
                    cot = seed if i == s - 1 else bwd_in.pop((d, i))
                    ps = [leaves[k] for k in group]
                    flat = [leaf for p in ps for leaf in p.values()]
                    grads = torch.autograd.grad(run(ps, x_res), flat + x_res, cot,
                                                allow_unused=True, materialize_grads=True)
                    pos = 0
                    for k in group:
                        for n in gacc[k]:
                            gacc[k][n] += grads[pos].float()
                            pos += 1
                    b_units += 1
                    if i > 0:
                        prev = cells[(d, i - 1)]
                        b_next[(d, i - 1)] = [g.to(mesh.devices[k])
                                              for g, k in zip(grads[pos:], prev)]
            fwd_in, bwd_in = f_next, b_next
    loss = member_sum(lacc) / (m * dp)
    out_grads = [{} for _ in range(mesh.size)]
    # each member with its dp replicas (alone without dp_axis)
    for group in mesh.groups(dp_axis):
        for n in gacc[group[0]]:
            total = member_sum([gacc[k][n] for k in group]) / (m * dp)
            for k in group:
                dev, dtype = mesh.devices[k], plain[k][n].dtype
                out_grads[k][n] = total.to(dev, dtype, copy=True)[None]
    if stats is not None:
        stats.update(ticks=n_ticks, forward_units=f_units, backward_units=b_units,
                     residual_peak=peak)
    return loss, out_grads
