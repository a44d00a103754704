"""Switch-style mixture-of-experts FFN with expert parallelism: the port of
the reference's ``ops/moe.py``.

Routing is grouped (GShard): the ``n`` tokens are cut into ``g`` groups of
``s`` (zero rows padded after the last real token), and each expert takes at
most ``cap`` tokens a group, so dispatch and combine are dense one-hot
tensors of static shape and the expert compute is three products. The
router is an f32 ``Linear`` on f32 input. ``router_type="tokens"`` routes
each token to its top-1 (Switch) or top-2 (GShard; the second choice queues
after every first choice of its group) expert, dropping what overflows an
expert's capacity; ``"experts"`` lets each expert take its top-``cap``
tokens a group (expert choice), ties to the lower token index.

The router terms the reference sows come back through a per-forward dict
(``terms``): ``router_z_loss`` (ST-MoE's logsumexp term over real rows /
n), ``aux_loss`` (Switch's load-balance term, tokens only),
``drop_fraction`` (tokens) or ``unrouted_fraction`` (experts), metrics not
losses. :func:`moe_metrics` averages them over layers.

Arithmetic as the reference computes it: the expert products take bf16
operands and return bf16, then go to f32, and the f32 bias is added; the
gelu between them is ``jax.nn.gelu``'s tanh form in f32. The one-hots are
comparisons (``jax.nn.one_hot(-1)`` is all zeros; ``F.one_hot`` raises).

Under expert parallelism (:meth:`SwitchFFN.members_forward`, run by the
sharded training step over a ``("dp", "ep")`` mesh) the expert stacks split
along E over ``ep`` (:func:`expert_spec`) and the groups over the mesh's
token shards (dp x ep): each member routes its own groups, the dispatched
tokens go to the members that hold their experts by an all-to-all (split E,
concatenate groups), the expert outputs come back by the reverse exchange,
and the combined groups are all-gathered again. On a mesh over processes
each process routes and runs the experts of its own members; the
exchanges along ``ep`` and the sums along ``dp`` cross processes where
their groups do (:func:`~beholder_tpu_torch.parallel.collectives.along`),
and the counts summed over every member come from every process, folded in
member order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from beholder_tpu_torch.device import resolve_device
from beholder_tpu_torch.parallel.collectives import (
    all_reduce,
    all_to_all,
    along,
    gather_from_members,
    member_sum,
    process_gather,
    scatter_to_members,
    tp_all_reduce,
)
from beholder_tpu_torch.parallel.sharding import expert_spec

#: the router terms a layer reports, in ``terms``
TERM_NAMES = ("drop_fraction", "aux_loss", "router_z_loss", "unrouted_fraction")


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot by comparison: an index outside 0..n-1 (-1) gives zeros."""
    return (x.to(torch.int64)[..., None] == torch.arange(n, device=x.device)).float()


def _gelu_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) in f32, op for op."""
    c = 0.7978845608028654
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def _top_cap(scores: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the ``cap`` largest entries along the last dim, ties to the
    lower index (``lax.top_k``'s order): a stable sort on -score."""
    return torch.sort(-scores, dim=-1, stable=True).indices[..., :cap]


def tok_shards(mesh, token_axes=("dp", "ep")) -> int:
    if mesh is None:
        return 1
    n = 1
    for a in token_axes:
        n *= mesh.shape.get(a, 1)
    return n


def grouping(n: int, group_size: int, shards: int, capacity_factor: float, topk: int,
             num_experts: int) -> tuple[int, int, int]:
    """``(g, s, cap)`` exactly as the reference computes them: ``s =
    min(group_size, n)`` tokens a group, ``g`` rounded up to a multiple of
    the token shards, ``s = ceil(n / g)`` again, then ``cap =
    max(1, int(capacity_factor * topk * s / E))``."""
    s = min(group_size, n)
    g = -(-n // s)
    if shards > 1:
        g = -(-g // shards) * shards
        s = -(-n // g)
    cap = max(1, int(capacity_factor * topk * s / num_experts))
    return g, s, cap


class SwitchFFN(nn.Module):
    """(B, T, D) -> (B, T, D) routed FFN. Tokens beyond an expert's capacity
    contribute zero (the block's residual carries them). ``mesh`` only sets
    the grouping here (the token shards of its ``dp``/``ep`` axes); the
    sharded step runs the exchange (:meth:`members_forward`).

    The layer lies on the card unless ``device`` names another (no CUDA
    device raises). The expert stacks start as the reference's
    ``lecun_normal`` would draw them in scale: normal with std
    ``1/sqrt(fan_in)`` (``dim`` up, ``ff_dim`` down) from torch's generator;
    the bridge (:func:`~beholder_tpu_torch.models.bridge.load_flax_params`)
    loads given ones."""

    def __init__(self, dim: int, ff_dim: int, num_experts: int, *,
                 capacity_factor: float = 2.0, group_size: int = 1024, router_topk: int = 1,
                 router_type: str = "tokens", mesh=None, token_axes=("dp", "ep"), device=None):
        super().__init__()
        self.dim, self.ff_dim, self.num_experts = dim, ff_dim, num_experts
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.router_topk, self.router_type = router_topk, router_type
        self.mesh, self.token_axes = mesh, token_axes
        e, device = num_experts, resolve_device(device)
        self.router = nn.Linear(dim, e, device=device)
        self.expert_up = nn.Parameter(
            torch.randn(e, dim, ff_dim, device=device) / math.sqrt(dim))
        self.expert_up_bias = nn.Parameter(torch.zeros(e, ff_dim, device=device))
        self.expert_down = nn.Parameter(
            torch.randn(e, ff_dim, dim, device=device) / math.sqrt(ff_dim))
        self.expert_down_bias = nn.Parameter(torch.zeros(e, dim, device=device))

    def _check(self) -> None:
        if self.router_type == "experts":
            if self.router_topk != 1:
                raise ValueError(
                    "router_topk is a token-choice setting; expert-choice capacity comes "
                    "from capacity_factor alone: set router_topk=1"
                )
        elif self.router_type != "tokens":
            raise ValueError(
                f"router_type must be 'tokens' or 'experts', got {self.router_type!r}"
            )
        elif self.router_topk not in (1, 2):
            raise ValueError(f"router_topk must be 1 or 2, got {self.router_topk}")

    def _grouping(self, n: int, mesh) -> tuple[int, int, int]:
        return grouping(n, self.group_size, tok_shards(mesh, self.token_axes),
                        self.capacity_factor, self.router_topk, self.num_experts)

    def forward(self, x: torch.Tensor, terms: dict | None = None) -> torch.Tensor:
        """The layer on one device; router terms into ``terms`` when given."""
        b, t, d = x.shape
        xg, valid, cap = self._groups(x, self.mesh)
        route = _route(self, self._params(), xg, valid, cap)
        y = _combine(route, _experts(_dispatch(route, xg), *self._expert_params()))
        if terms is not None:
            terms.update(_terms(self, route.parts, b * t))
        return y.reshape(-1, d)[:b * t].reshape(b, t, d).to(x.dtype)

    def routing(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """The dispatch one-hots this layer gives ``x`` (B, T, D), grouped as
        under ``mesh`` (the layer's own when None): (G, S, E, C) for tokens,
        (G, E, C, S) for experts."""
        xg, valid, cap = self._groups(x, self.mesh if mesh is None else mesh)
        return _route(self, self._params(), xg, valid, cap).dispatch

    def _groups(self, x: torch.Tensor, mesh) -> tuple:
        """``x`` as f32 (G, S, D) groups, zero rows padded after the last
        real token, with the (G, S, 1) mask of real rows and the capacity."""
        self._check()
        b, t, d = x.shape
        n = b * t
        g, s, cap = self._grouping(n, mesh)
        xf = x.reshape(n, d).float()
        if g * s != n:
            xf = torch.cat([xf, xf.new_zeros(g * s - n, d)])
        valid = (torch.arange(g * s, device=x.device) < n).float().reshape(g, s, 1)
        return xf.reshape(g, s, d), valid, cap

    def _params(self) -> tuple:
        return self.router.weight, self.router.bias

    def _expert_params(self) -> tuple:
        return self.expert_up, self.expert_up_bias, self.expert_down, self.expert_down_bias

    def members_forward(self, params: list[dict], xs: list, mesh, prefix: str,
                        terms: list[dict]) -> list:
        """Expert parallelism over ``mesh`` (axes ``dp`` and ``ep``; ``xs``
        one (B/dp, T, D) row a member, replicated over ``ep``). Each member
        routes its own groups and reports the terms of the whole batch in
        its ``terms``: the load-balance fractions and the drop counts are
        summed over every member, the z-loss over the row's members (its dp
        mean comes from the step's 1/dp weights). Each member's ``terms``
        also keeps its ``groups`` (G', S, D) and their ``dispatch``
        one-hots, detached, for checks."""
        self._check()
        if set(mesh.axis_names) - {"dp", "ep"}:
            raise ValueError(f"the MoE layer shards over dp and ep only, got {mesh.axis_names}")
        ep = mesh.shape.get("ep", 1)
        b, t, d = xs[0].shape
        n_row = b * t
        n = n_row * mesh.shape.get("dp", 1)
        g, s, cap = self._grouping(n, mesh)
        shards = tok_shards(mesh, self.token_axes)
        if g * s != n or n_row % (s * ep):
            raise ValueError(
                f"a dp row's {n_row} tokens must fill whole groups of {s} on each of its {ep} "
                f"members ({g} groups over {shards} token shards)"
            )
        rows = [x.float().reshape(n_row // s, s, d) for x in xs]
        own = along(mesh, "ep", scatter_to_members, rows, dim=0)
        routes = []
        for p, xg in zip(params, own):
            valid = torch.ones(*xg.shape[:2], 1, device=xg.device)
            routes.append(_route(self, (p[prefix + "router.weight"], p[prefix + "router.bias"]),
                                 xg, valid, cap))
        xin = along(mesh, "ep", all_to_all, [_dispatch(r, xg) for r, xg in zip(routes, own)],
                    split_dim=1, concat_dim=0)
        outs = [_experts(xi, *(p[prefix + k] for k in ("expert_up", "expert_up_bias",
                                                        "expert_down", "expert_down_bias")))
                for p, xi in zip(params, xin)]
        outs = along(mesh, "ep", all_to_all, outs, split_dim=0, concat_dim=1)
        ys = [_combine(r, o) for r, o in zip(routes, outs)]
        ys = along(mesh, "ep", gather_from_members, ys, dim=0)
        self._member_terms(mesh, routes, n, terms)
        for out, r, xg in zip(terms, routes, own):
            out["dispatch"], out["groups"] = r.dispatch.detach(), xg.detach()
        return [y.reshape(b, t, d).to(x.dtype) for y, x in zip(ys, xs)]

    def _member_terms(self, mesh, routes, n: int, terms: list[dict]) -> None:
        """Each member's terms from the members' partial sums: the
        differentiable ones summed over ``ep`` with megatron's *g* (each ep
        member back-propagates its own copy of the loss) and, for the
        load-balance fractions, over ``dp`` by a true all-reduce; the
        metrics (no gradient) summed over every member."""
        dp = mesh.shape.get("dp", 1)
        parts = [r.parts for r in routes]
        z = along(mesh, "ep", tp_all_reduce, [p["z2"] for p in parts])
        z = [v * (dp / n) for v in z]                 # the row's share, n / dp rows
        counted = [k for k in ("assigned", "picked", "frac_tokens") if k in parts[0]]
        every = _every_member(mesh, [[p[k].detach() for k in counted] for p in parts])
        count = {k: member_sum([m[c] for m in every]) for c, k in enumerate(counted)}
        fracs = None
        if "frac_probs" in parts[0]:
            fp = along(mesh, "dp", all_reduce,
                       along(mesh, "ep", tp_all_reduce, [p["frac_probs"] for p in parts]))
            ft = count["frac_tokens"]
            fracs = [(ft.to(f.device) / n, f / n) for f in fp]
        for m, out in enumerate(terms):
            out["router_z_loss"] = z[m]
            dev = z[m].device
            if fracs is not None:
                ft_n, fp_n = fracs[m]
                out["aux_loss"] = self.num_experts * torch.sum(ft_n * fp_n)
            if "assigned" in count:
                out["drop_fraction"] = 1.0 - count["assigned"].to(dev) / (n * self.router_topk)
            if "picked" in count:
                out["unrouted_fraction"] = 1.0 - count["picked"].to(dev) / n


def _every_member(mesh, local: list) -> list:
    """Every mesh member's list of tensors, in member order: ``local`` (one
    list a member this process holds) as it is on a one-process mesh, else
    gathered from every process
    (:func:`~beholder_tpu_torch.parallel.collectives.process_gather`)."""
    if not mesh.crosses_processes:
        return local
    return process_gather(mesh, local)


class _Route:
    """One routing decision: ``dispatch`` and ``combine`` (tokens: (G, S, E,
    C) each; experts: (G, E, C, S) dispatch and (G, E, C) gate values), and
    ``parts``, the partial sums of the router terms over these groups."""

    def __init__(self, kind, dispatch, combine, parts):
        self.kind, self.dispatch, self.combine, self.parts = kind, dispatch, combine, parts


def _route(layer: SwitchFFN, router: tuple, xg: torch.Tensor, valid: torch.Tensor,
           cap: int) -> _Route:
    """Route (G, S, D) f32 groups; ``valid`` (G, S, 1) masks padding rows
    out of routing and out of every term."""
    w, bias = router
    e = layer.num_experts
    # one product a group, so a group's logits (and so its routing) take the
    # same bits however many groups a member routes: a GEMM's kernel, and
    # its sums' order, depend on its row count, and near-tied tokens would
    # route otherwise
    wt = w.float().t()
    logits = torch.stack([torch.matmul(x, wt) for x in xg]) + bias.float()
    probs = torch.softmax(logits, dim=-1)
    z = torch.logsumexp(logits, dim=-1)
    parts = {"z2": torch.sum(z * z * valid[..., 0])}
    if layer.router_type == "experts":
        s = xg.shape[1]
        cap = min(s, max(1, int(layer.capacity_factor * s / e)))
        scores = torch.where(valid > 0, probs, torch.full_like(probs, -1.0))
        idx = _top_cap(scores.transpose(1, 2), cap)             # (G, E, C)
        dispatch = _one_hot(idx, s)                             # (G, E, C, S)
        gv = torch.einsum("gecs,gse->gec", dispatch, probs * valid)
        picked = torch.clamp(dispatch.sum(dim=(1, 2)), 0.0, 1.0)
        parts["picked"] = torch.sum(picked * valid[..., 0])
        return _Route("experts", dispatch, gv, parts)
    gate = probs.amax(dim=-1)
    onehot = _one_hot(probs.argmax(dim=-1), e) * valid          # (G, S, E)
    pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
    within = (pos >= 0.0) & (pos < cap)
    dispatch = _one_hot(pos.to(torch.int32), cap) * within[..., None]
    if layer.router_topk == 2:
        probs2 = probs * (1.0 - onehot)
        gate2 = probs2.amax(dim=-1)
        onehot2 = _one_hot(probs2.argmax(dim=-1), e) * valid
        count1 = onehot.sum(dim=1, keepdim=True)
        pos2 = (torch.cumsum(onehot2, dim=1) + count1) * onehot2 - 1.0
        within2 = (pos2 >= 0.0) & (pos2 < cap)
        d2 = _one_hot(pos2.to(torch.int32), cap) * within2[..., None]
        denom = torch.clamp(gate + gate2, min=1e-9)
        combine = (dispatch * (gate / denom)[..., None, None]
                   + d2 * (gate2 / denom)[..., None, None])
        dispatch = dispatch + d2
    else:
        combine = dispatch * gate[..., None, None]
    parts["frac_tokens"] = (onehot * valid).sum(dim=(0, 1))
    parts["frac_probs"] = (probs * valid).sum(dim=(0, 1))
    parts["assigned"] = torch.sum(dispatch.sum(dim=(2, 3)) * valid[..., 0])
    return _Route("tokens", dispatch, combine, parts)


def _dispatch(route: _Route, xg: torch.Tensor) -> torch.Tensor:
    """(G, E, C, D) f32: each expert's capacity slots filled with tokens."""
    if route.kind == "experts":
        return torch.einsum("gecs,gsd->gecd", route.dispatch, xg)
    return torch.einsum("gsec,gsd->gecd", route.dispatch, xg)


def _combine(route: _Route, out: torch.Tensor) -> torch.Tensor:
    """(G, S, D) f32: each token's gate-weighted expert outputs."""
    if route.kind == "experts":
        return torch.einsum("gecs,gec,gecd->gsd", route.dispatch, route.combine, out)
    return torch.einsum("gsec,gecd->gsd", route.combine, out)


def _experts(xin, w_up, b_up, w_down, b_down) -> torch.Tensor:
    """(G, E, C, D) -> (G, E, C, D): bf16 products that return bf16, then
    f32 with the f32 bias; f32 tanh gelu between them."""
    bf = torch.bfloat16
    h = torch.einsum("gecd,edf->gecf", xin.to(bf), w_up.to(bf)).float() + b_up[None, :, None, :]
    h = _gelu_f32(h)
    return (torch.einsum("gecf,efd->gecd", h.to(bf), w_down.to(bf)).float()
            + b_down[None, :, None, :])


def _terms(layer: SwitchFFN, parts: dict, n: int) -> dict:
    """The layer's router terms from its partial sums over ``n`` real tokens."""
    out = {"router_z_loss": parts["z2"] / n}
    if "frac_probs" in parts:
        out["aux_loss"] = layer.num_experts * torch.sum(
            (parts["frac_tokens"] / n) * (parts["frac_probs"] / n))
        out["drop_fraction"] = 1.0 - parts["assigned"] / (n * layer.router_topk)
    else:
        out["unrouted_fraction"] = 1.0 - parts["picked"] / n
    return out


def moe_metrics(terms: dict) -> dict[str, float]:
    """Mean of each router term over the layers of one forward's ``terms``
    (``{layer: {term: value}}``, as ``TelemetrySequenceModel`` fills it):
    drop/unrouted fractions, aux loss, z-loss. Reads the values back."""
    sums: dict[str, list] = {}
    for layer in terms.values():
        for key in TERM_NAMES:
            if key in layer:
                sums.setdefault(key, []).append(float(torch.as_tensor(layer[key]).detach()))
    return {k: sum(v) / len(v) for k, v in sums.items()}


def expert_specs(state_dict: dict, axis: str = "ep") -> dict:
    """Spec of each named tensor: expert stacks split along E over ``axis``,
    the rest replicated. Works for params and for Adam moments keyed by the
    same names."""
    return {name: expert_spec(name, t, axis) for name, t in state_dict.items()}


def expert_shardings(state_dict: dict, mesh, axis: str = "ep") -> list[dict]:
    """The members' shards of ``state_dict`` under :func:`expert_specs` on
    ``mesh`` (row-major order)."""
    from beholder_tpu_torch.parallel.sharding import shard_tensors

    return shard_tensors(state_dict, expert_specs(state_dict, axis), mesh)

