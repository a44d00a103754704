"""Dense KV-cached inference: the oracle for the paged serving path.

Port of the reference's ``models/decode.py`` (``init_cache``, ``prefill``,
``decode_step``, ``forecast_deltas``, ``forecast_eta``, and the sharded
serving of ``cache_shardings``, ``sharded_prefill``, ``sharded_decode_step``
and ``sharded_forecast_eta``). The cache is one (B, Hkv, max_len, Dh) bf16
tensor per layer plus a 0-d write index; prefill runs the whole prefix in
one forward and generation is one cached step per token. The caches are
updated in place: a :class:`DecodeCache` handed to :func:`decode_step` is
consumed.

Sharded serving runs over a :class:`~beholder_tpu_torch.parallel.Mesh`:
one process drives every member it holds on its device, and on a mesh over
processes each process serves its own members' rows and the predictions
are gathered from every process, so each returns the whole batch. The
streams split over ``dp``, each member holding its B/dp rows' cache; under
megatron parameters on a ``(dp, tp)`` mesh (:func:`serving_params` with
``seq_state_shardings``' specs) each member also holds only its ``Hkv/tp``
kv heads, ``(B/dp, Hkv/tp, max_len, Dh)``, which it writes and attends
alone (:meth:`~beholder_tpu_torch.models.sequence.Block.members_forward`).
A sharded :class:`DecodeCache` holds, per layer, one tensor a member.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beholder_tpu_torch.ops import NUM_STATUSES

from beholder_tpu_torch.parallel.collectives import exchange
from beholder_tpu_torch.parallel.mesh import Mesh
from beholder_tpu_torch.parallel.sharding import batch_slices, shard_tensors

from .sequence import TelemetrySequenceModel, _linear_f32, layer_norm, one_hot, stream_features


class DecodeCache(NamedTuple):
    """Per-layer key/value tensors (B, Hkv, max_len, Dh) + write index."""

    keys: tuple
    values: tuple
    index: torch.Tensor  # 0-d int64: positions already written


def init_cache(model: TelemetrySequenceModel, batch: int, max_len: int) -> DecodeCache:
    dh = model.dim // model.heads
    hkv = model.kv_heads or model.heads
    shape = (batch, hkv, max_len, dh)
    dev = model.device

    def zeros():
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    return DecodeCache(
        tuple(zeros() for _ in range(model.layers)),
        tuple(zeros() for _ in range(model.layers)),
        torch.zeros((), dtype=torch.int64, device=dev),
    )


def prefill(
    model: TelemetrySequenceModel, feats: torch.Tensor, max_len: int
) -> tuple[torch.Tensor, DecodeCache]:
    """Run the whole (B, T, F) prefix in one forward; return the last
    position's prediction and a cache holding the prefix k/v."""
    b, t, _ = feats.shape
    preds, kvs = model(feats, return_kv=True)
    cache = init_cache(model, b, max_len)
    for (k, v), ck, cv in zip(kvs, cache.keys, cache.values):
        ck[:, :, :t] = k
        cv[:, :, :t] = v
    return preds[:, -1], cache._replace(index=cache.index + t)


def decode_step(
    model: TelemetrySequenceModel, cache: DecodeCache, feats_t: torch.Tensor
) -> tuple[torch.Tensor, DecodeCache]:
    """One autoregressive step on (B, F) features: ((B,) prediction,
    cache advanced by one)."""
    pred, new_kvs = model(
        feats_t[:, None, :], cache=(cache.keys, cache.values, cache.index)
    )
    return pred[:, 0], DecodeCache(
        tuple(k for k, _ in new_kvs), tuple(v for _, v in new_kvs), cache.index + 1
    )


@torch.no_grad()
def forecast_deltas(
    model: TelemetrySequenceModel,
    progress: torch.Tensor,
    statuses: torch.Tensor,
    horizon: int,
) -> torch.Tensor:
    """Roll the model ``horizon`` steps past the observed (B, T+1)
    stream, feeding its own predictions back with the status held at its
    last observed value. Returns (B, horizon) predicted deltas."""
    feats, _ = stream_features(progress, statuses)
    b, t, _ = feats.shape
    last_pred, cache = prefill(model, feats, t + horizon)
    status_oh = one_hot(statuses[:, -1], NUM_STATUSES)
    deltas = []
    delta = last_pred
    for _ in range(horizon):
        deltas.append(delta)
        feats_t = torch.cat([delta[:, None], status_oh], dim=-1)
        delta, cache = decode_step(model, cache, feats_t)
    if not deltas:
        return torch.zeros((b, 0), device=feats.device)
    return torch.stack(deltas, dim=1)


@torch.no_grad()
def forecast_eta(
    model: TelemetrySequenceModel,
    progress: torch.Tensor,
    statuses: torch.Tensor,
    horizon: int,
    target: float = 100.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps until each stream's forecast reaches ``target`` progress.

    Returns (eta_steps (B,), reached (B,) bool): ``eta_steps`` is the number
    of future steps until the cumulative forecast crosses the target
    (``horizon`` where it never does — check ``reached``)."""
    return _eta(progress, forecast_deltas(model, progress, statuses, horizon), horizon, target)


def _eta(progress: torch.Tensor, deltas: torch.Tensor, horizon: int, target: float):
    future = progress[:, -1:].to(deltas.device, deltas.dtype) + torch.cumsum(deltas, dim=-1)
    hit = future >= target
    reached = hit.any(dim=-1)
    first = torch.argmax(hit.to(torch.int8), dim=-1) + 1
    eta = torch.where(reached, first, torch.full_like(first, horizon))
    return eta, reached


# -- sharded serving ----------------------------------------------------------


def cache_shardings(model: TelemetrySequenceModel, mesh, axis: str = "dp",
                    head_axis: str | None = None) -> DecodeCache:
    """The specs of a sharded :class:`DecodeCache` (a spec: one mesh axis
    name or None a dim, ``()`` replicated): keys and values (B, Hkv,
    max_len, Dh) split over ``axis`` on the batch dim and, with
    ``head_axis`` (tensor-parallel serving), over it on the head dim; the
    write index replicated. ``head_axis`` follows the parameters' placement
    (megatron's q/k/v shards each make whole kv heads), so ``Hkv`` must
    divide by it."""
    if head_axis is not None:
        hkv = model.kv_heads or model.heads
        if hkv % mesh.shape[head_axis]:
            raise ValueError(
                f"kv heads ({hkv}) must divide by mesh axis '{head_axis}'="
                f"{mesh.shape[head_axis]} for head-sharded serving — with GQA pick "
                f"kv_heads as a multiple of tp")
    kv = (axis, head_axis, None, None)
    return DecodeCache(tuple(kv for _ in range(model.layers)),
                       tuple(kv for _ in range(model.layers)), ())


def _serving_head_axis(mesh, params_shardings: dict | None, batch_axis: str) -> str | None:
    """``"tp"`` when the parameters' specs use the mesh's ``tp`` axis (the
    cache heads then follow the q/k/v shards), else None: a head-split cache
    beside replicated parameters would reshard k/v every step."""
    if params_shardings is None or "tp" not in mesh.axis_names or batch_axis == "tp":
        return None
    return "tp" if any("tp" in spec for spec in params_shardings.values()) else None


def serving_params(model: TelemetrySequenceModel, mesh, params_shardings: dict | None = None
                   ) -> list[dict]:
    """The model's parameters on ``mesh``: one dict a member, each leaf its
    slice under ``params_shardings`` (``{name: spec}``, e.g. megatron's from
    :func:`~beholder_tpu_torch.parallel.seq_state_shardings`), or a copy of
    the whole leaf when None, on the member's device."""
    tensors = {n: p.detach() for n, p in model.named_parameters()}
    return shard_tensors(tensors, params_shardings or {n: () for n in tensors}, mesh)


class _Serving:
    """How a mesh serves: the mesh the members compute over (the serving
    mesh under tp-split parameters; otherwise every member a replica of its
    batch slice, tp=1), and the members holding the batch slices in order."""

    def __init__(self, model, mesh, axis: str, params_shardings: dict | None):
        head_axis = _serving_head_axis(mesh, params_shardings, axis)
        cache_shardings(model, mesh, axis, head_axis)
        self.model, self.mesh, self.axis = model, mesh, axis
        self.compute = mesh if head_axis else Mesh(list(mesh.devices), ("dp",),
                                                   owners=mesh.owners, rank=mesh.rank)
        self.rows = mesh.groups(axis)[0]

    def gather(self, parts: list) -> torch.Tensor:
        """The batch slices' rows in order, from the members that hold them
        (on a mesh over processes, from every process: the bytes
        unchanged), on the first local member's device."""
        mesh = self.mesh
        dev = mesh.local_devices[0]
        if not mesh.crosses_processes:
            return torch.cat([parts[i].to(dev) for i in self.rows])
        like = parts[0]
        got = exchange([(i, mesh.owners[i], tuple(like.shape), like.dtype) for i in self.rows],
                       {i: parts[mesh.slot(i)] for i in self.rows if mesh.slot(i) is not None},
                       dev)
        return torch.cat([got[i].to(dev) for i in self.rows])

    def _forward(self, params, feats: list, cache=None):
        xs = [_linear_f32(f, p["embed.weight"], p["embed.bias"]) for p, f in zip(params, feats)]
        kvs = []
        for i, block in enumerate(self.model.blocks):
            layer = None if cache is None else (cache.keys[i], cache.values[i], cache.index)
            xs, kv = block.members_forward(params, xs, self.compute, f"blocks.{i}.",
                                           [{} for _ in xs], cache=layer, return_kv=True)
            kvs.append(kv)
        preds = [_linear_f32(layer_norm(x, p["ln.weight"], p["ln.bias"]), p["head.weight"],
                             p["head.bias"])[..., 0] for p, x in zip(params, xs)]
        return preds, kvs

    @torch.no_grad()
    def prefill(self, params, feats: torch.Tensor, max_len: int):
        """Each member's last-position prediction and the sharded cache."""
        t = feats.shape[1]
        preds, kvs = self._forward(params, batch_slices(self.mesh, feats, self.axis))
        keys, values = [], []
        for ks, vs in kvs:
            for new, out in ((ks, keys), (vs, values)):
                shards = []
                for k in new:
                    shard = torch.zeros((*k.shape[:2], max_len, k.shape[3]), dtype=torch.bfloat16,
                                        device=k.device)
                    shard[:, :, :t] = k
                    shards.append(shard)
                out.append(shards)
        index = torch.full((), t, dtype=torch.int64, device=self.mesh.local_devices[0])
        return [p[:, -1] for p in preds], DecodeCache(tuple(keys), tuple(values), index)

    @torch.no_grad()
    def decode(self, params, cache: DecodeCache, feats_t: list):
        """Each member's prediction, the cache advanced by one."""
        preds, kvs = self._forward(params, [f[:, None, :] for f in feats_t], cache)
        return [p[:, 0] for p in preds], DecodeCache(
            tuple(k for k, _ in kvs), tuple(v for _, v in kvs), cache.index + 1)


def sharded_prefill(model: TelemetrySequenceModel, mesh, max_len: int, axis: str = "dp",
                    params_shardings: dict | None = None):
    """:func:`prefill` over ``mesh``: the (B, T, F) features split over
    ``axis``, the cache returned sharded per :func:`cache_shardings` (heads
    over ``tp`` too when ``params_shardings`` split the parameters over it).
    Returns ``fn(params, feats) -> (last_pred (B,), cache)``, ``params`` the
    members' dicts (:func:`serving_params`)."""
    serving = _Serving(model, mesh, axis, params_shardings)

    def fn(params, feats):
        preds, cache = serving.prefill(params, feats, max_len)
        return serving.gather(preds), cache

    return fn


def sharded_decode_step(model: TelemetrySequenceModel, mesh, axis: str = "dp",
                        params_shardings: dict | None = None):
    """:func:`decode_step` over ``mesh`` with the cache staying sharded in
    and out: every member reads and writes only its own shard. Returns
    ``fn(params, cache, feats_t) -> (pred (B,), cache)``."""
    serving = _Serving(model, mesh, axis, params_shardings)

    def fn(params, cache, feats_t):
        preds, cache = serving.decode(params, cache, batch_slices(mesh, feats_t, axis))
        return serving.gather(preds), cache

    return fn


def sharded_forecast_eta(model: TelemetrySequenceModel, mesh, horizon: int,
                         target: float = 100.0, axis: str = "dp",
                         params_shardings: dict | None = None):
    """:func:`forecast_eta` over ``mesh``: the observed streams split over
    ``axis``, prefill, the cache and the whole rollout member-local (each
    member feeds its own predictions back), the deltas gathered once at the
    end. Returns ``fn(params, progress, statuses) -> (eta, reached)``. No
    call reads the device until the caller reads the result."""
    serving = _Serving(model, mesh, axis, params_shardings)

    def fn(params, progress, statuses):
        feats, _ = stream_features(progress, statuses)
        preds, cache = serving.prefill(params, feats, feats.shape[1] + horizon)
        status = batch_slices(mesh, one_hot(statuses[:, -1], NUM_STATUSES), axis)
        deltas = [[] for _ in preds]
        for _ in range(horizon):
            for out, p in zip(deltas, preds):
                out.append(p)
            preds, cache = serving.decode(
                params, cache, [torch.cat([p[:, None], s], dim=-1) for p, s in zip(preds, status)])
        deltas = [torch.stack(d, dim=1) if d else p.new_zeros((p.shape[0], 0))
                  for d, p in zip(deltas, preds)]
        return _eta(progress, serving.gather(deltas), horizon, target)

    return fn
