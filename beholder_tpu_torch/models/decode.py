"""Dense KV-cached inference: the oracle for the paged serving path.

Port of the reference's ``models/decode.py`` (``init_cache``, ``prefill``,
``decode_step``, ``forecast_deltas``). The cache is one (B, Hkv, max_len,
Dh) bf16 tensor per layer plus a 0-d write index; prefill runs the whole
prefix in one forward and generation is one cached step per token. The
caches are updated in place: a :class:`DecodeCache` handed to
:func:`decode_step` is consumed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beholder_tpu_torch.ops import NUM_STATUSES

from .sequence import TelemetrySequenceModel, one_hot, stream_features


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
