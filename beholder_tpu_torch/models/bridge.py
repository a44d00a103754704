"""Weight bridge: the reference's flax params into the port's modules.

The reference's params are a nested dict (as ``jax.tree.map(np.asarray,
params)`` gives them, with or without the outer ``{"params": ...}``):
``embed``, ``block_{i}/{LayerNorm_0, q_proj, k_proj, v_proj, proj,
LayerNorm_1, up, down}``, a top-level ``LayerNorm_0`` and ``head``. A Dense
``kernel (in, out)`` becomes ``weight (out, in)``; a LayerNorm ``scale``
becomes ``weight``. bf16 leaves stay bf16.

:func:`init_params` makes such a tree from a numpy seed without JAX (flax's
initialisers in spirit: lecun-normal kernels, zero biases, unit LayerNorm
scales), so a run on the card can build the model at full width from
random weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .sequence import FEATURES, TelemetrySequenceModel

_BLOCK_DENSE = ("q_proj", "k_proj", "v_proj", "proj", "up", "down")


def _tensor(arr) -> torch.Tensor:
    """numpy leaf -> torch, keeping bf16 (ml_dtypes' bfloat16, which
    ``torch.from_numpy`` cannot read, goes through its uint16 bits)."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _set(param: torch.nn.Parameter, value: torch.Tensor) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(param.shape)}")
    param.data = value.to(param.device)


def _load_dense(lin: torch.nn.Linear, tree: dict) -> None:
    _set(lin.weight, _tensor(tree["kernel"]).t().contiguous())
    _set(lin.bias, _tensor(tree["bias"]))


def _load_norm(norm, tree: dict) -> None:
    _set(norm.weight, _tensor(tree["scale"]))
    _set(norm.bias, _tensor(tree["bias"]))


def load_flax_params(model: TelemetrySequenceModel, params: dict) -> TelemetrySequenceModel:
    """Copy a flax param tree into ``model`` (on the model's device), in
    place; returns the model."""
    tree = params.get("params", params)
    _load_dense(model.embed, tree["embed"])
    for i, block in enumerate(model.blocks):
        sub = tree[f"block_{i}"]
        _load_norm(block.ln0, sub["LayerNorm_0"])
        _load_norm(block.ln1, sub["LayerNorm_1"])
        for name in _BLOCK_DENSE:
            _load_dense(getattr(block, name), sub[name])
    _load_norm(model.ln, tree["LayerNorm_0"])
    _load_dense(model.head, tree["head"])
    return model


def init_params(
    model: TelemetrySequenceModel, seed: int, *, bf16_matrices: bool = False
) -> dict:
    """A flax-shaped param tree of numpy arrays for ``model``, from a
    numpy seed. ``bf16_matrices`` stores every leaf with ndim >= 2 as bf16
    (returned as torch tensors, since numpy has no bf16), as the serving
    benchmark casts its params."""
    rng = np.random.default_rng(seed)
    d, hkv = model.dim, model.kv_heads or model.heads
    dh = d // model.heads

    def dense(fan_in, fan_out):
        kernel = rng.normal(0.0, 1.0 / np.sqrt(fan_in), (fan_in, fan_out)).astype(np.float32)
        if bf16_matrices:
            kernel = torch.from_numpy(kernel).to(torch.bfloat16)
        return {"kernel": kernel, "bias": np.zeros(fan_out, np.float32)}

    def norm():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    tree = {"embed": dense(FEATURES, d)}
    for i in range(model.layers):
        tree[f"block_{i}"] = {
            "LayerNorm_0": norm(),
            "q_proj": dense(d, d),
            "k_proj": dense(d, hkv * dh),
            "v_proj": dense(d, hkv * dh),
            "proj": dense(d, d),
            "LayerNorm_1": norm(),
            "up": dense(d, 4 * d),
            "down": dense(4 * d, d),
        }
    tree["LayerNorm_0"] = norm()
    tree["head"] = dense(d, 1)
    return {"params": tree}
