"""Weight bridge: the reference's flax params (and optax Adam state) into
the port's modules.

The reference's params are a nested dict (as ``jax.tree.map(np.asarray,
params)`` gives them, with or without the outer ``{"params": ...}``). For
``TelemetrySequenceModel``: ``embed``, ``block_{i}/{LayerNorm_0, q_proj,
k_proj, v_proj, proj, LayerNorm_1, up, down}`` (a MoE block has ``moe``
instead of ``up``/``down``: ``router/{kernel, bias}`` and the expert stacks
``expert_up``, ``expert_up_bias``, ``expert_down``, ``expert_down_bias``,
which keep their layout), a top-level ``LayerNorm_0`` and ``head``; for
``ProgressAnomalyModel``: ``in_proj``, ``mid_proj``, ``out_proj``. A Dense
``kernel (in, out)`` becomes ``weight (out, in)``; a LayerNorm ``scale``
becomes ``weight``. bf16 leaves stay bf16.

:func:`flax_named` maps such a tree (params, or gradients, or Adam moments
of the same structure) to the port's parameter names; :func:`load_optax_adam`
carries an optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) into the
port's ``torch.optim.Adam``, so a step from a mid-training JAX state can be
compared; placing that state on a mesh
(:func:`~beholder_tpu_torch.parallel.mesh.place_seq_state`,
:func:`~beholder_tpu_torch.parallel.zero.place_zero_state`) carries the
moments into the members' slices. :func:`init_params` makes a tree from a
numpy seed without JAX (flax's initialisers in spirit: lecun-normal
kernels, zero biases, unit LayerNorm scales; an expert stack's fan-in is its
own input width), so a run on the card can build a model at full width from
random weights.
"""

from __future__ import annotations

import numpy as np
import torch

from beholder_tpu_torch.ops.moe import SwitchFFN

from .anomaly import ProgressAnomalyModel
from .sequence import FEATURES, TelemetrySequenceModel
from .train import TrainState

_BLOCK_DENSE = ("q_proj", "k_proj", "v_proj", "proj", "up", "down")
#: a MoE block's expert stacks, (E, D, F) / (E, F, D) and their biases: the
#: same layout on both sides, no transpose
_EXPERT_LEAVES = ("expert_up", "expert_up_bias", "expert_down", "expert_down_bias")


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


def _dense(prefix: str, tree: dict) -> dict[str, torch.Tensor]:
    # (in, out) -> (out, in); a stacked (S, in, out) kernel keeps its stage dim
    return {f"{prefix}.weight": _tensor(tree["kernel"]).transpose(-1, -2).contiguous(),
            f"{prefix}.bias": _tensor(tree["bias"])}


def _norm(prefix: str, tree: dict) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _tensor(tree["scale"]), f"{prefix}.bias": _tensor(tree["bias"])}


def _moe(prefix: str, tree: dict) -> dict[str, torch.Tensor]:
    out = _dense(prefix + "router", tree["router"])
    out.update({prefix + name: _tensor(tree[name]) for name in _EXPERT_LEAVES})
    return out


def _block(prefix: str, sub: dict) -> dict[str, torch.Tensor]:
    """A flax ``Block``'s tree as the port's ``Block`` names under ``prefix``."""
    out = _norm(prefix + "ln0", sub["LayerNorm_0"])
    out.update(_norm(prefix + "ln1", sub["LayerNorm_1"]))
    for name in _BLOCK_DENSE:
        if name in sub:
            out.update(_dense(prefix + name, sub[name]))
    if "moe" in sub:
        out.update(_moe(prefix + "moe.", sub["moe"]))
    return out


def flax_stage_params(stacked: dict, prefix: str = "0.") -> dict[str, torch.Tensor]:
    """The reference's stacked pipeline-stage params (numpy leaves with a
    leading stage dim, as ``stack_stage_params`` there makes them) as the
    port's stacked dict (:func:`~beholder_tpu_torch.parallel.stack_stage_params`),
    on the CPU. A flax ``Block``'s tree takes the port's ``Block`` names
    under ``prefix`` (``"0."``: the one block of a stage of
    :func:`~beholder_tpu_torch.models.sequence.pipeline_stages`), each
    stage's kernel transposed; any other dict of leaves (plain ``{"w",
    "b"}`` or ``{"w1", "w2"}`` stages) keeps its names and layout. Works for
    gradients of the same structure."""
    tree = stacked.get("params", stacked)
    if "LayerNorm_0" in tree:
        return _block(prefix, tree)
    return {name: _tensor(leaf) for name, leaf in tree.items()}


def flax_named(model, params: dict) -> dict[str, torch.Tensor]:
    """A flax-shaped tree for ``model`` (a ``TelemetrySequenceModel``, a
    ``ProgressAnomalyModel`` or a ``SwitchFFN``) as ``{port parameter name:
    tensor}``, on the
    CPU. Works for any tree of the params' structure: gradients, Adam
    moments."""
    tree = params.get("params", params)
    if isinstance(model, SwitchFFN):
        return _moe("", tree)
    if isinstance(model, ProgressAnomalyModel):
        out = {}
        for name in ("in_proj", "mid_proj", "out_proj"):
            out.update(_dense(name, tree[name]))
        return out
    out = _dense("embed", tree["embed"])
    for i in range(len(model.blocks)):
        out.update(_block(f"blocks.{i}.", tree[f"block_{i}"]))
    out.update(_norm("ln", tree["LayerNorm_0"]))
    out.update(_dense("head", tree["head"]))
    return out


def load_flax_params(model, params: dict):
    """Copy a flax param tree into ``model`` (on the model's device), in
    place; returns the model."""
    named = flax_named(model, params)
    for name, param in model.named_parameters():
        _set(param, named[name])
    return model


def load_optax_adam(state: TrainState, opt_state) -> TrainState:
    """Set ``state.optimizer``'s Adam moments and step count from an optax
    ``adam`` state, in place: the ``ScaleByAdamState`` itself or the chain
    tuple ``optax.adam`` makes, as numpy arrays. ``count`` becomes the
    step of every parameter, ``mu``/``nu`` its ``exp_avg``/``exp_avg_sq``
    (both in f32, like the params)."""
    parts = (opt_state,) if hasattr(opt_state, "mu") else tuple(opt_state)
    adam_state = next(p for p in parts if hasattr(p, "mu"))
    mu = flax_named(state.model, adam_state.mu)
    nu = flax_named(state.model, adam_state.nu)
    step = torch.tensor(float(np.asarray(adam_state.count)), dtype=torch.float32)
    for name, param in state.model.named_parameters():
        state.optimizer.state[param] = {
            "step": step.clone(),
            "exp_avg": mu[name].to(param.device, param.dtype).clone(),
            "exp_avg_sq": nu[name].to(param.device, param.dtype).clone(),
        }
    return state._replace(step=int(np.asarray(adam_state.count)))


def init_params(
    model: TelemetrySequenceModel, seed: int, *, bf16_matrices: bool = False
) -> dict:
    """A flax-shaped param tree of numpy arrays for ``model`` (a
    ``TelemetrySequenceModel`` or a ``ProgressAnomalyModel``), from a numpy
    seed. ``bf16_matrices`` stores every leaf with ndim >= 2 as bf16
    (returned as torch tensors, since numpy has no bf16), as the serving
    benchmark casts its params."""
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out):
        kernel = rng.normal(0.0, 1.0 / np.sqrt(fan_in), (fan_in, fan_out)).astype(np.float32)
        if bf16_matrices:
            kernel = torch.from_numpy(kernel).to(torch.bfloat16)
        return {"kernel": kernel, "bias": np.zeros(fan_out, np.float32)}

    if isinstance(model, ProgressAnomalyModel):
        hidden = model.mid_proj.in_features
        return {"params": {
            "in_proj": dense(model.in_proj.in_features, hidden),
            "mid_proj": dense(hidden, hidden),
            "out_proj": dense(hidden, 1),
        }}
    d, hkv = model.dim, model.kv_heads or model.heads
    dh = d // model.heads

    def norm():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def experts(moe):
        e, f = moe.num_experts, moe.ff_dim

        def stack(fan_in, fan_out):
            return rng.normal(0.0, 1.0 / np.sqrt(fan_in), (e, fan_in, fan_out)).astype(np.float32)

        return {"router": dense(d, e), "expert_up": stack(d, f),
                "expert_up_bias": np.zeros((e, f), np.float32), "expert_down": stack(f, d),
                "expert_down_bias": np.zeros((e, d), np.float32)}

    tree = {"embed": dense(FEATURES, d)}
    for i, block in enumerate(model.blocks):
        tree[f"block_{i}"] = {
            "LayerNorm_0": norm(),
            "q_proj": dense(d, d),
            "k_proj": dense(d, hkv * dh),
            "v_proj": dense(d, hkv * dh),
            "proj": dense(d, d),
            "LayerNorm_1": norm(),
        }
        if block.ffn == "moe":
            tree[f"block_{i}"]["moe"] = experts(block.moe)
        else:
            tree[f"block_{i}"].update(up=dense(d, 4 * d), down=dense(4 * d, d))
    tree["LayerNorm_0"] = norm()
    tree["head"] = dense(d, 1)
    return {"params": tree}
