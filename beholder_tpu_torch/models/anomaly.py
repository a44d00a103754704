"""Progress-stream anomaly model: the port of the reference's
``models/anomaly.py``.

A small MLP predicts the next progress delta of an encode job from a window
of recent (progress delta, one-hot status) observations; the absolute
prediction error is the anomaly score.

The arithmetic follows what the flax module computes: the input is rounded
to bf16, then every Dense runs in f32. (The reference's ``Dense`` layers
carry no ``dtype``, so flax promotes the bf16 input and the f32 params to
f32: its products are f32, not bf16.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from beholder_tpu_torch.device import resolve_device
from beholder_tpu_torch.ops import NUM_STATUSES
from beholder_tpu_torch.parallel.collectives import along, tp_all_reduce, tp_replicate
from beholder_tpu_torch.parallel.sharding import batch_slices

from .sequence import one_hot
from .train import TrainState, apply_gradients, init_state

WINDOW = 16  # observations per window
FEATURES = 1 + NUM_STATUSES  # progress delta + one-hot status
HIDDEN = 128


class ProgressAnomalyModel(nn.Module):
    """MLP over flattened windows: (B, window*FEATURES) -> (B,) next delta."""

    def __init__(self, hidden: int = HIDDEN, window: int = WINDOW, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_proj = nn.Linear(window * FEATURES, hidden, device=device)
        self.mid_proj = nn.Linear(hidden, hidden, device=device)
        self.out_proj = nn.Linear(hidden, 1, device=device)

    @property
    def device(self) -> torch.device:
        return self.in_proj.weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16).float()
        x = torch.relu(self.in_proj(x))
        x = torch.relu(self.mid_proj(x))
        return self.out_proj(x)[..., 0]

    def members_forward(self, params: list[dict], xs: list, mesh) -> list:
        """The forward on every member of a ``("dp", "tp")`` mesh that this
        process holds (``mesh.local``), in lockstep: ``params[i]`` holds
        local member ``i``'s slices by ``state_dict`` name, ``xs[i]`` its dp
        row of windows. ``in_proj`` is
        column-parallel, ``mid_proj`` row-parallel: each member's partial
        product is summed over tp (megatron's *g*), then the bias is added
        once; ``out_proj`` runs on every member."""
        if set(mesh.axis_names) - {"dp", "tp"}:
            raise ValueError(f"the anomaly MLP shards over dp and tp, got {mesh.axis_names}")
        xs = along(mesh, "tp", tp_replicate, [x.to(torch.bfloat16).float() for x in xs])
        hs = [torch.relu(F.linear(x, p["in_proj.weight"], p["in_proj.bias"]))
              for p, x in zip(params, xs)]
        parts = along(mesh, "tp", tp_all_reduce,
                      [F.linear(h, p["mid_proj.weight"]) for p, h in zip(params, hs)])
        hs = [torch.relu(s + p["mid_proj.bias"]) for p, s in zip(params, parts)]
        return [F.linear(h, p["out_proj.weight"], p["out_proj.bias"])[..., 0]
                for p, h in zip(params, hs)]

    def members_loss(self, params: list[dict], windows: torch.Tensor, targets: torch.Tensor,
                     mesh) -> list:
        """Each local member's mean squared error over its dp row of the
        whole ``windows``."""
        preds = self.members_forward(params, batch_slices(mesh, windows), mesh)
        return [torch.mean((p - t) ** 2) for p, t in zip(preds, batch_slices(mesh, targets))]


def make_windows(
    progress: torch.Tensor, statuses: torch.Tensor, window: int = WINDOW
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slice one job's (T,) progress and status streams into
    ``(T-window-1, window*FEATURES)`` flattened windows of (progress delta,
    one-hot status) and the ``(T-window-1,)`` delta right after each."""
    deltas = torch.diff(progress.float())
    feats = torch.cat([deltas[:, None], one_hot(statuses[1:], NUM_STATUSES)], dim=-1)
    n = deltas.shape[0] - window
    idx = torch.arange(n, device=deltas.device)[:, None] + torch.arange(
        window, device=deltas.device
    )
    return feats[idx].reshape(n, window * FEATURES), deltas[window:]


def init_train_state(
    seed: int, learning_rate: float = 1e-3, window: int = WINDOW, *, device=None
) -> TrainState:
    """A fresh model with params from a numpy seed
    (:func:`~beholder_tpu_torch.models.bridge.init_params`) and Adam at
    step 0."""
    from .bridge import init_params, load_flax_params

    model = ProgressAnomalyModel(window=window, device=device)
    load_flax_params(model, init_params(model, seed))
    return init_state(model, learning_rate)


def loss_fn(model: ProgressAnomalyModel, windows, targets) -> torch.Tensor:
    return torch.mean((model(windows) - targets) ** 2)


def train_step(state: TrainState, windows, targets) -> tuple[TrainState, torch.Tensor]:
    """One Adam step on the windows' mean squared error."""
    return apply_gradients(state, lambda m: loss_fn(m, windows, targets))


def anomaly_scores(model: ProgressAnomalyModel, windows, targets) -> torch.Tensor:
    """|predicted next delta - actual| per window; higher = more anomalous."""
    with torch.no_grad():
        return torch.abs(model(windows) - targets)
