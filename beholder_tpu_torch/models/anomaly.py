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
from torch import nn

from beholder_tpu_torch.device import resolve_device
from beholder_tpu_torch.ops import NUM_STATUSES

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
