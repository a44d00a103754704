"""Shared training state of the port's models: the counterpart of the
reference's ``models/train.py``.

The reference's ``TrainState(params, opt_state, step)`` is a pure pytree,
and ``apply_gradients`` returns a new one. Here the state is
``TrainState(model, optimizer, step)``: the parameters live in the
``nn.Module`` and the Adam moments in the optimizer, and a step updates both
in place (no second copy of the parameters or moments exists); only the step
count comes back new.

The optimizer is ``torch.optim.Adam`` with optax's ``adam`` defaults (lr
1e-3, b1 0.9, b2 0.999, eps 1e-8, eps_root 0, no weight decay). Its update
``lr/bc1 * m / (sqrt(v)/sqrt(bc2) + eps)`` is optax's ``m_hat / (sqrt(v_hat)
+ eps)`` written in another order (bc = 1 - b**step); the two agree to f32
rounding, which ``tests/test_torch_train.py`` checks against optax itself.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn


class TrainState(NamedTuple):
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def adam(params, learning_rate: float = 1e-3) -> torch.optim.Adam:
    """``optax.adam(learning_rate)`` with its defaults."""
    return torch.optim.Adam(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0
    )


def init_state(model: nn.Module, learning_rate: float = 1e-3) -> TrainState:
    """Turn gradients on for ``model`` and pair it with a fresh Adam at
    step 0."""
    model.requires_grad_(True)
    return TrainState(model, adam(model.parameters(), learning_rate), 0)


def apply_gradients(
    state: TrainState, loss_fn: Callable[[nn.Module], torch.Tensor]
) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step of ``loss_fn(model)``: parameters and moments are
    updated in place. Returns the state with the step advanced, and the
    loss (a 0-d tensor on the model's device, never read back here)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model)
    loss.backward()
    state.optimizer.step()
    return state._replace(step=state.step + 1), loss.detach()
