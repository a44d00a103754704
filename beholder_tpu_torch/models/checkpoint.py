"""Checkpoint and resume of a training state: the port of the reference's
``models/checkpoint.py`` (orbax there, ``torch.save`` here).

A checkpoint is one file holding the model's ``state_dict``, the
optimizer's ``state_dict`` (Adam moments and step counts) and the step.
Every tensor comes back bit for bit, so a resumed run is bit-identical to
an uninterrupted one.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from .train import TrainState


def save_state(path: str | Path, state: TrainState) -> None:
    """Write ``state`` (params, optimizer moments, step) to ``path``,
    overwriting a checkpoint already there (the periodic save to a fixed
    "latest" path). The file is written beside ``path`` first and then
    renamed over it, so a reader never sees half a checkpoint."""
    path = Path(path).resolve()
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(
        {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
        },
        tmp,
    )
    os.replace(tmp, path)


def restore_state(path: str | Path, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template``'s model and optimizer (in place,
    on the template's device) and return the restored state. The file is
    read onto the CPU: ``load_state_dict`` then copies params and moments
    to their device and keeps Adam's step counts on the CPU, where a
    non-capturable Adam wants them."""
    blob = torch.load(Path(path).resolve(), map_location="cpu", weights_only=True)
    template.model.load_state_dict(blob["model"])
    template.optimizer.load_state_dict(blob["optimizer"])
    return template._replace(step=int(blob["step"]))
