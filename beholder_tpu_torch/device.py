"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: the
    port never drops to the CPU on its own. The CPU runs only when the
    caller names it (``device="cpu"``), as the tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a host synchronisation:
    on the card the copy goes through pinned memory and is asynchronous
    (a pageable copy would block the host until the stream drains)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)
