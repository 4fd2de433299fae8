"""Device choice for the port's entry points: CUDA unless the caller asks
for another device by name (the CPU tests pass ``device="cpu"``)."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises when no GPU is present rather than falling back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
