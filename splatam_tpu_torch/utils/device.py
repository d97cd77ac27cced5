"""The port's device rule: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def require_device(device, who: str) -> torch.device:
    """torch.device(device); raises when that is a GPU and there is none
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' (--device cpu) to run "
                           "the kernels' plain versions on the CPU")
    return device
