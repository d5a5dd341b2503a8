"""The device an entry point of the port runs on."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str]) -> torch.device:
    """The run's device: CUDA unless the caller names another.  Raises
    when CUDA is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
