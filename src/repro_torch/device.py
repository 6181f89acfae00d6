"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and a card that is asked for and missing is an error,
never a silent move to the CPU."""
from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it is
    CUDA and no card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but CUDA is not available; "
            "pass --device cpu to run on the CPU")
    return dev
