"""Where the port's entry points put data they are handed as numpy.

The port runs on the card unless the caller asks for the CPU: an entry
point given numpy data and no ``device`` places it on ``cuda``. Tensors
passed in stay where they lie. Nothing here falls back to the CPU when
no card is present; such a call raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device(device)`` when one is given, else ``cuda``. Raises
    RuntimeError when no device was asked for and no card is visible."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible and no device was given: the port runs "
            "on the card by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
