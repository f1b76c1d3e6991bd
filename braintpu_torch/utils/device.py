"""The port's device rule: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: braintpu_torch runs on the card unless device='cpu' is passed")
    return dev
