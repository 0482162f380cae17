"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    defaulted to) and there is none: the port never carries on on the CPU
    by itself — pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device=cpu) "
            "to run on the CPU")
    return dev


def same_device(where: torch.device, device: torch.device) -> bool:
    """True when ``where`` is ``device``; a ``device`` with no index (as
    :func:`resolve_device` returns for the card) matches every index of
    its type, so a tensor on ``cuda:0`` lies on ``cuda``."""
    return where.type == device.type and (device.index is None
                                          or where.index == device.index)


def check_on_device(params, device: torch.device) -> None:
    """Raise unless every tensor of a parameter store lies on ``device``."""
    for name, value in params.items():
        if not same_device(value.device, device):
            raise ValueError(f"parameter {name!r} lies on {value.device}, "
                             f"not on {device}")
