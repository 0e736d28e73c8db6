"""Device resolution for the port's entry points.

``build``, ``index_from_state`` and ``FCVIEngine`` default to ``"cuda"``;
asking for a card that is not there raises instead of running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device(device)``, after checking that a CUDA device exists
    when one is asked for (raises RuntimeError when it does not). A bare
    ``"cuda"`` resolves to the current card's index, as the device of the
    tensors made there reads."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
