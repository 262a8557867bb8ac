"""Where the port runs: one CUDA card unless the caller names the CPU.

Every entry point takes a ``device`` argument and passes it through
``resolve``. With none given it is ``cuda:0``; a machine without a card
is an error, never a quiet move to the CPU (the CPU runs the kernels'
plain versions, which is what tests ask for by name).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; a name or ``torch.device`` as given.

    Raises ``RuntimeError`` when a CUDA device is asked for (or implied)
    and none is present."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev
