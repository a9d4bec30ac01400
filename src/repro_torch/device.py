"""Device policy of the port.

Entry points run on the GPU unless the caller asks for the CPU by name
(``device="cpu"``, as the tests do).  Without a card they raise: a run that
meant to measure or serve on the GPU never falls back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); else the named device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
