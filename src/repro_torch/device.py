"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another device (the tests pass ``"cpu"``). Raises when no
    device is given and no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
