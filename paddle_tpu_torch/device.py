"""Device placement for the port's entry points (counterpart of
``paddle_tpu/device``): the card by default, the CPU only when asked."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, otherwise a
    clear error (the port never drops to the CPU on its own).  Anything
    else is taken as given (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch paths on the CPU")
        return torch.device("cuda")
    return torch.device(device)
