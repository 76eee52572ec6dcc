"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device=None`` means the CUDA card, and raises when there is none:
    the port never carries on on the CPU unless the caller asks for it
    with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
