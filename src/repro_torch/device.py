"""Device selection for the port's entry points.

The entry points run on the card unless the caller asks for the CPU: a
missing CUDA device is an error, never a silent fall back to the CPU
(the plain PyTorch versions of the kernels run only for tensors the
caller put on the CPU)."""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (or
    implied) and ``torch.cuda.is_available()`` is False."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch path on the CPU")
    return dev
