"""Device selection for the port's entry points.

The entry points run on the card unless the caller asks for the CPU: a
missing CUDA device is an error, never a silent fall back to the CPU
(the plain PyTorch versions of the kernels run only for tensors the
caller put on the CPU).

Resolving the card also fixes the port's numerics policy
(``set_numerics_policy``): f32 products in full f32, TF32 off for
matmuls and for cuDNN's convolutions (whose PyTorch default is TF32
on), and cuDNN restricted to deterministic algorithms without
autotuning, so that a step is a function of its inputs bit for bit (the
reference's bitwise resume and guard no-op assume it).  It is a fixed
policy, not an option: every entry point resolves its device here.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT = "cuda"


def set_numerics_policy() -> None:
    """No TF32 in matmuls or cuDNN convolutions; deterministic cuDNN
    algorithms, chosen without benchmarking."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (or
    implied) and ``torch.cuda.is_available()`` is False; sets the
    numerics policy when it resolves to the card."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run the plain "
                "PyTorch path on the CPU")
        set_numerics_policy()
    return dev
