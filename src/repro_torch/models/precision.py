"""Mixed-precision policy for the tower hot loop (port of
``repro.models.precision``).

A ``Precision`` fixes the dtypes of a tower forward: parameters are
stored f32 (the masters) and cast to the activation dtype at each use
site; the tower input is cast to ``compute_dtype`` once at the entry and
the embeddings back to ``output_dtype`` (always f32) at the exit, so the
L2 normalisation and everything after it run in f32 under any policy.
Norms, RoPE and the attention softmax compute in f32 inside.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


F32 = Precision("f32")
BF16 = Precision("bf16", compute_dtype=torch.bfloat16)

POLICIES = {"f32": F32, "bf16": BF16}


def get_precision(p: Optional[Union[str, Precision]]) -> Precision:
    """None -> f32; str -> registry lookup; Precision -> itself."""
    if p is None:
        return F32
    if isinstance(p, Precision):
        return p
    if p not in POLICIES:
        raise KeyError(f"unknown precision {p!r}; known: {sorted(POLICIES)}")
    return POLICIES[p]


def cast_compute(policy: Precision, x: torch.Tensor) -> torch.Tensor:
    """Cast a floating activation to the compute dtype (tower entry)."""
    if x.is_floating_point():
        return x.to(policy.compute_dtype)
    return x


def cast_output(policy: Precision, x: torch.Tensor) -> torch.Tensor:
    """Cast a tower output to the output dtype (tower exit)."""
    return x.to(policy.output_dtype)
