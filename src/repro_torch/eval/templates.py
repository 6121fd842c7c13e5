"""Prompt-template bank for the zero-shot text classifier heads (the
port's own copy of ``repro.eval.templates``, which imports no JAX; the
rendered banks are bitwise equal to it).

Template format.  The text towers consume token-id sequences, not
strings, so a template is a *token layout*: fixed ``prefix`` and
``suffix`` filler-token tuples around the class's token n-gram (the
synthetic datasets identify a class by a fixed ``token_len``-gram,
``tok_base[c]``; real tokenized captions would slot their class-name
tokens in the same position).  ``render`` emits

    [*prefix, *class_tokens, *suffix, 0, 0, ...]   (length context_length)

truncating on the right if the layout overflows.  The planted text
encoder (repro_torch.eval.planted) recognizes the class n-gram at *any*
position, which is exactly what makes prompt ensembling analytically
transparent on the planted split: every template of class c maps to the
same class embedding, so the ensemble average is that embedding.

Rendered prompt banks are cached per (class-token bank, template bank,
context length) — the token side of the "cached head per class set"
contract; the embedding side (which additionally depends on the params)
is cached by ``repro_torch.eval.classifier.build_head``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PromptTemplate:
    """One token-layout template; filler ids are ordinary vocab tokens
    (collisions with class tokens are harmless — class identity is the
    contiguous n-gram, not token membership)."""
    name: str
    prefix: Tuple[int, ...] = ()
    suffix: Tuple[int, ...] = ()

    def render(self, class_tokens: np.ndarray,
               context_length: int) -> np.ndarray:
        toks = list(self.prefix) + [int(t) for t in class_tokens] \
            + list(self.suffix)
        out = np.zeros((context_length,), np.int32)
        n = min(len(toks), context_length)
        out[:n] = toks[:n]
        return out


# A small default bank exercising every layout: bare class tokens (the
# training-caption layout), prefixed, suffixed, and bracketed.
DEFAULT_TEMPLATES: Tuple[PromptTemplate, ...] = (
    PromptTemplate("plain"),
    PromptTemplate("prefixed", prefix=(3, 7)),
    PromptTemplate("suffixed", suffix=(5, 2)),
    PromptTemplate("bracketed", prefix=(9,), suffix=(4, 6, 8)),
)

_PROMPT_CACHE: Dict[tuple, np.ndarray] = {}


def template_bank_signature(templates: Sequence[PromptTemplate]) -> tuple:
    return tuple((t.name, t.prefix, t.suffix) for t in templates)


def render_prompt_bank(token_bank: np.ndarray,
                       templates: Sequence[PromptTemplate],
                       context_length: int) -> np.ndarray:
    """(C, token_len) class-token bank -> (T, C, context_length) int32
    prompt tokens, memoized per class set."""
    token_bank = np.asarray(token_bank, np.int32)
    key = (token_bank.tobytes(), token_bank.shape,
           template_bank_signature(templates), context_length)
    hit = _PROMPT_CACHE.get(key)
    if hit is not None:
        return hit
    out = np.stack([
        np.stack([t.render(row, context_length) for row in token_bank])
        for t in templates])
    _PROMPT_CACHE[key] = out
    return out
