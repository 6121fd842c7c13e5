"""Zero-shot classification via prompt-ensemble text classifier heads
(port of ``repro.eval.classifier``).

The head for a class set is built the OpenCLIP way: every (template,
class) prompt is encoded (all T x C prompts in one call of the text
tower), each prompt embedding is L2-normalised, the T template
embeddings of a class are averaged, and the average is renormalised,
giving a (C, E) unit-row matrix.  Classification of normalised image
embeddings is then one (N, E) @ (E, C) product followed by the shared
deterministic top-k (``repro_torch.eval.metrics``).

Heads are cached per (cache_key, class set, template bank, context
length): pass a ``cache`` dict plus a ``cache_key`` identifying the
parameters (e.g. the train step of the checkpoint); the rendered prompt
*tokens* are memoised across params (``repro_torch.eval.templates``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import losses as LS
from repro_torch.eval import metrics as M
from repro_torch.eval.templates import (DEFAULT_TEMPLATES, PromptTemplate,
                                        render_prompt_bank,
                                        template_bank_signature)


def build_head(encode_text_fn: Callable, token_bank: np.ndarray, *,
               context_length: int,
               templates: Sequence[PromptTemplate] = DEFAULT_TEMPLATES,
               cache: Optional[dict] = None, cache_key=None,
               device=None) -> torch.Tensor:
    """Prompt-ensemble classifier head.

    encode_text_fn: (P, context_length) int32 tensor on ``device``
    (default: the card) -> (P, E) unnormalised text embeddings (any text
    tower: CLIP, planted, ...).  token_bank: (C, token_len) class-token
    bank.  Returns the (C, E) unit-row head."""
    token_bank = np.asarray(token_bank, np.int32)
    if cache is not None:
        key = (cache_key, token_bank.tobytes(), token_bank.shape,
               template_bank_signature(templates), context_length)
        hit = cache.get(key)
        if hit is not None:
            return hit
    prompts = render_prompt_bank(token_bank, templates, context_length)
    T, C, L = prompts.shape
    toks = torch.from_numpy(prompts.reshape(T * C, L)).to(D.resolve(device))
    with torch.inference_mode():
        emb = LS.l2_normalize(encode_text_fn(toks)).reshape(T, C, -1)
        head = LS.l2_normalize(torch.mean(emb, dim=0))
    if cache is not None:
        cache[key] = head
    return head


def classify(image_emb: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(N, E) normalised image embeddings x (C, E) head -> (N, C)
    logits in f32."""
    return image_emb.float() @ head.float().T


def zero_shot_metrics(image_emb: torch.Tensor, head: torch.Tensor,
                      labels, ks: Sequence[int] = (1, 5)) -> dict:
    """Zero-shot top-k accuracy: {f"zs_top{k}": scalar}."""
    acc = M.topk_accuracy(classify(image_emb, head), torch.as_tensor(labels),
                          ks)
    return {f"zs_{k}": v for k, v in acc.items()}
