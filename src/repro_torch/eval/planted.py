"""Planted closed-form towers: the known-answer anchor of the eval engine
(port of ``repro.eval.planted``).

A tiny parameterised two-tower "model" whose behaviour on the
``ZeroShotEvalDataset`` is *exact* in f32 on any device, so every eval
metric is analytically determined (``known_answers``):

  * image tower: block-mean downsample to the 8x8x3 latent (exact on the
    constant-block planted images), flatten, and one linear ``img_proj``
    (the identity in the reference checkpoint): image i maps to its
    class's one-hot prototype bit for bit;
  * text tower: match every contiguous ``token_len``-gram of the caption
    against the ``tok_base`` class bank and emit the matched class's row
    of ``text_table`` (the prototype).  Position-independent matching
    makes prompt templates transparent: every template of class c
    encodes to the same prototype, so the prompt-ensemble head *is* the
    prototype matrix.

Block means of constant blocks and products of one-hot (or permutation)
matrices are exact in f32 whatever the summation order, TF32 on or off.

The params dict {img_proj, text_table, tok_base (int32)} round-trips
through ``repro_torch.checkpoint`` (``make_planted_checkpoint``) in the
JAX package's format: a planted checkpoint written by either package
restores in the other.

Closed forms (derivation).  With orthonormal prototypes and zero noise,
the similarity matrix is the class-equality indicator.  Under the shared
(score desc, index asc) tie rule and grouped classes:

  * zero-shot: the predicted class is always the planted class (score 1
    vs 0), so top-1 = 1 - label_flip_frac exactly; a flipped label l is
    still in the top-k iff l is among the first k-1 class indices after
    removing the planted class;
  * retrieval, both directions: for item i of class c, the candidates
    rank as [same-class indices ascending, then the rest]; the paired
    index i sits at position rank_i = #{j < i : class_j = c} + 1, so
    R@k = min(k, n_per_class) / n_per_class exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import checkpoint as CK
from repro_torch import device as D

LATENT = 8 * 8 * 3


def planted_params(dataset, device=None) -> dict:
    """Reference checkpoint params for a ``ZeroShotEvalDataset``, as
    tensors on ``device`` (default: the card)."""
    return params_from_tree({
        "img_proj": np.eye(LATENT, dtype=np.float32),
        "text_table": dataset.protos.reshape(dataset.n_classes, LATENT),
        "tok_base": np.asarray(dataset.tok_base, np.int32),
    }, device)


def params_from_tree(tree: dict, device=None) -> dict:
    """A restored planted tree (numpy arrays) as tensors on ``device``
    (default: the card), dtypes kept (``tok_base`` int32)."""
    dev = D.resolve(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev)
            for k, v in tree.items()}


def encode_image(params, images):
    """(b, S, S, 3) -> (b, LATENT): block-mean to 8x8x3 (exact on
    constant blocks), flatten, linear projection."""
    b, S = images.shape[0], images.shape[1]
    r = S // 8
    x = images.float().reshape(b, 8, r, 8, r, 3)
    lat = x.mean(dim=(2, 4)).reshape(b, LATENT)
    return lat @ params["img_proj"].float()


def encode_text(params, tokens):
    """(b, ctx) int -> (b, LATENT): position-independent class n-gram
    match against ``tok_base``, summing matched ``text_table`` rows (the
    planted split guarantees exactly one match per caption/prompt)."""
    bank = params["tok_base"]
    windows = tokens.unfold(1, bank.shape[1], 1)          # (b, W, L)
    eq = windows[:, :, None, :] == bank[None, None]       # (b, W, C, L)
    hit = eq.all(dim=-1).any(dim=1)                       # (b, C)
    return hit.float() @ params["text_table"].float()


def encode_pair(params, batch):
    return (encode_image(params, batch["images"]),
            encode_text(params, batch["texts"]))


def make_planted_checkpoint(directory: str, dataset, step: int = 0) -> str:
    """Save the reference planted params through
    ``repro_torch.checkpoint``."""
    return CK.save(directory, planted_params(dataset, "cpu"), step,
                   metadata={"planted": True,
                             "n_classes": dataset.n_classes,
                             "n_per_class": dataset.n_per_class})


def known_answers(dataset, ks=(1, 5, 10), top_ks=(1, 5)) -> dict:
    """The analytically exact eval metrics for the planted split (numpy
    closed form, independent of the engine): the values
    ``repro_torch.launch.eval --expect-known-answers`` must reproduce
    *exactly*.  Every metric is an exact integer count divided in f32
    (the engine's own arithmetic), so the comparison is ``==``."""
    n, C = dataset.n, dataset.n_classes
    classes = dataset.classes
    labels = dataset.labels

    def frac(count):
        # the engine computes sum(exact 0/1 hits) / n in f32
        return float(np.float32(count) / np.float32(n))

    out = {}
    for k in top_ks:
        kk = min(k, C)
        correct = np.zeros(n, bool)
        for i in range(n):
            c = int(classes[i])
            ordered = [c] + [x for x in range(C) if x != c]
            correct[i] = int(labels[i]) in ordered[:kk]
        out[f"zs_top{k}"] = frac(np.sum(correct))
    ranks = np.array([np.sum((classes == classes[i])
                             & (np.arange(n) < i)) + 1 for i in range(n)])
    for k in ks:
        r = frac(np.sum(ranks <= min(k, n)))
        out[f"i2t_r@{k}"] = r
        out[f"t2i_r@{k}"] = r
    return out
