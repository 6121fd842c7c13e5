"""Synthetic datasets (port of ``repro.data.synthetic``: the contrastive
training pairs, the eval split, and the LM token stream and paired
embeddings of the LM backbones).  Numpy only: batches equal the JAX
package's bit for bit.

Index-addressable: sample i's bytes are a pure function of (dataset
config, i), since all randomness goes through the per-sample
counter-based generators of ``repro_torch.data.rng``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import rng as R


@dataclasses.dataclass
class ContrastiveDataset:
    """n synthetic image-text pairs over ``n_classes`` latent concepts:
    image i renders its class prototype (plus per-sample noise) and its
    caption spells the class in tokens, so the modalities can align."""
    n: int
    image_size: int
    context_length: int
    vocab_size: int
    n_classes: int = 64
    noise: float = 0.3
    seed: int = 0

    IMAGE_STREAM = "contrastive/images"

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.classes = rng.randint(0, self.n_classes, size=self.n)
        self.protos = rng.randn(self.n_classes, 8, 8, 3).astype(np.float32)
        # caption template: class id spelled in tokens (0 reserved)
        self.tok_base = rng.randint(1, self.vocab_size,
                                    size=(self.n_classes, 4))
        self._img_key = R.stream_key(self.seed, self.IMAGE_STREAM)

    def clean_images(self, idx):
        base = self.protos[self.classes[idx]]             # (b, 8, 8, 3)
        return np.repeat(np.repeat(base, self.image_size // 8, axis=1),
                         self.image_size // 8, axis=2)

    def images(self, idx):
        return R.add_gaussian_noise(self.clean_images(idx), self.noise,
                                    self._img_key, idx)

    def texts(self, idx):
        b = len(idx)
        toks = np.zeros((b, self.context_length), np.int32)
        cls_toks = self.tok_base[self.classes[idx]]       # (b, 4)
        for r in range(min(self.context_length // 4, 4)):
            toks[:, r * 4:(r + 1) * 4] = cls_toks
        return toks

    def batch(self, idx):
        idx = np.asarray(idx)
        return {"images": self.images(idx), "texts": self.texts(idx)}


@dataclasses.dataclass
class ZeroShotEvalDataset:
    """Planted-structure eval split.

      * ``n_classes`` orthonormal class prototypes: one-hot vectors in the
        8x8x3 = 192-dim image latent, rendered to images by constant-block
        upsampling with zero noise;
      * items grouped by class, ``n_per_class`` each (item i has class
        ``i // n_per_class``); captions carry the class token n-gram at
        position 0;
      * ``labels`` equal the planted classes except for an optional
        deterministic fraction of label-only flips (``label_flip_frac``).
    """
    n_classes: int = 8
    n_per_class: int = 8
    image_size: int = 32
    context_length: int = 16
    vocab_size: int = 512
    token_len: int = 4
    label_flip_frac: float = 0.0
    seed: int = 0

    LATENT = 8 * 8 * 3

    def __post_init__(self):
        if self.n_classes > self.LATENT:
            raise ValueError("one-hot latent exhausted")
        if self.image_size % 8 or self.token_len > self.context_length:
            raise ValueError("image_size must be a multiple of 8 and "
                             "token_len <= context_length")
        self.n = self.n_classes * self.n_per_class
        self.classes = np.repeat(np.arange(self.n_classes),
                                 self.n_per_class)
        eye = np.eye(self.LATENT, dtype=np.float32)[:self.n_classes]
        self.protos = eye.reshape(self.n_classes, 8, 8, 3)
        rng = np.random.RandomState(self.seed)
        # unique class n-grams (class identity is the contiguous n-gram)
        seen = set()
        rows = []
        while len(rows) < self.n_classes:
            cand = tuple(rng.randint(1, self.vocab_size,
                                     size=self.token_len))
            if cand not in seen:
                seen.add(cand)
                rows.append(cand)
        self.tok_base = np.asarray(rows, np.int32)
        self.labels = self.classes.copy()
        n_flip = int(round(self.label_flip_frac * self.n))
        if n_flip:
            flip_idx = rng.choice(self.n, n_flip, replace=False)
            shift = 1 + rng.randint(0, self.n_classes - 1, n_flip)
            self.labels[flip_idx] = (self.labels[flip_idx] + shift) \
                % self.n_classes

    def images(self, idx):
        base = self.protos[self.classes[idx]]             # (b, 8, 8, 3)
        r = self.image_size // 8
        return np.repeat(np.repeat(base, r, axis=1), r, axis=2)

    def texts(self, idx):
        b = len(idx)
        toks = np.zeros((b, self.context_length), np.int32)
        toks[:, :self.token_len] = self.tok_base[self.classes[idx]]
        return toks

    def batch(self, idx):
        idx = np.asarray(idx)
        return {"images": self.images(idx), "texts": self.texts(idx)}


@dataclasses.dataclass
class LMDataset:
    """Synthetic token stream with learnable bigram structure: each token
    has 4 likely successors, and sample i's chain is drawn from its own
    per-sample generator.  ``labels`` are ``tokens`` shifted by one."""
    n: int
    seq_len: int
    vocab_size: int
    seed: int = 0

    TOKEN_STREAM = "lm/tokens"

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.next_tok = rng.randint(0, self.vocab_size,
                                    size=(self.vocab_size, 4))
        self._tok_key = R.stream_key(self.seed, self.TOKEN_STREAM)

    def batch(self, idx):
        idx = np.asarray(idx).reshape(-1)
        b = len(idx)
        first = np.empty((b,), np.int64)
        choice = np.empty((b, self.seq_len), np.int64)
        for j, i in enumerate(idx):
            g = R.sample_generator(self._tok_key, i)
            first[j] = g.integers(0, self.vocab_size)
            choice[j] = g.integers(0, 4, size=self.seq_len)
        toks = np.zeros((b, self.seq_len + 1), np.int64)
        toks[:, 0] = first
        for t in range(self.seq_len):
            toks[:, t + 1] = self.next_tok[toks[:, t], choice[:, t]]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class PairedEmbeddingDataset:
    """Pairs for the contrastive objective on an LM backbone: tokens that
    spell a latent class (the text side) and a noisy class prototype of
    ``pair_dim`` (the stub paired modality), so the two can align."""
    n: int
    seq_len: int
    vocab_size: int
    pair_dim: int = 512
    n_classes: int = 64
    seed: int = 0

    EMBED_STREAM = "paired/embeds"
    noise: float = 0.3

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.classes = rng.randint(0, self.n_classes, size=self.n)
        self.protos = rng.randn(self.n_classes, self.pair_dim).astype(
            np.float32)
        self.tok_base = rng.randint(1, self.vocab_size,
                                    size=(self.n_classes, 8))
        self._emb_key = R.stream_key(self.seed, self.EMBED_STREAM)

    def batch(self, idx):
        idx = np.asarray(idx).reshape(-1)
        b = len(idx)
        cls = self.classes[idx]
        emb = R.add_gaussian_noise(self.protos[cls], self.noise,
                                   self._emb_key, idx)
        toks = np.zeros((b, self.seq_len), np.int32)
        ct = self.tok_base[cls]
        for r in range(min(max(1, self.seq_len // 8), 8)):
            toks[:, r * 8:(r + 1) * 8] = ct
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
                "pair_embeds": emb}
