"""Evaluation launcher (port of ``repro.launch.eval``; the dataset
builder that the serving launcher shares, so far)."""
from __future__ import annotations

from repro_torch.data import ZeroShotEvalDataset


def build_eval_dataset(args, cfg=None) -> ZeroShotEvalDataset:
    kw = dict(n_classes=args.classes, n_per_class=args.per_class,
              label_flip_frac=args.flip_frac, seed=args.seed)
    if cfg is not None:
        c = cfg.clip
        kw.update(image_size=c.image_size, context_length=c.context_length,
                  vocab_size=cfg.vocab_size)
    return ZeroShotEvalDataset(**kw)
