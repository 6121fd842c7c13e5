"""Zero-shot evaluation launcher (port of ``repro.launch.eval``).

Restores a checkpoint (the JAX package's format, from either package)
and runs the eval engine (prompt-ensemble zero-shot classification and
exact streaming retrieval) over the class-structured synthetic eval
split, with the training launcher's flags (``--impl``, ``--precision``,
``--loss-impl``).  It runs on the card unless ``--device cpu`` is given.

    # real model: restore the params subtree of a train checkpoint
    PYTHONPATH=src python -m repro_torch.launch.eval \\
        --arch clip-vitb32-cc12m --ckpt-dir ckpts \\
        [--reduced] [--precision bf16] [--loss-impl fused|dense]

    # known-answer mode: planted closed-form towers whose metrics are
    # analytically determined (writes the reference checkpoint on first
    # run, restores it always)
    PYTHONPATH=src python -m repro_torch.launch.eval --planted \\
        --ckpt-dir /tmp/planted --classes 6 --per-class 4 \\
        --expect-known-answers

``--impl flash`` (the default) runs the towers' attention through the
hand-written kernel K3; ``chunked`` and ``naive`` are the plain PyTorch
references (the JAX launcher defaults to ``chunked``).  ``--loss-impl
fused`` reports ``eval_loss`` through K1, ``dense`` through the plain
loss math.  Prints one ``EVAL {json}`` line; ``--expect-known-answers``
exits 1 unless every metric equals the closed form *exactly*.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import checkpoint as CK
from repro_torch import device as D
from repro_torch.configs import get_arch
from repro_torch.data import ZeroShotEvalDataset
from repro_torch.eval import engine as EN
from repro_torch.eval import planted as PL
from repro_torch.models import backbones as BB
from repro_torch.models.precision import POLICIES


def build_eval_dataset(args, cfg=None) -> ZeroShotEvalDataset:
    kw = dict(n_classes=args.classes, n_per_class=args.per_class,
              label_flip_frac=args.flip_frac, seed=args.seed)
    if cfg is not None:
        c = cfg.clip
        kw.update(image_size=c.image_size, context_length=c.context_length,
                  vocab_size=cfg.vocab_size)
    return ZeroShotEvalDataset(**kw)


def main(argv=None):
    """CLI entry point; returns the metrics dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest restorable)")
    ap.add_argument("--planted", action="store_true",
                    help="known-answer mode: planted closed-form towers "
                         "(creates the reference checkpoint on first run)")
    ap.add_argument("--expect-known-answers", action="store_true",
                    help="planted mode: exit nonzero unless every metric "
                         "equals the analytic closed form exactly")
    ap.add_argument("--arch", default="clip-vitb32-cc12m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--per-class", type=int, default=8)
    ap.add_argument("--flip-frac", type=float, default=0.0)
    ap.add_argument("--impl", default="flash",
                    choices=["chunked", "flash", "naive"])
    ap.add_argument("--precision", default=None, choices=sorted(POLICIES))
    ap.add_argument("--loss-impl", default=None,
                    choices=["dense", "fused"],
                    help="also report eval_loss (the GCL batch value) "
                         "computed with this loss-layer math")
    ap.add_argument("--tau", type=float, default=0.07)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=512,
                    help="column-chunk size of the streaming top-k scan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=D.DEFAULT,
                    help="torch device (default: the card)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    device = D.resolve(args.device)

    if args.planted:
        ds = build_eval_dataset(args)
        if CK.latest_step(args.ckpt_dir) is None:
            path = PL.make_planted_checkpoint(args.ckpt_dir, ds)
            print(f"wrote reference planted checkpoint: {path}")
        tree, step, meta = CK.restore(args.ckpt_dir,
                                      PL.planted_params(ds, "cpu"),
                                      step=args.step)
        print(f"restored planted checkpoint at step {step} ({meta})")
        metrics = EN.evaluate_planted(
            PL.params_from_tree(tree, device), ds, chunk=args.chunk,
            batch_size=args.batch_size, loss_impl=args.loss_impl,
            device=device)
    else:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        tree, step, meta = CK.restore_subtree(
            args.ckpt_dir, BB.param_shapes(cfg), "params", step=args.step)
        params = BB.params_from_tree(cfg, tree, device=device)
        print(f"restored params at step {step} ({meta}) onto {device}")
        ds = build_eval_dataset(args, cfg)
        evaluator = EN.ClipEvaluator(
            cfg, ds, impl=args.impl, precision=args.precision,
            batch_size=args.batch_size, chunk=args.chunk,
            loss_impl=args.loss_impl, tau=args.tau, device=device)
        metrics = evaluator.evaluate(params, cache_key=step)

    out = {"step": step, **{k: round(v, 6) for k, v in metrics.items()}}
    print("EVAL " + json.dumps(out, sort_keys=True))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)

    if args.expect_known_answers:
        if not args.planted:
            raise SystemExit("--expect-known-answers requires --planted")
        expected = PL.known_answers(ds)
        bad = {k: (metrics[k], v) for k, v in expected.items()
               if metrics[k] != v}
        if bad:
            print("KNOWN-ANSWER MISMATCH " + json.dumps(
                {k: {"got": g, "want": w} for k, (g, w) in bad.items()}))
            raise SystemExit(1)
        print(f"KNOWN-ANSWER MATCH ({len(expected)} metrics exact)")
    return metrics


if __name__ == "__main__":
    main()
