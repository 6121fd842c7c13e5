"""Decode-demo launcher (port of ``repro.launch.serve``): batched
autoregressive generation through the KV caches and SSM states of the
LM backbones.  A throughput demo of
``backbones.decode_step``, not an online service: it generates a fixed
number of tokens from random prompts (seeded) with random weights
(seeded) and exits.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --batch 4 --prompt-len 16 --gen 32 [--device cpu]

As in the JAX launcher, the prompt is prefilled by scanning
``decode_step`` token by token, so no kernel runs here (the chunked
prefill through the kernels is ``launch.steps.make_prefill_step``).  It
runs on the card unless ``--device cpu`` is given.  ``--arch`` defaults
to ``qwen3-1.7b``, as in the JAX launcher; the ``dense`` (qwen3-1.7b,
yi-6b, granite-3-8b, qwen1.5-32b), ``hybrid`` (zamba2-1.2b), ``moe``
(qwen3-moe-30b-a3b, llama4-scout-17b-a16e), ``vlm``
(llama-3.2-vision-11b), ``audio`` (seamless-m4t-large-v2) and ``ssm``
(xlstm-125m) families decode here, and any other arch (a CLIP setting)
exits 2.  As
in the JAX launcher, the vlm's image embeds (B, n_image_tokens,
vision_dim) and the audio's frames (B, (prompt + gen) // subsample,
d_model) are seeded stubs (standard normal x 0.1, drawn from the
launcher's generator) that fill the cross caches once before the
prompt.

Not to be confused with ``repro_torch.launch.serve_embed``, the online
embedding service over the CLIP towers.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import device as D
from repro_torch.configs import get_arch
from repro_torch.models import backbones as BB


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cfg, state, prompt, max_len, gen):
    """Greedy generation.  prompt: (B, P) int.  Returns (tokens (B, P +
    gen), decode tokens/s after the prompt)."""
    B, P = prompt.shape
    with torch.inference_mode():
        logits = None
        for t in range(P):          # prefill by scanning decode_step
            logits, state = BB.decode_step(model, cfg, state,
                                           prompt[:, t:t + 1], t)
        toks = [prompt]
        cur = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
        _sync(prompt.device)
        t0 = time.time()
        for t in range(P, P + gen):
            toks.append(cur)
            logits, state = BB.decode_step(model, cfg, state, cur, t)
            cur = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
        _sync(prompt.device)
        dt = time.time() - t0
    return torch.cat(toks, dim=1), gen * B / max(dt, 1e-9)


def stub_inputs(cfg, batch, max_len, gen, device):
    """The modality inputs of the JAX launcher's batch, drawn from
    ``gen``: {} but for the vlm's ``image_embeds`` and the audio's
    ``frames``."""
    if cfg.family == "vlm":
        shape = (batch, cfg.n_image_tokens, cfg.vision_dim)
        key = "image_embeds"
    elif cfg.family == "audio":
        shape = (batch, max_len // cfg.audio_subsample, cfg.d_model)
        key = "frames"
    else:
        return {}
    return {key: torch.randn(shape, generator=gen, device=device) * 0.1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        cfg = get_arch(args.arch)
    except KeyError:
        cfg = None
    if cfg is None or cfg.family not in BB.LM_FAMILIES:
        what = f"family {cfg.family!r}" if cfg else "an unknown config"
        print(f"serve: {args.arch}: {what} has no decode path (the "
              f"{', '.join(BB.LM_FAMILIES)} families decode here; the CLIP "
              f"towers serve through repro_torch.launch.serve_embed)",
              file=sys.stderr)
        sys.exit(2)
    if args.reduced:
        cfg = cfg.reduced()
    device = D.resolve(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = BB.init_params(cfg, gen, device)
    max_len = args.prompt_len + args.gen
    state = BB.prepare_decode_state(
        model, cfg, stub_inputs(cfg, args.batch, max_len, gen, device),
        args.batch, max_len)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    toks, tps = generate(model, cfg, state, prompt, max_len, args.gen)
    print(f"arch={cfg.name} batch={args.batch} generated {args.gen} tokens "
          f"per sequence at {tps:.1f} tok/s (batched)")
    print("sample token ids:", toks[0, :24].cpu().numpy())
    return toks


if __name__ == "__main__":
    main()
