#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing JSON lines (``{"phase": ...}``):

1. device  -- requires CUDA, prints the card's name and power limit
   (``nvidia-smi``), sets the port's numerics policy (TF32 off for
   matmuls and convolutions, deterministic cuDNN), as every entry
   point of the port does when it resolves the card;
2. build   -- builds the port's kernels from ``src/repro_torch/kernels/
   csrc/*.cu`` with nvcc for sm_90a, one nvcc per source, in parallel;
   prints ptxas's registers / spills and counts the tensor-core
   instructions (HMMA, HGMMA) in each library's SASS (``cuobjdump
   -sass``): none, or a spill, fails; for the flash-attention kernel,
   each instantiation's (f32 and bf16 at head dims 32, 64 and 128):
   HGMMA for bf16, HMMA for f32, or it fails;
3. kernel  -- holds the flash-attention kernel against its plain PyTorch
   version on the card through both entry points at the serving,
   training, eval-head (f32), hybrid and ``clip-vitb16-laion`` image
   tower (256 x 12 x 197 x 197) shapes (f32 and bf16), the dense
   prefills' at head dim 128 (qwen3-1.7b 2 x 16 x 4096 x 4096, f32 and
   bf16; qwen1.5-32b 1 x 40 x 4096 x 4096, f32), the cross-attention
   families' (llama-3.2-vision-11b's cross blocks 2 x 32 x 4096 x 1024
   x 128 and seamless-m4t-large-v2's decoder over its encoder 2 x 16 x
   4096 x 1024 x 64, non-causal, f32 and bf16; its causal encoder 2 x 16
   x 1024 x 1024 and decoder self-attention 2 x 16 x 4096 x 4096, f32),
   at the curricula's
   training shapes (S = 2 and a causal S = 32, f32), at the cross
   families' contrastive training shapes (the vlm's cross blocks 64 x 32
   x 256 x 1024 x 128, the audio encoder 64 x 16 x 64 x 64 x 64 causal,
   f32), at qwen3-1.7b's
   contrastive training shape (64 x 16 x 256 x 256, f32) and a rank's on
   ``data:1,fsdp:2`` (32 x 16 x 256 x 256, f32), and at edge cases
   (hd 128 too: a ragged S = 77, a window of 100, Sq != Sk), and times
   kernel, plain version and one library call
   (``scaled_dot_product_attention``, timed here only, never used by the
   port) with CUDA events at those shapes;
4. attn_grad -- gradients of q, k, v through the kernel's autograd
   Function against autograd of the naive attention, at the training
   shapes of both towers and at the vlm's cross shape (1 x 32 x 4096 x
   1024 x 128, non-causal: the batch cut to 1);
5. gcl     -- holds K1 (``gcl_pair_stats``) and K2 (``gcl_pair_grads``)
   against their plain versions at the training shape (256 x 512, f32
   and bf16), at the paper's sharded shape (256 local anchors against
   2048 gathered columns, row offset 768) and at edge cases (d = 37,
   a column split with no unmasked column, d = 3072, per-row taus down
   to 0.01, a clamped row); two calls bitwise equal; times both (with
   and without the wrapper's torch ops, and per pass) at the training
   and sharded shapes, f32 and bf16, at ``clip-rn50-cc3m``'s 256 x 256 x
   1024 and its ranks' on ``data:1,fsdp:2`` (128 rows, offsets 0 and
   128), at the LM backbones' contrastive shape (64 x 64 x 512) and at
   qwen3-1.7b's ranks' on ``data:1,fsdp:2`` (32 rows against 64 columns,
   offsets 0 and 32), all f32;
6. slice   -- builds full-width ``clip-vitb32-cc12m`` params from a seeded
   generator, saves them in the checkpoint format (phase eval reuses
   it; on a thread, beside phases 3-9), and runs
   ``repro_torch.launch.serve_embed.main`` with ``--impl flash`` for the
   image tower and the text tower; holds every response against the same
   payload's solo forward through the plain attention, every cache hit
   against the computed bytes, and the kernel's launch count against 12
   per computed batch;
7. ssd     -- holds K4 (``ssd_chunk``, the Mamba2 SSD chunk scan) against
   its plain version at the zamba2-1.2b prefill shape (B/C f32 and bf16)
   and at edge cases (ragged T, T < chunk, chunk 64, large decay, the
   reduced shapes); at the prefill shape also each of its four passes
   (C B^T, chunk states, state pass, outputs) against the pass's plain
   version on the same inputs, and times kernel, passes and plain
   version;
8. ssd_grad -- gradients of x, log_a, B and C through ``ssd_chunk`` (the
   kernel forward, the plain scan's autograd backward) against autograd
   of the plain scan at a mid-size shape, and every leaf's gradient of
   a reduced ``zamba2-1.2b`` forward + backward through ``impl="flash"``
   against ``impl="chunked"``;
9. hybrid  -- full-width ``zamba2-1.2b`` (38 Mamba2 layers, one shared
   attention block called 6 times; seeded random weights, f32) through
   ``repro_torch.launch.steps.make_prefill_step(impl="flash")`` at batch
   2 x 4096 tokens: exactly 38 K4 calls (4 CUDA launches each) and 6 K3
   launches per prefill, finite
   logits, last-position logits against the plain path (``impl=
   "chunked"``); prefill vs ``decode_step`` scanned over the same 256
   tokens; ``repro_torch.launch.serve.main`` generating on the card
   (no kernel launches: decode runs none, as in JAX); ms per prefill,
   a torch.profiler breakdown, decode tokens/s, peak device memory;
10. dense  -- the dense LMs served (seeded random weights, f32):
   full-width ``qwen3-1.7b`` (28 layers, d 2048, 16 query heads over 8
   KV heads at head dim 128, qk-norm, tied embeddings) through
   ``make_prefill_step(impl="flash")`` at 2 x 4096: exactly 28 K3
   launches, all at 4096 x 4096, and nothing else; finite last-position
   logits within ``TOL_DENSE_PREFILL`` of ``impl="chunked"``, both
   paths measured against a reference whose attention runs in f64;
   prefill vs ``decode_step`` over the same 256 tokens;
   ``repro_torch.launch.serve.main`` with its defaults generating on
   the card; ms per prefill on both paths, a profile by kind of kernel
   with the idle share, peak memory; ``qwen1.5-32b`` at full width with
   2 of its 64 layers (QKV bias, 40-head MHA) at 1 x 4096: exactly 2 K3
   launches, within the same bound of the plain path;
11. moe    -- the MoE LMs served (seeded random weights, f32) at full
   width with a depth cut: ``qwen3-moe-30b-a3b`` (8 of 48 layers; 128
   experts top-8, 32 query heads over 4 KV heads at head dim 128) at 2
   x 4096 and ``llama4-scout-17b-a16e`` (4 of 48; 16 experts top-1 and
   a shared expert every other layer, 40 heads over 8) at 1 x 4096,
   each through ``make_prefill_step`` on both paths: exact parameter
   counts, exactly 8 / 4 K3 launches at 4096 x 4096 and nothing else,
   the kernel path twice equal to the bit, the kernel path replaying
   the plain path's routing (``models.moe.route`` wrapped here) within
   ``TOL_DENSE_PREFILL`` of it, the unforced kernel path's routing
   differences per layer (within ``MOE_ROUTE_DIFF_CEILING``), tokens
   dropped by the capacity per layer (> 0 for llama4-scout), ms per
   prefill, peak memory, a profile by kind of kernel (routing, dispatch
   and combine as one) with the idle share, one layer's pieces timed;
   prefill vs ``decode_step`` over 256 tokens at capacity factor 64
   (no launch); ``serve.generate`` at batch 4 (qwen3-moe); the decode
   launcher at ``--reduced``;
12. vlm    -- ``llama-3.2-vision-11b`` served at full width with 10 of
   its 40 layers (``VLM_SERVE_LAYERS``, a depth cut for the run's time;
   seeded random weights, f32; 2 super-blocks of 4 causal self blocks
   and a cross block over the projected stub image embeds, 2 x 1024 x
   1280 from the serving launcher's generator): JAX's parameter count
   at that depth, 3,323,293,696; a 2 x 4096 prefill through
   ``make_prefill_step`` on both paths: exactly 10 K3 launches at 4096 x
   4096 and 2 at 4096 x 1024 (non-causal) and nothing else, finite
   last-position logits within ``TOL_DENSE_PREFILL`` of ``impl=
   "chunked"``, both paths against the f64-attention reference; ms per
   prefill in turns, peak memory, a profile by kind of kernel with the
   idle share; prefill vs ``decode_step`` over 64 tokens with the cross
   caches filled by ``prepare_decode_state`` (neither launches K3),
   decode ms per token; ``repro_torch.launch.serve.main`` on the card at
   the same depth;
13. audio  -- ``seamless-m4t-large-v2`` served whole (12 causal encoder
   blocks over the stub frames, 2 x 1024 x 1024, and 12 decoder blocks
   with cross-attention to the encoder): the same checks, with exactly
   12 K3 launches at 1024 x 1024 (the encoder), 12 at 4096 x 4096 and 12
   at 4096 x 1024 per prefill, prefill vs decode over 256 tokens;
14. hybrid_train -- ``zamba2-1.2b`` at full width with 8 of its 38
   layers (a depth cut, PERF.md § 4) trained (f32, seed 0) under both
   objectives: ``repro_torch.launch.train --objective lm`` at 2 x 4096
   and the contrastive (v3) run at 64 x 256, each launcher in a child
   process for 3 steps (exit 0, step lines, ms per step, peak memory,
   launches exact: 16 K4 calls, 64 CUDA launches and 2 K3 per step
   under the recompute, plus one K1 and one K2 call for the
   contrastive loss; step-0 loss equal to this process's; every step's
   loss, and the contrastive run's other metrics at steps 0 and 1,
   within rtol 1e-4 of the plain path); here, from the same
   init and batches: step-0 gradients of every leaf held to a reference
   whose SSD scans run in f64 (``TOL_HYBRID_GRAD``; the plain path's,
   ``impl="chunked"``, and a bf16 control's measured against it too),
   two identical steps equal
   (per-leaf fingerprints), 3 plain-path steps, one bf16 step (loss
   within 1e-2 of f32), ms per step, peak memory, a profile by kind of
   kernel with the idle share, the backward of K4's and K3's autograd
   Functions timed at each objective's layer shapes;
15. eval   -- the zero-shot eval engine at full width:
   ``repro_torch.launch.eval.main`` on the slice's checkpoint at 192
   classes x 16 (3072 pairs, 224 px, context 77), extraction batch 256,
   ``--impl flash --loss-impl fused``: exactly 300 K3 launches (24 per
   batch, 12 for the 768-prompt head) and 1 K1 call (2 CUDA launches);
   embeddings flash vs naive within 1e-5, eval_loss fused vs dense
   within rtol 1e-5, the launcher's rank metrics equal to those of the
   pieces, streaming top-k vs the dense oracle; ms of each
   piece of a pass (CUDA events) and peak memory; K1 timed at 3072 x
   3072 x 512; the planted known answers at 192 x 16 exact; streaming ==
   dense bitwise on quantized embeddings (chunks 1024, 512, 100); the
   stable sort's signed zeros; retrieval at N = 50,000 under 2 GiB of
   extra memory; planted serving under chaos (NaN batch, corrupt cache
   entry, stalled batch, corrupt reload candidate): nothing dropped,
   every completed response bitwise equal to the solo forward;
16. train  -- three full-width FastCLIP v3 steps at global batch 256
   through ``repro_torch.launch.train.main`` (defaults ``--impl flash
   --loss-impl fused``): launch counts (3 calls of K1 and of K2, 2 CUDA
   launches each, 72 of the attention kernel), finite losses, f32 masters; step-1 gradients and
   the loss / tau / log-u trajectory against the same steps through the
   plain path (``--impl naive --loss-impl dense``); one bf16 step; ms per
   step and peak device memory; ``--eval-every 2`` over 3 steps: exact
   launches (K1 once and K3 36 times per eval at 8 x 8 pairs), the last
   ``eval`` line the evaluator's on the final params, its eval_loss the
   dense loss's within rtol 1e-5;
17. clip_family -- the paper's other two CLIP settings at full width and
   depth (v3, AdamW, global batch 256, seeded random weights):
   ``clip-rn50-cc3m`` trained 3 f32 steps by the launcher in a process
   of its own that sets no backend flag (the port's device policy alone:
   no TF32, deterministic cuDNN), 36 K3 and 3 + 3 K1 / K2 calls, held to
   the plain path here (trajectory and log-u rtol 1e-4, step-1 gradients
   1e-4 relative L2), one bf16 step, two identical steps bitwise, a
   profile of one step by kind of kernel (cuDNN convs, GroupNorm, K3,
   K1/K2, GEMMs, the rest); its step-3 checkpoint served (both towers,
   0 K3 per image batch) and evaluated (3072 pairs, 156 K3, K1 once,
   fused vs dense) by the launchers; ``data:1,fsdp:2`` (2 gloo ranks on
   the card) held to one device (loss 1e-5, params 5e-5, log-u 1e-4);
   ``clip-vitb16-laion`` 3 f32 steps (36 K3 at S = 197, 36 at 77) with
   the same checks;
18. mesh   -- the (data, fsdp) mesh (``--mesh``): K1 / K2 at each rank's
   shape of data:2,fsdp:2 at global batch 256 (64 rows x 256 gathered
   columns x 512, row offsets 0, 64, 128, 192) against their plain
   versions, timed; ``--mesh data:1,fsdp:1`` (a one-rank NCCL group)
   through the launcher in a process of its own, held to phase train's
   run, beside the 4-rank step-level checks below; ``--mesh
   data:2,fsdp:2`` as 4 ranks sharing the card (gloo), spawned through
   ``repro_torch.launch.multiprocess`` (this script's ``--mesh-worker``
   ranks): 3 steps with ``--eval-every 2`` and a sharded checkpoint,
   every rank's lines equal, exact launches per rank, each rank's peak
   memory, the checkpoint verified and restored merged on the card; the
   step-level checks on 4 ranks (full width, 6 of each tower's 12
   layers: a depth cut): step-1 gradients after the reduction and merge
   against the single-device step's on the same global batch, 3 steps'
   loss and tau, microbatch 2 against 1 (step-1 gradients and the
   trajectory at the same bounds; 24 K3 launches per rank per step),
   the sharded top-k bitwise and the planted known answers exact
   through the sharded retrieval;
19. resilience -- the trainer's recovery paths at full width (v3, f32,
   batch 256, 1024 samples, ``--impl flash --loss-impl fused``), every
   state compared by the sha256 of every leaf with the oracle's (4
   steps, synchronous saves at 2 and 4): ``nan_batch@2`` under
   ``--guard`` equal to the oracle's step-2 checkpoint; ``--data
   streaming:`` (shards of the same samples, 4 decode workers) equal to
   the oracle, ms per step and host seconds per batch of both loaders;
   a ``kill@3`` launcher subprocess, then ``--resume`` here, equal to
   the oracle; one run with ``--ckpt-async --ckpt-keep 1`` and
   ``--rollback-after 2`` over ``nan_batch@2,nan_batch@3`` (6 steps run)
   equal to the oracle, keeping step 4 only, its latest checkpoint and
   heartbeat checked, the gap that holds its async save beside the
   oracle's sync one; both curricula (image 32 then 224, context 32
   then 77) on the kernel and the plain paths within rtol 1e-4, K3's
   launches counted by shape; launches exact in every run; and, at the
   reduced size on data:2,fsdp:2 (4 gloo ranks on the card), a
   ``kill@3`` plus ``--resume`` and a ``nan_batch@2`` skip, each rank's
   shards bitwise;
20. dense_train -- ``qwen3-1.7b`` at full width with 10 of its 28
   layers (``DENSE_TRAIN_LAYERS``, a depth cut for the run's time)
   trained (f32, seed 0, JAX's grouped recompute: 2 groups of 5 layers,
   each recomputed once):
   ``repro_torch.launch.train --objective lm`` at 2 x 4096 in a child
   process for 3 steps (exit 0, step lines, ms per step, peak memory,
   launches exact: 10 K3 forwards and 10 in the recompute per step, no
   K1, K2 or K4; step-0 loss equal to this process's; every step's loss
   within rtol 1e-4 of the plain path); here, from the same init and
   batches: a profiled step by kind of kernel, then the same step timed
   (launches exact, peak memory) and the idle share of it; the kernel
   path's step-0 gradients and 3 plain-path (``impl="chunked"``) steps,
   step 0's gradients of every leaf within 1e-4 relative L2 of the
   kernel path's; the backward of ``_FlashMHA`` per call at the layer
   shape; the contrastive objective (v3) at 64 x 256: 2 timed steps (per
   step one K1 and one K2 call, 2 CUDA launches each, and K3 as above),
   step-0 gradients of both paths at the same bound; and the contrastive
   objective on ``data:1,fsdp:2`` (2 gloo ranks on the card, full
   width, 4 of the 28 layers, 2 steps, both ranks starting each step
   together): exit codes, launches per rank exact, ms per step and peak
   memory per rank, each step against one device from the same state
   (loss 1e-5, log-u 1e-4, moments and update per group of leaves, as
   phase clip_family's mesh);
21. moe_train -- ``qwen3-moe-30b-a3b`` at full width with 2 of its 48
   layers (``MOE_TRAIN_LAYERS``: a step at 4 does not fit the card, and
   3 until the xLSTM's phases needed the run's time)
   trained (f32, seed 0; JAX's rule recomputes each super-block on its
   own): the LM launcher at 2 x 4096 in a child process for 3 steps
   (exit 0, step lines with ``moe_lb`` and ``moe_z``, launches exact: 2
   K3 forwards and 2 in the recompute per step, ms per step, peak
   memory, step-0 loss equal to this process's); here, from the same
   init and batch: a profiled step by kind of kernel and the same step
   timed (launches, peak, idle share), the kernel path's step-0
   gradients twice (equal to the bit, each recompute routing as its
   forward), the plain path's on the kernel path's routes within 1e-4
   relative L2 per leaf, the unforced routing's differences under
   ``MOE_ROUTE_DIFF_CEILING``, ``_FlashMHA``'s and the dispatch's
   backward timed at the layer shape; the contrastive objective at 64 x
   256 (2 timed steps with one K1 and one K2 call each, the gradient
   check as above); ``data:1,fsdp:2`` at 1 of the 48 layers as phase
   dense_train's;
22. vlm_train -- ``llama-3.2-vision-11b`` at full width with 5 of its 40
   layers (``VLM_TRAIN_LAYERS``: one super-block, 4 self blocks and a
   cross block; a step holds ~7x the f32 params) trained (f32, seed 0;
   each block recomputed on its own, the image projected once): the
   LM objective through ``launch.steps.make_lm_train_step`` at
   ``CROSS_TRAIN_LM_BATCH`` x 4096 with the stub image embeds drawn as
   the serving launcher draws them: 3 kernel-path steps (step 1 timed
   with its peak memory, step 2 profiled by kind of kernel with the idle
   share; K3 exactly 2 x (5 at 4096 x 4096, 1 at 4096 x 1024) per step)
   and 3 plain-path steps (``impl="chunked"``), step 0's gradients of
   every leaf within ``TOL_TRAIN_GRAD`` relative L2 and every step's
   loss within ``TOL_TRAIN_TRAJ``; the contrastive objective (v3, 64 x
   256) through ``core.train_step.make_train_step``: 2 steps of each
   path, one K1 and one K2 call per step on the kernel path, K3 exactly,
   the same gradient and trajectory bounds, the leaves the objective
   does not reach (``lm_head``) zero in the gradient and moved by the
   decoupled weight decay alone; ``_FlashMHA``'s backward timed at the
   cross shapes; the training launcher exiting 2 for the family under
   both objectives, naming F6 (its datasets carry no stub inputs, as
   JAX's carry none);
23. audio_train -- ``seamless-m4t-large-v2`` whole (12 encoder and 12
   decoder layers, each recomputed on its own) trained the same way:
   LM at 2 x 4096 (K3 exactly 2 x 12 at each of 1024 x 1024, 4096 x
   4096 and 4096 x 1024 per step), the contrastive objective over the
   encoder alone (2 x 12 K3 at 64 x 64 per step; the decoder,
   ``embed``, ``final_norm`` and ``lm_head`` unreached);
24. xlstm -- ``xlstm-125m`` at full width and depth (12 blocks,
   ``mmmsmmmsmmms``, 193,280,584 params; f32, seed 0), no kernel of the
   port on its path: the prefill at 2 x 4096 timed with its peak memory,
   then profiled by kind of kernel with the idle share; the decode
   launcher at batch 4 over 64 tokens (tokens/s); first, its checks
   that time nothing: one mLSTM block chunked against sequential at 2 x
   4096 (max abs 2e-4, JAX's test bound) and the prefill against 256
   decode steps (5e-3); at its end the card's memory it took all
   returned (allocated and reserved, PyTorch's leak-check count);
25. xlstm_train -- the same model trained: the LM step at 2 x 4096
   through ``launch.steps.make_lm_train_step`` (step 0 profiled by kind
   of kernel, step 1 timed with its peak memory and the idle share; the
   loss near ln V; no kernel of the port).  Then its checks that time
   nothing, beside its launchers: one sLSTM block's token loops at 2 x
   512 eagerly and as CUDA graphs, equal to the bit, each profiled
   (kernels per token); the step-0 gradients at 2 x 512
   against the same step in f64 on the card (every leaf within 1e-3
   relative L2, f32's own rounding on this model; the f32 gradients at
   mLSTM chunk 32 beside them), the contrastive objective (v3, 64 x 256)
   on the K1/K2 path and the dense loss (one K1 and one K2 call per
   step, step-0 gradients of every leaf within ``TOL_TRAIN_GRAD``, the
   trajectory within ``TOL_TRAIN_TRAJ``), and the training launcher in
   a child process under each objective (3 LM steps at 2 x 512, 3
   contrastive steps at 64 x 256, held since before phase moe_train:
   exit 0, finite step lines, launches exact); its memory returned as
   phase xlstm's; last, so that its failure hides no earlier phase's
   result;
26. report -- the kernels JSON line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line.  Imports nothing
of JAX or of the JAX package.  ``--only kernel,resilience`` (a partial
run for development) runs phases device and build, then the named
phases, and prints no report.  Two phases run only so: ``remat_forms``,
a diagnostic that times full-width ``qwen3-1.7b``'s LM step at 2 x 4096
under the port's one-level grouped recompute against JAX's nested form
(a recompute of each layer inside its group's, written here: the port
does not carry it), each twice, their launches exact and their states
equal to the bit; ``moe_depth``, which tries one qwen3-moe LM step at
4 layers and reports its peak (the measurement behind
``MOE_TRAIN_LAYERS``); ``vlm_remat_forms``, which times the vlm's LM
step (``VLM_TRAIN_LAYERS``) under the port's one-level recompute (each
block on its own), a recompute per super-block, and JAX's nested form
(a super-block's recompute around its self blocks' own), in turns, with
each form's launches exact, its peak memory and its state equal to the
bit: the measurement behind the port's form and ``CROSS_TRAIN_LM_BATCH``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
ARCH = "clip-vitb32-cc12m"
# H100 SXM data-sheet peaks (dense): HBM bytes/s; f32 outside the tensor
# cores and bf16 tensor-core FLOP/s; TF32 tensor-core FLOP/s (the floor
# of split TF32, three TF32 products per f32 product)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_TF32 = 495e12
PEAK_F64_TC = 67e12      # f64 on the tensor cores (DMMA)
# Tolerances.  Kernel vs plain version: those of tests/test_precision_flash.py.
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Tower embeddings (L2-normalised, 12 layers), flash path vs the plain
# attention and served bucket vs solo forward: the same bounds end to end.
TOL_EMBED = {"float32": 1e-5, "bfloat16": 1e-2}
SERVE_REQUESTS = 64
HYBRID_ARCH = "zamba2-1.2b"
# K4 vs its plain version: max abs error relative to max(1, max |y|)
# (the kernel's warp-scan cumsum and torch.cumsum round F differently;
# every decay carries eps * |F|); tests/test_torch_cuda.py holds the same
TOL_SSD = 5e-5
# hybrid prefill, kernel path vs plain path: relative L2 of the
# last-position logits; prefill vs stepwise decode: max abs error, as
# tests/test_decode_equivalence.py
TOL_HYBRID_REL, TOL_PREFILL_DECODE = 1e-4, 5e-3
# the dense prefills (phase dense), kernel path vs plain path: max abs
# error of the last-position logits
TOL_DENSE_PREFILL = 1e-4
DENSE_ARCH, DENSE_WIDE_ARCH = "qwen3-1.7b", "qwen1.5-32b"
# K1 / K2 vs their plain versions: those of tests/test_kernels.py (K1 f32
# rtol/atol 1e-5, bf16 1e-2 in log domain; K2 rtol 1e-4, atol 1e-5)
TOL_K1, TOL_K1_LOG_BF16, TOL_K2 = 1e-5, 1e-2, (1e-4, 1e-5)
# attention gradients, flash Function vs autograd of the naive attention
TOL_ATTN_GRAD = 1e-5
# the training step, kernel path vs plain path: step-1 gradients (relative
# L2 error per leaf) and the loss / tau / log-u trajectory (rtol)
TOL_TRAIN_GRAD, TOL_TRAIN_TRAJ = 1e-4, 1e-4
# K4 gradients vs autograd of the plain scan, and a reduced hybrid's leaf
# gradients through the kernels vs the plain path: relative L2
TOL_SSD_GRAD = 1e-4
TRAIN_ARGS = ["--arch", ARCH, "--version", "v3", "--optimizer", "adamw",
              "--global-batch", "256", "--n-samples", "2048",
              "--log-every", "1", "--device", "cuda", "--seed", "0"]


def emit(phase, **kw):
    # one write per line: a thread may emit beside the main one
    print(json.dumps({"phase": phase, **kw}, sort_keys=True) + "\n", end="",
          flush=True)


class Checks:
    def __init__(self):
        self.failed = []

    def check(self, ok, what):
        if not ok:
            self.failed.append(what)
            print(f"chip_smoke: CHECK FAILED: {what}", file=sys.stderr,
                  flush=True)
        return ok

    def end_phase(self, phase):
        if self.failed:
            print(f"chip_smoke: phase {phase} failed: {self.failed}",
                  file=sys.stderr, flush=True)
            sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters=50):
    """Device time per call: CUDA events around ``iters`` calls, queued
    behind a device-side sleep so that the host enqueues them all before
    the first starts (the small kernels here run faster than Python can
    launch them)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def allowed_pairs(Sq, Sk, causal, window):
    n = 0
    for i in range(Sq):
        hi = min(Sk, i + 1) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def bound(B, H, Sq, Sk, hd, causal, window, dtype_name):
    """Least time on the card: each of q, k, v, o moved once over HBM,
    against the score and PV FLOPs of the unmasked pairs at the peak
    rate of the input type.  Returns (ms, "bytes" | "operations")."""
    item = 4 if dtype_name == "float32" else 2
    nbytes = item * B * H * hd * (2 * Sq + 2 * Sk)
    flops = 4 * hd * B * H * allowed_pairs(Sq, Sk, causal, window)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs the port on a GPU only", file=sys.stderr)
        sys.exit(1)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the root "
              "of a checkout of the repository", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, SRC)
    from repro_torch import device as D
    D.set_numerics_policy()      # as every entry point of the port does
    card = card_line()
    print(card, flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=card, backend_flags=_backend_flags())


def tensor_core_ops(lib):
    """{function: {SASS opcode: count}} of the tensor-core instructions
    (HMMA, HGMMA) in a built library, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        for op in ("HGMMA", "HMMA"):
            if f" {op}." in ln or f" {op} " in ln:
                per = counts.setdefault(fn, {})
                per[op] = per.get(op, 0) + 1
    return counts


def _flash_instances(ptxas, ops):
    """K3's instantiations by (dtype, head dim): ptxas's registers and
    spill line, and the tensor-core SASS count of each."""
    out, entry = {}, None
    for ln in ptxas:
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", ln)
        if m and "Compiling entry" in ln:
            entry = f"{'f32' if m.group(1) == 'f' else 'bf16'}/hd{m.group(2)}"
            out[entry] = {"ptxas": []}
        elif entry and ("spill" in ln or "registers" in ln):
            out[entry]["ptxas"].append(ln)
    for fn, per in ops.items():
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", fn)
        if m:
            key = f"{'f32' if m.group(1) == 'f' else 'bf16'}/hd{m.group(2)}"
            out.setdefault(key, {"ptxas": []})["sass"] = per
    return out


def phase_build(checks):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    t0 = time.monotonic()
    build.build(build.SOURCES)       # one nvcc per source, in parallel
    seconds = time.monotonic() - t0
    for name in build.SOURCES:
        build.load(name)
        log = build.build_log(name)
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln
                 or "Compiling entry" in ln]
        rec = dict(kernel=name, seconds_all_parallel=seconds,
                   library=str(build.lib_path(name)), ptxas=ptxas)
        per_fn = tensor_core_ops(build.lib_path(name))
        ops = {}
        for per in per_fn.values():
            for op, n in per.items():
                ops[op] = ops.get(op, 0) + n
        spills = [ln for ln in ptxas if re.search(
            r"[1-9]\d* bytes spill (stores|loads)", ln)]
        checks.check(sum(ops.values()) > 0,
                     f"build: no tensor-core instruction in {name}")
        checks.check(not spills, f"build: {name} spills: {spills}")
        rec.update(tensor_core_sass=ops, spills=spills)
        if name == "flash_attention":
            # every instantiation on the tensor cores: HGMMA for bf16
            # (wgmma), HMMA for f32 (split TF32 on mma.sync), hd 128 too
            inst = _flash_instances(ptxas, per_fn)
            want = {f"{dt}/hd{hd}" for dt in ("f32", "bf16")
                    for hd in HEAD_DIMS}
            bad = sorted(k for k in want if not inst.get(k, {}).get(
                "sass", {}).get("HGMMA" if k.startswith("bf16") else "HMMA"))
            checks.check(set(inst) == want and not bad,
                         f"build: K3 instantiations {sorted(inst)} (want "
                         f"{sorted(want)}), without tensor-core SASS: {bad}")
            rec["instantiations"] = inst
        emit("build", **rec)
    checks.end_phase("build")


KERNEL_CASES = [
    # name, B, H, Sq, Sk, hd, causal, window, dtype, timed; the timed
    # cases are the main paths' shapes: serving at bucket 8, training at
    # global batch 256, the eval's prompt head (4 templates x 192 classes),
    # zamba2-1.2b's shared block at the prefill (2 x 4096)
    ("vit", 8, 12, 50, 50, 64, False, 0, "float32", True),
    ("vit", 8, 12, 50, 50, 64, False, 0, "bfloat16", True),
    ("text", 8, 8, 77, 77, 64, True, 0, "float32", True),
    ("text", 8, 8, 77, 77, 64, True, 0, "bfloat16", True),
    ("vit_train", 256, 12, 50, 50, 64, False, 0, "float32", True),
    ("vit_train", 256, 12, 50, 50, 64, False, 0, "bfloat16", True),
    ("text_train", 256, 8, 77, 77, 64, True, 0, "float32", True),
    ("text_train", 256, 8, 77, 77, 64, True, 0, "bfloat16", True),
    # clip-vitb16-laion's image tower at batch 256: 14 x 14 patches + CLS
    ("vitb16_train", 256, 12, 197, 197, 64, False, 0, "float32", True),
    ("vitb16_train", 256, 12, 197, 197, 64, False, 0, "bfloat16", True),
    ("text_head", 768, 8, 77, 77, 64, True, 0, "float32", True),
    ("hybrid", 2, 32, 4096, 4096, 64, True, 0, "float32", True),
    ("hybrid", 2, 32, 4096, 4096, 64, True, 0, "bfloat16", True),
    # zamba2-1.2b's contrastive training (phase hybrid_train): 64 x 256
    ("hybrid_ctr", 64, 32, 256, 256, 64, True, 0, "float32", True),
    # qwen3-1.7b's contrastive training (phase dense_train): 64 x 256, and
    # a rank's 32 rows of it on data:1,fsdp:2
    ("qwen3_ctr", 64, 16, 256, 256, 128, True, 0, "float32", True),
    ("qwen3_mesh", 32, 16, 256, 256, 128, True, 0, "float32", True),
    # the dense prefills of phase dense at head dim 128: qwen3-1.7b (16
    # heads, its 8 KV heads repeated) at 2 x 4096, qwen1.5-32b (40 heads)
    # at 1 x 4096
    ("qwen3", 2, 16, 4096, 4096, 128, True, 0, "float32", True),
    ("qwen3", 2, 16, 4096, 4096, 128, True, 0, "bfloat16", True),
    ("qwen1p5", 1, 40, 4096, 4096, 128, True, 0, "float32", True),
    # the MoE prefill of phase moe: qwen3-moe-30b-a3b (32 heads, its 4 KV
    # heads repeated) at 2 x 4096; llama4-scout's 1 x 40 x 4096 is
    # qwen1p5's shape
    ("qwen3_moe", 2, 32, 4096, 4096, 128, True, 0, "float32", True),
    ("qwen3_moe", 2, 32, 4096, 4096, 128, True, 0, "bfloat16", True),
    # the cross-attention families' prefills at 2 x 4096 (phases vlm and
    # audio): llama-3.2-vision-11b's cross blocks (32 heads over its 8 KV
    # heads repeated, 1024 image tokens; its self-attention is qwen3_moe's
    # shape), seamless-m4t-large-v2's decoder cross-attention over its
    # 1024 encoder frames, its causal encoder and its decoder's
    # self-attention
    ("vlm_cross", 2, 32, 4096, 1024, 128, False, 0, "float32", True),
    ("vlm_cross", 2, 32, 4096, 1024, 128, False, 0, "bfloat16", True),
    ("audio_cross", 2, 16, 4096, 1024, 64, False, 0, "float32", True),
    ("audio_cross", 2, 16, 4096, 1024, 64, False, 0, "bfloat16", True),
    ("audio_enc", 2, 16, 1024, 1024, 64, True, 0, "float32", True),
    ("audio_self", 2, 16, 4096, 4096, 64, True, 0, "float32", True),
    # qwen3-moe's contrastive training (phase moe_train): 64 x 256, and a
    # rank's 32 rows of it on data:1,fsdp:2
    ("qwen3_moe_ctr", 64, 32, 256, 256, 128, True, 0, "float32", True),
    ("qwen3_moe_mesh", 32, 32, 256, 256, 128, True, 0, "float32", True),
    # the cross families' contrastive training at 64 x 256 (phases
    # vlm_train and audio_train): the vlm's cross blocks over its 1024
    # image tokens (its self-attention is qwen3_moe_ctr's shape), the
    # audio encoder over its 64 frames (the objective's only attention)
    ("vlm_ctr_cross", 64, 32, 256, 1024, 128, False, 0, "float32", True),
    ("audio_ctr_enc", 64, 16, 64, 64, 64, True, 0, "float32", True),
    # edge cases at head dim 128, timed too (on no main path)
    ("hd128_ragged", 2, 4, 77, 77, 128, True, 0, "float32", True),
    ("hd128_ragged", 2, 4, 77, 77, 128, True, 0, "bfloat16", True),
    ("hd128_window", 2, 4, 300, 300, 128, True, 100, "float32", True),
    ("hd128_window", 2, 4, 300, 300, 128, True, 100, "bfloat16", True),
    ("hd128_sq_ne_sk", 2, 4, 64, 300, 128, False, 0, "float32", True),
    ("hd128_sq_ne_sk", 2, 4, 200, 70, 128, True, 0, "bfloat16", True),
    ("sq_ne_sk", 2, 4, 64, 300, 64, False, 0, "float32", False),
    ("sq_ne_sk_causal", 2, 4, 200, 70, 64, True, 0, "bfloat16", False),
    ("window", 2, 4, 130, 130, 64, True, 17, "float32", False),
    ("window_noncausal", 2, 4, 130, 130, 64, False, 40, "bfloat16", False),
    ("long_ragged", 1, 4, 1000, 1000, 64, True, 0, "float32", False),
    ("long_ragged", 1, 4, 1000, 1000, 64, False, 0, "bfloat16", False),
    ("below_one_tile", 3, 2, 10, 10, 64, True, 0, "float32", False),
    ("below_one_tile", 3, 2, 10, 10, 64, False, 0, "bfloat16", False),
    ("hd32", 2, 4, 77, 77, 32, True, 0, "float32", False),
    ("hd32", 2, 4, 130, 130, 32, False, 0, "bfloat16", False),
    # the curricula's shapes at global batch 256 (phase resilience): the
    # 32 px image (one patch and the class token), the 32-token context
    ("curriculum_vit", 256, 12, 2, 2, 64, False, 0, "float32", False),
    ("curriculum_text", 256, 8, 32, 32, 64, True, 0, "float32", False),
]


def phase_kernel(checks):
    """Kernel vs plain version; returns {(case, dtype): timing dict} for
    every timed case, f32 and bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(0)
    timings = {}
    for (name, B, H, Sq, Sk, hd, causal, window, dt_name,
         timed) in KERNEL_CASES:
        dt = getattr(torch, dt_name)
        q, k, v = (torch.randn((B, H, S, hd), generator=gen, device="cuda",
                               dtype=torch.float32).to(dt)
                   for S in (Sq, Sk, Sk))
        out = FA.flash_attention(q, k, v, causal=causal, window=window)
        ref = FA.flash_attention_ref(q, k, v, causal=causal, window=window)
        # the (B, S, H, hd) entry point reads strided views in place
        mha = FA.flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err_mha = (mha.transpose(1, 2).float() - ref.float()).abs().max(
        ).item()
        ok = (out.dtype == dt and math.isfinite(err) and err <= TOL[dt_name]
              and err_mha <= TOL[dt_name])
        checks.check(ok, f"kernel {name} {dt_name}: max_abs_err {err} / "
                         f"{err_mha} (tol {TOL[dt_name]})")
        rec = dict(case=name, shape=[B, H, Sq, Sk, hd], causal=causal,
                   window=window, dtype=dt_name, max_abs_err=err,
                   max_abs_err_mha=err_mha, tol=TOL[dt_name], ok=ok)
        if timed:
            iters = 5 if Sq > 1000 else 50
            ms = device_ms(lambda: FA.flash_attention(
                q, k, v, causal=causal, window=window), iters)
            plain_ms = device_ms(lambda: FA.flash_attention_ref(
                q, k, v, causal=causal, window=window), iters)
            if window:      # the same function: the window as a mask
                qp = torch.arange(Sq, device="cuda")[:, None]
                kp = torch.arange(Sk, device="cuda")[None, :]
                mask = (kp > qp - window) & ((kp <= qp) if causal else True)
                lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), iters)
            else:
                lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), iters)
            b_ms, b_by = bound(B, H, Sq, Sk, hd, causal, window, dt_name)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            timings[name, dt_name] = dict(rec)
        emit("kernel", **rec)
    checks.end_phase("kernel")
    return timings


def _solo_embedding(model, payload, key, impl, precision):
    import torch
    from repro_torch.core import losses as LS
    from repro_torch.models import clip as C
    tower = C.encode_image if key == "images" else C.encode_text
    x = torch.from_numpy(payload[key][None]).to("cuda")
    with torch.inference_mode():
        e = LS.l2_normalize(tower(model, x, impl=impl, precision=precision))
    return e[0].cpu().numpy()


def make_clip_checkpoint():
    """Full-width ``clip-vitb32-cc12m`` params from a seeded generator,
    saved in the checkpoint format (phases slice and eval serve and
    evaluate it).  Returns (checkpoint directory, the model on the
    CPU)."""
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch.checkpoint import bridge
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    cfg = get_arch(ARCH)
    t0 = time.monotonic()
    model = BB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n_params = sum(p.numel() for p in model.parameters())
    t_init = time.monotonic() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.monotonic()
    CK.save(ckpt, {"params": bridge.model_to_tree(model)}, 0,
            {"arch": ARCH, "seed": 0})
    t_save = time.monotonic() - t0
    npz_bytes = os.path.getsize(os.path.join(ckpt, "ckpt_00000000.npz"))
    emit("slice_params", arch=ARCH, n_params=n_params,
         init_seconds=t_init, save_seconds=t_save, npz_bytes=npz_bytes)
    return ckpt, model


def phase_slice(checks, ckpt, model):
    """Serve both towers at full width through the port's launcher from
    the checkpoint in ``ckpt`` (``model`` holds the same params; it moves
    to the card).  Returns {tower: flash launches in its serving run}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import ZeroShotEvalDataset
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve_embed
    from repro_torch.models import clip as C
    from repro_torch.models import precision as PR
    from repro_torch.serve import content_hash

    cfg = get_arch(ARCH)
    model = model.to("cuda")
    # both towers, f32 and bf16 policies, flash vs the plain attention
    # (this also warms the card before the served runs below)
    ds = ZeroShotEvalDataset(n_classes=8, n_per_class=1,
                             image_size=cfg.clip.image_size,
                             context_length=cfg.clip.context_length,
                             vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in ds.batch(np.arange(8)).items()}
    for prec in (PR.F32, PR.BF16):
        with torch.inference_mode():
            outs = {impl: [e / e.norm(dim=-1, keepdim=True)
                           for e in C.encode_pair(model, batch, impl=impl,
                                                  precision=prec)]
                    for impl in ("flash", "naive")}
        tol = TOL_EMBED[str(prec.compute_dtype).split(".")[-1]]
        for i, tower in enumerate(("vit", "text")):
            d = (outs["flash"][i] - outs["naive"][i]).abs().max().item()
            ok = checks.check(
                outs["flash"][i].dtype == torch.float32 and d <= tol,
                f"{tower} {prec.name}: flash vs naive {d}")
            emit("slice_towers", tower=tower, precision=prec.name,
                 batch=8, flash_vs_naive_max_abs=d, tol=tol, ok=ok)
    launches = {}
    for tower, modality, key in (("vit", "image", "images"),
                                 ("text", "text", "texts")):
        record = []
        argv = ["--ckpt-dir", ckpt, "--arch", ARCH, "--impl", "flash",
                "--device", "cuda", "--modality", modality,
                "--requests", str(SERVE_REQUESTS), "--classes", "32",
                "--per-class", "1", "--payload-pool", "24",
                "--offered-rate", "100"]
        FA.flash_attention.launches = 0
        t0 = time.monotonic()
        stats = serve_embed.main(argv, record=record)
        wall = time.monotonic() - t0
        n_launch = FA.flash_attention.launches
        launches[tower] = n_launch
        n_layers = (cfg.clip.vision_layers if tower == "vit"
                    else cfg.n_layers)
        checks.check(stats["dropped"] == 0 and stats["completed"] > 0,
                     f"{tower}: dropped {stats['dropped']}, completed "
                     f"{stats['completed']}")
        checks.check(stats["served_cache"] > 0,
                     f"{tower}: no cache hits")
        checks.check(stats["retries"] == 0 and n_launch > 0
                     and n_launch == n_layers * stats["batches"],
                     f"{tower}: {n_launch} flash launches for "
                     f"{stats['batches']} batches x {n_layers} layers")
        # every computed response vs its payload's solo forward through
        # the plain attention; every cache hit vs the computed bytes
        computed = {}
        worst = 0.0
        for payload, res in record:
            if res.path == "compute":
                computed.setdefault(content_hash(payload), set()).add(
                    res.embedding.tobytes())
                solo = _solo_embedding(model, payload, key, "naive",
                                       PR.F32)
                worst = max(worst, float(np.abs(
                    solo - res.embedding).max()))
        # a hit returns the bytes of a compute of the same payload
        cache_exact = all(
            res.embedding.tobytes() in computed[content_hash(payload)]
            for payload, res in record if res.path == "cache")
        bitwise = all(
            res.embedding.tobytes() == _solo_embedding(
                model, payload, key, "flash", PR.F32).tobytes()
            for payload, res in record if res.path == "compute")
        lat = sorted(res.latency * 1e3 for _, res in record
                     if res.path == "compute")
        checks.check(worst <= TOL_EMBED["float32"],
                     f"{tower}: served vs solo naive {worst}")
        checks.check(cache_exact, f"{tower}: cache hit != computed")
        emit("slice_serve", tower=tower, wall_seconds=wall,
             batches=stats["batches"], completed=stats["completed"],
             served_compute=stats["served_compute"],
             served_cache=stats["served_cache"],
             dropped=stats["dropped"], flash_launches=n_launch,
             launches_per_batch=n_launch / max(stats["batches"], 1),
             served_vs_solo_naive_max_abs=worst,
             tol=TOL_EMBED["float32"], cache_hits_bitwise=cache_exact,
             served_vs_solo_flash_bitwise=bitwise,
             service_time_est_s=stats["service_time_est"],
             computed_latency_ms_p50=lat[len(lat) // 2],
             computed_latency_ms_max=lat[-1])
    checks.end_phase("slice")
    return launches


# the eval phase: 192 classes x 16 (N = 3072 pairs, the largest class
# count of the planted split), extraction batch 256; ImageNet-1k's
# validation split (50,000) for the memory contract
EVAL_CLASSES, EVAL_PER_CLASS, EVAL_BATCH, EVAL_CHUNK = 192, 16, 256, 512
EVAL_TOPK_SCORE_TOL = 1e-6
RETRIEVAL_N, RETRIEVAL_K, RETRIEVAL_CHUNK = 50_000, 10, 1024
RETRIEVAL_EXTRA_BYTES_MAX = 2 * 2 ** 30
SERVE_CHAOS = "compute_nan@2,cache_corrupt@1,slow_batch@3:50,reload_bad_ckpt@1"


def event_ms(fn):
    """(ms, result) of one call between two CUDA events (the card
    warmed before; the call's result is synchronised)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def quantized_emb(n, d, seed):
    """Entries in multiples of 1/64 (tests/test_eval.py): every f32 dot
    product is exact in any summation order, so streaming and dense
    scores are bitwise equal."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return torch.from_numpy((np.round(rng.randn(n, d) * 16) / 64.0).astype(
        np.float32)).to("cuda")


def _bits_equal(a, b):
    import torch
    return a.shape == b.shape and torch.equal(a.contiguous().view(
        torch.int32), b.contiguous().view(torch.int32))


def _eval_topk_vs_dense(checks, e1, e2):
    """Streaming top-k of the real embeddings vs the dense oracle: scores
    within EVAL_TOPK_SCORE_TOL; an index may differ only between
    candidates whose dense scores differ by less than that."""
    from repro_torch.eval import metrics as M
    from repro_torch.eval import retrieval as RT
    out = {}
    for name, (a, b) in (("i2t", (e1, e2)), ("t2i", (e2, e1))):
        s_st, i_st = RT.streaming_topk(a, b, 10, chunk=EVAL_CHUNK)
        S = a @ b.T
        s_de, i_de = M.lex_topk(S, 10)
        err = (s_st - s_de).abs().max().item()
        diff = i_st != i_de
        n_diff = int(diff.sum())
        gap = ((S.gather(1, i_st) - S.gather(1, i_de)).abs()[diff].max()
               .item() if n_diff else 0.0)
        checks.check(err <= EVAL_TOPK_SCORE_TOL
                     and gap < EVAL_TOPK_SCORE_TOL,
                     f"eval top-k {name}: score err {err}, {n_diff} "
                     f"indices differ, widest gap {gap}")
        out[name] = dict(score_max_abs_err=err, indices_differ=n_diff,
                         differing_score_gap_max=gap)
        del S
    return out


def _signed_zero_rows():
    """{width: rows} of {-0.0, 0.0, 0.5, -1.0} at the widths the eval
    path sorts (k + chunk, the dense 3072 oracle): a stable sort must keep
    -0.0 and 0.0 in input order, as the JAX tie rule does."""
    import numpy as np
    import torch
    rng = np.random.RandomState(3)
    vals = np.asarray([-0.0, 0.0, 0.5, -1.0], np.float32)
    return {w: torch.from_numpy(vals[rng.randint(0, 4, (4, w))])
            for w in (10 + EVAL_CHUNK, 10 + RETRIEVAL_CHUNK, 3072)}


def _k1_f64(e1, e2, tau):
    """K1's square-case statistics (g1, g2, dg1, dg2, m1, m2) evaluated in
    f64, similarities and diagonal included: the plain version's formulas
    with no f32 rounding, the yardstick of both versions."""
    import torch
    e1, e2 = e1.double(), e2.double()
    N = e1.shape[0]
    sd = (e1 * e2).sum(dim=-1)
    eye = torch.eye(N, dtype=torch.bool, device=e1.device)
    out = []
    for s in (e1 @ e2.T, e2 @ e1.T):
        diff = s - sd[:, None]
        z = (diff / tau).masked_fill(eye, float("-inf"))
        m = z.amax(dim=1)
        p = (z - m[:, None]).exp()
        out.append((p.sum(dim=1) / (N - 1),
                    (p * -diff).sum(dim=1) / (tau * tau) / (N - 1), m))
    (g1, dg1, m1), (g2, dg2, m2) = out
    return g1, g2, dg1, dg2, m1, m2


def _tol_k1_ratio(got, ref):
    """Largest |got - ref| / (TOL_K1 + TOL_K1 |ref|): at most 1 is within
    K1's tolerances of ``ref``."""
    return ((got.double() - ref).abs() / (TOL_K1 + TOL_K1 * ref.abs())
            ).max().item()


# K1's similarities carry 21 bits of each f32 operand (split TF32,
# csrc/mma_tf32.cuh) where an f32 product carries 24: against the f64
# evaluation the kernel may stand up to 2^3 times as far as the plain
# version does
K1_SPLIT_VS_F32 = 8.0


def _eval_k1(checks, name, e1, e2, counts, against_f64=False):
    """K1 on an eval pass's embeddings (square N x N x d, tau 0.07), the
    kernel against its plain version at TOL_K1, and timed; ``counts``:
    the launches of the pass.  With ``against_f64`` (embeddings so nearly
    collinear that f32 rounding of the similarities moves dg past TOL_K1
    in the plain version too): each output of both versions against the
    f64 evaluation, the kernel within TOL_K1 of it or no farther than
    K1_SPLIT_VS_F32 times the plain version.  Emits and returns its
    timings."""
    import torch
    from repro_torch.kernels import gcl_loss as GL
    N, d = e1.shape
    t = torch.full((N,), 0.07, device="cuda")
    e1a, e2a, sd, v1, v2, denom = GL._stats_args(e1, e2, t, t, None, None)
    got = GL.gcl_pair_stats(e1, e2, t, t)
    ref = GL.gcl_pair_stats_plain(e1, e2, t, t)
    k1_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    extra = {}
    if against_f64:
        exact = _k1_f64(e1, e2, 0.07)
        names = ("g1", "g2", "dg1", "dg2", "m1", "m2")
        ratio = {n: [_tol_k1_ratio(k, x), _tol_k1_ratio(p, x)]
                 for n, k, p, x in zip(names, got, ref, exact)}
        extra = dict(
            tol_k1_ratio_vs_f64_kernel_plain=ratio,
            max_abs_vs_f64_kernel_plain={
                n: [(k.double() - x).abs().max().item(),
                    (p.double() - x).abs().max().item()]
                for n, k, p, x in zip(names, got, ref, exact)},
            mean_offdiag_cosine_e1=((e1 @ e1.T).sum().item() - N)
            / (N * (N - 1)), split_vs_f32=K1_SPLIT_VS_F32)
        checks.check(all(rk <= max(1.0, K1_SPLIT_VS_F32 * rp)
                         for rk, rp in ratio.values()),
                     f"{name}: K1 at {N} x {N} x {d} against f64, TOL_K1 "
                     f"ratio (kernel, plain) {ratio}")
        del exact
    else:
        checks.check(all(torch.allclose(a, b, rtol=TOL_K1, atol=TOL_K1)
                         for a, b in zip(got, ref)),
                     f"{name}: K1 at {N} x {N} x {d}, max abs err {k1_err}")
    del got, ref
    b_ms, b_by = gcl_bound("stats", N, N, d, "float32", True)
    k1 = dict(shape=[N, N, d], dtype="float32",
              ms=device_ms(lambda: GL.gcl_pair_stats(e1, e2, t, t)),
              kernel_only_ms=device_ms(lambda: GL.stats_merge(
                  GL.stats_partial(e1, e2, e1a, e2a, sd, v1, v2, 0), denom)),
              plain_ms=device_ms(lambda: GL.gcl_pair_stats_plain(
                  e1, e2, t, t), 20),
              bound_ms=b_ms, bound_by=b_by,
              tc_floor_ms=gcl_tc_floor("stats", N, N, d, "float32", True),
              max_abs_err=k1_err, launches=counts["gcl_pair_stats"],
              cuda_launches=counts["gcl_pair_stats_cuda"])
    emit(f"{name}_k1", **k1, **extra)
    return k1


def phase_eval(checks, ckpt, model):
    """The zero-shot eval engine at full width: the eval launcher on the
    clip checkpoint (K3 through both towers and the prompt head, K1
    through ``eval_loss``), its pieces timed and held to the plain paths;
    the planted known answers; the streaming top-k exact on quantized
    embeddings and within its memory contract at N = 50,000; K1 timed at
    the eval shape; planted serving under chaos with a corrupt reload.
    Returns the launch counts of the launcher's run and K1's eval-shape
    timings."""
    import numpy as np
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch.configs import get_arch
    from repro_torch.eval import classifier as CL
    from repro_torch.eval import engine as EN
    from repro_torch.eval import extraction as EX
    from repro_torch.eval import metrics as M
    from repro_torch.eval import planted as PL
    from repro_torch.eval import retrieval as RT
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gcl_loss as GL
    from repro_torch.launch import eval as EV
    from repro_torch.launch import serve_embed
    from repro_torch.models import clip as C

    cfg = get_arch(ARCH)
    N = EVAL_CLASSES * EVAL_PER_CLASS
    argv = ["--ckpt-dir", ckpt, "--arch", ARCH, "--impl", "flash",
            "--loss-impl", "fused", "--classes", str(EVAL_CLASSES),
            "--per-class", str(EVAL_PER_CLASS), "--batch-size",
            str(EVAL_BATCH), "--chunk", str(EVAL_CHUNK), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0
    GL.gcl_pair_stats.launches = GL.gcl_pair_stats.cuda_launches = 0
    t0 = time.monotonic()
    metrics = EV.main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = dict(flash_attention=FA.flash_attention.launches,
                  gcl_pair_stats=GL.gcl_pair_stats.launches,
                  gcl_pair_stats_cuda=GL.gcl_pair_stats.cuda_launches)
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.n_layers + cfg.clip.vision_layers
    n_prompts = len(EN.DEFAULT_TEMPLATES) * EVAL_CLASSES
    # both towers per extraction batch, and the text tower once over all
    # T x C prompts of the head
    want = dict(flash_attention=n_layers * -(-N // EVAL_BATCH)
                + cfg.n_layers, gcl_pair_stats=1, gcl_pair_stats_cuda=2)
    checks.check(counts == want, f"eval: launches {counts}, want {want}")
    checks.check(len(metrics) == 9 and all(
        math.isfinite(v) for v in metrics.values()),
        f"eval: metrics {metrics}")
    emit("eval_launcher", N=N, classes=EVAL_CLASSES,
         per_class=EVAL_PER_CLASS, batch=EVAL_BATCH, prompts=n_prompts,
         launches=counts, launches_want=want, metrics=metrics,
         wall_seconds=wall, max_memory_allocated=peak)

    # the pieces of one eval pass, timed, on the same params
    ds = EV.build_eval_dataset(argparse.Namespace(
        classes=EVAL_CLASSES, per_class=EVAL_PER_CLASS, flip_frac=0.0,
        seed=0), cfg)
    emb, pass_ms = {}, {}
    for impl in ("flash", "naive"):
        ms, emb[impl] = event_ms(lambda: EX.extract_pair_embeddings(
            lambda p, b: C.encode_pair(p, b, impl=impl), model, ds,
            batch_size=EVAL_BATCH, device="cuda"))
        pass_ms[f"extraction_{impl}"] = ms
    emb_err = max(float(np.abs(a - b).max())
                  for a, b in zip(emb["flash"], emb["naive"]))
    checks.check(emb_err <= TOL_EMBED["float32"],
                 f"eval: embeddings flash vs naive {emb_err}")
    e1, e2 = (torch.from_numpy(e).to("cuda") for e in emb["flash"])
    pass_ms["head"], head = event_ms(lambda: CL.build_head(
        lambda toks: C.encode_text(model, toks, impl="flash"), ds.tok_base,
        context_length=ds.context_length, device="cuda"))
    with torch.inference_mode():
        pass_ms["zero_shot"], zs = event_ms(
            lambda: CL.zero_shot_metrics(e1, head, ds.labels))
        pass_ms["retrieval"], rec = event_ms(
            lambda: RT.retrieval_recalls(e1, e2, chunk=EVAL_CHUNK))
        pass_ms["loss_fused"], loss_f = event_ms(
            lambda: M.contrastive_eval_loss(e1, e2, loss_impl="fused"))
        pass_ms["loss_dense"], loss_d = event_ms(
            lambda: M.contrastive_eval_loss(e1, e2, loss_impl="dense"))
    loss_f, loss_d = float(loss_f), float(loss_d)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    checks.check(loss_rel <= TOL_K1 and abs(
        metrics["eval_loss"] - loss_f) <= TOL_K1 * abs(loss_f),
        f"eval: eval_loss fused {loss_f} vs dense {loss_d} (rel "
        f"{loss_rel}), launcher {metrics['eval_loss']}")
    # the launcher's rank metrics are those of the pieces, which are held
    # to the plain paths
    same = {k: float(v) for k, v in {**zs, **rec}.items()}
    pieces_equal = all(same[k] == metrics[k] for k in same)
    checks.check(pieces_equal, f"eval: launcher {metrics} vs pieces {same}")
    topk = _eval_topk_vs_dense(checks, e1, e2)
    emit("eval_pass", N=N, pass_ms=pass_ms,
         pass_ms_total=sum(v for k, v in pass_ms.items()
                           if k not in ("extraction_naive", "loss_dense")),
         embeddings_flash_vs_naive_max_abs=emb_err,
         tol=TOL_EMBED["float32"], eval_loss_fused=loss_f,
         eval_loss_dense=loss_d, eval_loss_rel=loss_rel, rtol=TOL_K1,
         pieces_equal_launcher=pieces_equal,
         topk_vs_dense=topk, score_tol=EVAL_TOPK_SCORE_TOL)

    # K1 at the eval shape (square N x N x 512), kernel vs plain version
    k1 = _eval_k1(checks, "eval", e1, e2, counts)

    # exactness: the planted known answers at 192 x 16 through the
    # launcher (K1 for eval_loss); streaming == dense bitwise on
    # quantized embeddings; the stable sort's signed zeros
    pdir = tempfile.mkdtemp(prefix="chip_smoke_planted_")
    try:
        pm = EV.main(["--planted", "--ckpt-dir", pdir, "--classes",
                      str(EVAL_CLASSES), "--per-class", str(EVAL_PER_CLASS),
                      "--batch-size", str(EVAL_BATCH), "--loss-impl",
                      "fused", "--expect-known-answers", "--device", "cuda"])
    except SystemExit as e:
        pm = None
        checks.check(False, f"eval: planted known answers: exit {e.code}")
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
    want_pm = PL.known_answers(ds)
    if pm is not None:
        checks.check(all(pm[k] == v for k, v in want_pm.items()),
                     f"eval: planted {pm} vs known answers {want_pm}")
    q1, q2 = quantized_emb(N, 512, 0), quantized_emb(N, 512, 1)
    q2[10:13] = q2[3:6]                           # exact ties
    ds_, di_ = M.lex_topk(q1 @ q2.T, 10)
    stream_exact = {}
    for chunk in (1024, 512, 100):
        s_, i_ = RT.streaming_topk(q1, q2, 10, chunk=chunk)
        stream_exact[chunk] = bool(torch.equal(i_, di_)
                                   and _bits_equal(s_, ds_))
    checks.check(all(stream_exact.values()),
                 f"eval: streaming vs dense on quantized {stream_exact}")
    zeros_ok = {}
    for w, row in _signed_zero_rows().items():
        _, i_cpu = M.lex_topk(row, w)
        _, i_gpu = M.lex_topk(row.to("cuda"), w)
        zeros_ok[w] = bool(torch.equal(i_gpu.cpu(), i_cpu))
    checks.check(all(zeros_ok.values()),
                 f"eval: stable sort signed zeros {zeros_ok}")
    emit("eval_exact", planted=pm, known_answers=want_pm,
         streaming_equals_dense_bitwise=stream_exact,
         signed_zero_rows_in_input_order=zeros_ok)
    del q1, q2, ds_, di_

    # the memory contract at a real eval scale
    r1 = quantized_emb(RETRIEVAL_N, 512, 2)
    r2 = quantized_emb(RETRIEVAL_N, 512, 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_dir = {}
    with torch.inference_mode():
        ms_dir["i2t"], (s1, i1) = event_ms(lambda: RT.streaming_topk(
            r1, r2, RETRIEVAL_K, chunk=RETRIEVAL_CHUNK))
        ms_dir["t2i"], _ = event_ms(lambda: RT.streaming_topk(
            r2, r1, RETRIEVAL_K, chunk=RETRIEVAL_CHUNK))
    extra = torch.cuda.max_memory_allocated() - base
    sample = slice(0, 256)
    ds_, di_ = M.lex_topk(r1[sample] @ r2.T, RETRIEVAL_K)
    rows_exact = bool(torch.equal(i1[sample], di_)
                      and _bits_equal(s1[sample], ds_))
    checks.check(extra < RETRIEVAL_EXTRA_BYTES_MAX and rows_exact,
                 f"eval: retrieval at N={RETRIEVAL_N}: peak extra {extra} "
                 f"bytes, first rows exact {rows_exact}")
    emit("eval_memory", N=RETRIEVAL_N, d=512, k=RETRIEVAL_K,
         chunk=RETRIEVAL_CHUNK, peak_extra_bytes=extra,
         limit_bytes=RETRIEVAL_EXTRA_BYTES_MAX,
         dense_NN_f32_bytes=4 * RETRIEVAL_N ** 2, ms=ms_dir,
         first_256_rows_equal_dense=rows_exact)
    del r1, r2, s1, i1

    # planted serving under chaos: step 0 serves, a step-1 candidate is
    # corrupted on the watcher's first attempt (a random projection: an
    # incompressible array fills the middle of the npz, where the fault
    # flips a byte, and its answers would differ from step 0's)
    sdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        sds = EV.build_eval_dataset(argparse.Namespace(
            classes=16, per_class=1, flip_frac=0.0, seed=0))
        PL.make_planted_checkpoint(sdir, sds)
        params0 = PL.planted_params(sds, "cuda")
        proj = np.random.RandomState(4).randn(PL.LATENT, PL.LATENT).astype(
            np.float32)
        CK.save(sdir, dict(PL.planted_params(sds, "cpu"), img_proj=proj), 1)
        record = []
        stats = serve_embed.main(
            ["--planted", "--ckpt-dir", sdir, "--step", "0", "--classes",
             "16", "--per-class", "1", "--payload-pool", "16", "--requests",
             "128", "--offered-rate", "400", "--deadline-ms", "2000",
             "--watch-ckpt", "0.02", "--chaos", SERVE_CHAOS, "--device",
             "cuda"], record=record)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    exact = [res.embedding.tobytes() == _planted_solo(params0, pay)
             for pay, res in record]
    client = stats["client"]
    checks.check(stats["dropped"] == 0 and client["completed"] > 0
                 and len(record) == client["completed"] and all(exact)
                 and all(res.params_step == 0 for _, res in record),
                 f"eval serve: dropped {stats['dropped']}, "
                 f"{sum(exact)} of {len(record)} exact")
    checks.check(stats["reload_rejected"] == 1 and stats["reloads"] == 0
                 and stats["params_step"] == 0 and stats["retries"] >= 1,
                 f"eval serve: reloads {stats['reloads']}, rejected "
                 f"{stats['reload_rejected']}, retries {stats['retries']}")
    emit("eval_serve_chaos", chaos=SERVE_CHAOS, client=client,
         dropped=stats["dropped"], retries=stats["retries"],
         cache_corrupt=stats["cache_corrupt"],
         served_cache=stats["served_cache"],
         reload_rejected=stats["reload_rejected"], reloads=stats["reloads"],
         params_step=stats["params_step"],
         completed_bitwise_solo=sum(exact))
    checks.end_phase("eval")
    return counts, k1


def _planted_solo(params, payload):
    import torch
    from repro_torch.core import losses as LS
    from repro_torch.eval import planted as PL
    x = torch.from_numpy(payload["images"][None]).to("cuda")
    with torch.inference_mode():
        return LS.l2_normalize(PL.encode_image(params, x))[0].cpu().numpy(
        ).tobytes()


def phase_attn_grad(checks):
    """dq, dk, dv through ``flash_mha`` (the kernel forward, the chunked
    recompute backward) vs autograd of the naive attention, f32."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.attention import naive_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    # the towers' training shapes, and the vlm's cross blocks (4096
    # queries over 1024 image tokens, 32 heads at hd 128) with the batch
    # cut to 1 so that the naive attention's scores fit and the case
    # runs in well under a second
    for tower, B, S, Sk, H, hd, causal in (
            ("vit", 8, 50, 50, 12, 64, False),
            ("text", 8, 77, 77, 8, 64, True),
            ("vlm_cross", 1, 4096, 1024, 32, 128, False)):
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                        requires_grad=True)
        k, v = (torch.randn((B, Sk, H, hd), generator=gen, device="cuda",
                            requires_grad=True) for _ in range(2))
        ct = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        before = FA.flash_attention.launches
        got = torch.autograd.grad(FA.flash_mha(q, k, v, causal=causal),
                                  (q, k, v), ct)
        launched = FA.flash_attention.launches - before
        want = torch.autograd.grad(naive_attention(q, k, v, causal=causal),
                                   (q, k, v), ct)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        ok = checks.check(
            launched == 1 and all(math.isfinite(e) and e <= TOL_ATTN_GRAD
                                  for e in errs),
            f"attn grad {tower}: max abs err dq/dk/dv {errs}, "
            f"{launched} launches")
        emit("attn_grad", tower=tower, shape=[B, S, Sk, H, hd],
             causal=causal, max_abs_err_dq_dk_dv=errs, tol=TOL_ATTN_GRAD,
             forward_launches=launched, seconds=seconds, ok=ok)
        del q, k, v, ct, got, want
    checks.end_phase("attn_grad")


# name, b (anchor rows), B (columns), d, row_offset, dtype, tau, clamp
# row, timed.  Timed: the training shape and the paper's sharded shape
# (global batch 2048 on 8 cards: 256 local anchors against 2048 gathered
# columns; this card's rows start at 768).  "d37": rows that are not
# 16-byte aligned, and at b = B = 33 a last column split (32 columns per
# split) that holds only row 32's own column, all masked for it
GCL_CASES = [
    ("main", 256, 256, 512, 0, "float32", 0.07, False, True),
    ("main_bf16", 256, 256, 512, 0, "bfloat16", 0.07, False, True),
    ("rect_paper", 256, 2048, 512, 768, "float32", 0.07, False, True),
    ("rect_paper_bf16", 256, 2048, 512, 768, "bfloat16", 0.07, False, True),
    # clip-rn50-cc3m's training shape: embed_dim 1024; and its rank's
    # shape on data:1,fsdp:2 (phase clip_family): 128 rows against the 256
    # gathered columns at each row offset
    ("rn50", 256, 256, 1024, 0, "float32", 0.07, False, True),
    ("rn50_rank0", 128, 256, 1024, 0, "float32", 0.07, False, True),
    ("rn50_rank1", 128, 256, 1024, 128, "float32", 0.07, False, True),
    # the LM backbones' contrastive training (phases hybrid_train and
    # dense_train): batch 64, CONTRASTIVE_DIM 512; and qwen3-1.7b's ranks
    # on data:1,fsdp:2 (phase dense_train): 32 rows against the 64
    # gathered columns at each row offset
    ("hybrid_ctr", 64, 64, 512, 0, "float32", 0.07, False, True),
    ("qwen3_mesh_rank0", 32, 64, 512, 0, "float32", 0.07, False, True),
    ("qwen3_mesh_rank1", 32, 64, 512, 32, "float32", 0.07, False, True),
    ("ragged", 200, 200, 128, 0, "float32", 0.05, False, False),
    ("rect", 64, 256, 512, 128, "float32", 0.07, False, False),
    ("d37", 33, 33, 37, 0, "float32", 0.07, False, False),
    ("d3072", 256, 256, 3072, 0, "float32", 0.07, False, False),
    ("tau_rows_0.01", 256, 256, 512, 0, "float32", None, False, False),
    ("clamp_row", 256, 256, 512, 0, "float32", 0.07, True, False),
]


def gcl_flops(kernel, b, B, d, square):
    """The FLOPs of the products one call needs: the similarities s1 and
    s2 (one product in the square case, where s2 = s1^T; the kernels
    compute both), and in K2 the two products P.e (de1, de2)."""
    sims = (1 if square else 2) * 2 * b * B * d
    return sims if kernel == "stats" else sims + 2 * 2 * b * B * d


def gcl_bound(kernel, b, B, d, dt_name, square):
    """(ms, "bytes" | "operations") for one call at this shape: each
    input read once (the columns are the rows in the square case), each
    output written once, against the products' FLOPs at the peak rate of
    the input type (f32 outside the tensor cores, bf16 on them)."""
    item = 4 if dt_name == "float32" else 2
    feats = item * d * (2 * b + (0 if square else 2 * B))
    if kernel == "stats":
        nbytes = feats + 4 * 3 * b + 4 * 6 * b     # sd, t1, t2 -> 6 stats
    else:
        vec_in = 4 * (5 * b + (0 if square else 5 * B))
        nbytes = feats + vec_in + 4 * 2 * b * d    # -> de1, de2
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = gcl_flops(kernel, b, B, d, square) / PEAK_FLOPS[dt_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gcl_tc_floor(kernel, b, B, d, dt_name, square):
    """The floor of the products one call needs (``gcl_flops``) on the
    tensor cores in the kernels' arithmetic: the similarities as three
    TF32 products per f32 product (split TF32) or one for bf16 inputs
    (exact in TF32), at the TF32 peak; K2's products P.e in f32 on the
    f64 tensor cores, in bf16 as one TF32 product."""
    sims = gcl_flops("stats", b, B, d, square)
    f32 = dt_name == "float32"
    ms = (3 if f32 else 1) * sims / PEAK_TF32
    if kernel == "grads":
        ms += (gcl_flops("grads", b, B, d, square) - sims) / (
            PEAK_F64_TC if f32 else PEAK_TF32)
    return ms * 1e3


def _grads_tol_ratio_vs_f64(GL, got, e1, e2, l1, l2, t1, t2, kw2):
    """max |x - ref| / (atol + rtol |ref|) of K2's outputs ``got`` at the
    K2 tolerance, ref = the plain version's arithmetic on its own f32
    weights, in f64 (a measurement: where a row's weights clamp, the
    finish cancels to ~1e-4 of its terms and f32 rounding shows)."""
    args, kappa = GL._grads_args(e1, e2, l1, l2, t1, t2, *(kw2.get(k) for k in (
        "e1_all", "e2_all", "sd_all", "lwt1_all", "lwt2_all", "tau1_all",
        "tau2_all")))
    a1, a2, m1, m2 = GL._pair_weights(e1, e2, *args, kw2.get("row_offset", 0))
    rs = (a1.double().sum(dim=1) + a2.double().sum(dim=1))[:, None]
    ref = [kappa * ((a + m).to(e1.dtype).double() @ ea.double()
                    - rs * e.double())
           for a, m, ea, e in ((a1, m2, args[1], e2), (a2, m1, args[0], e1))]
    return max((((x.double() - w).abs()) / (TOL_K2[1] + TOL_K2[0] * w.abs()))
               .max().item() for x, w in zip(got, ref))


def _gcl_timings(GL, e1, e2, kw1, kw2, l1, l2, t1, t2, k1, k2, p1, p2):
    """Device ms of K1 and K2 through the public functions, their launches
    alone (the wrapper's torch ops, s_ii and the tau vectors, made
    beforehand), each pass, and the plain versions."""
    e1a, e2a, sd, v1, v2, denom = GL._stats_args(
        e1, e2, t1, t2, kw1.get("e1_all"), kw1.get("e2_all"))
    off = kw1.get("row_offset", 0)
    args, kappa = GL._grads_args(
        e1, e2, l1, l2, t1, t2, *(kw2.get(k) for k in (
            "e1_all", "e2_all", "sd_all", "lwt1_all", "lwt2_all",
            "tau1_all", "tau2_all")))
    part = GL.stats_partial(e1, e2, e1a, e2a, sd, v1, v2, off)
    pw, r = GL.grads_weights(e1, e2, *args, off)
    pass_ms = {
        "stats_partial": device_ms(lambda: GL.stats_partial(
            e1, e2, e1a, e2a, sd, v1, v2, off)),
        "stats_merge": device_ms(lambda: GL.stats_merge(part, denom)),
        "grads_weights": device_ms(lambda: GL.grads_weights(
            e1, e2, *args, off)),
        "grads_product": device_ms(lambda: GL.grads_product(
            pw, args[0], args[1], e1, e2, r, kappa))}

    def stats_only():
        return GL.stats_merge(GL.stats_partial(e1, e2, e1a, e2a, sd, v1, v2,
                                               off), denom)

    def grads_only():
        w, rr = GL.grads_weights(e1, e2, *args, off)
        return GL.grads_product(w, args[0], args[1], e1, e2, rr, kappa)

    kernel_only = {"stats": device_ms(stats_only),
                   "grads": device_ms(grads_only)}
    return {"stats": dict(ms=device_ms(k1), kernel_only_ms=kernel_only[
                "stats"], plain_ms=device_ms(p1)),
            "grads": dict(ms=device_ms(k2), kernel_only_ms=kernel_only[
                "grads"], plain_ms=device_ms(p2)),
            "pass_ms": pass_ms}


def _gcl_case(checks, gen, case, timings, phase="gcl"):
    """One case of K1 / K2 against their plain versions (and, for a timed
    case, their timings into ``timings``); emits its line."""
    import torch
    from repro_torch.kernels import gcl_loss as GL
    name, b, B, d, off, dt_name, tau, clamp, timed = case
    dt = getattr(torch, dt_name)

    def norm(x):
        return (x / x.norm(dim=-1, keepdim=True)).to(dt).contiguous()
    e1a, e2a = (norm(torch.randn((B, d), generator=gen, device="cuda"))
                for _ in range(2))
    if tau is None:
        ta = 0.01 + 0.06 * torch.rand((2, B), generator=gen,
                                      device="cuda")
        ta[:, ::3] = 0.01
    else:
        ta = torch.full((2, B), tau, device="cuda")
    # lwt = -log(eps + u) with u tracking g (as in the loss op), times
    # a random factor in [0.2, 1.2): the backward exponents stay below
    # log(B / 0.2), as on the training path
    g1, g2, _, _, m1, m2 = GL.gcl_pair_stats_plain(e1a, e2a, ta[0],
                                                    ta[1])
    lwta = torch.stack([-(m1 + torch.log(g1)), -(m2 + torch.log(g2))]) \
        + torch.log(torch.rand((2, B), generator=gen, device="cuda")
                    + 0.2)
    if clamp:
        lwta[0, off] = 80.0      # exp(min(z + lwt, 60)) clamps here
    sl = slice(off, off + b)
    e1, e2 = e1a[sl].contiguous(), e2a[sl].contiguous()
    t1, t2, l1, l2 = ta[0, sl], ta[1, sl], lwta[0, sl], lwta[1, sl]
    kw1, kw2 = {}, {}
    if b < B:
        sda = torch.sum(e1a.float() * e2a.float(), dim=-1)
        kw1 = dict(e1_all=e1a, e2_all=e2a, row_offset=off)
        kw2 = dict(kw1, sd_all=sda, lwt1_all=lwta[0], lwt2_all=lwta[1],
                   tau1_all=ta[0], tau2_all=ta[1])

    def k1():
        return GL.gcl_pair_stats(e1, e2, t1, t2, **kw1)

    def p1():
        return GL.gcl_pair_stats_plain(e1, e2, t1, t2, **kw1)

    def k2():
        return GL.gcl_pair_grads(e1, e2, l1, l2, t1, t2, **kw2)

    def p2():
        return GL.gcl_pair_grads_plain(e1, e2, l1, l2, t1, t2, **kw2)

    s_k, s_p, g_k, g_p = k1(), p1(), k2(), p2()
    s_k2, g_k2 = k1(), k2()          # no atomics: the same bits again
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, w) for a, w in zip(
        [*s_k, *g_k], [*s_k2, *g_k2]))
    if dt_name == "float32":
        err1 = max((a - w).abs().max().item() for a, w in zip(s_k, s_p))
        ok1 = all(torch.allclose(a, w, rtol=TOL_K1, atol=TOL_K1)
                  for a, w in zip(s_k, s_p))
    else:      # bf16: log g = m + log(g), as tests/test_kernels.py
        err1 = max((s_k[4 + i] + torch.log(s_k[i]) - s_p[4 + i]
                    - torch.log(s_p[i])).abs().max().item()
                   for i in (0, 1))
        ok1 = err1 <= TOL_K1_LOG_BF16
    err2 = max((a - w).abs().max().item() for a, w in zip(g_k, g_p))
    ok2 = all(bool(torch.isfinite(a).all())
              and torch.allclose(a, w, rtol=TOL_K2[0], atol=TOL_K2[1])
              for a, w in zip(g_k, g_p))
    checks.check(ok1 and math.isfinite(err1),
                 f"gcl_pair_stats {name}: max abs err {err1}")
    checks.check(ok2, f"gcl_pair_grads {name}: max abs err {err2}")
    checks.check(bitwise, f"gcl {name}: two calls differ")
    rec = dict(case=name, b=b, B=B, d=d, row_offset=off, dtype=dt_name,
               tau=tau if tau is not None else "rows 0.01..0.07",
               clamp_row=clamp, stats_max_abs_err=err1, stats_ok=ok1,
               grads_max_abs_err=err2, grads_ok=ok2,
               bitwise_deterministic=bitwise)
    if clamp:
        rec["grads_tol_ratio_vs_f64"] = {
            "kernel": _grads_tol_ratio_vs_f64(GL, g_k, e1, e2, l1, l2, t1,
                                              t2, kw2),
            "plain": _grads_tol_ratio_vs_f64(GL, g_p, e1, e2, l1, l2, t1,
                                             t2, kw2)}
    if timed:
        t = _gcl_timings(GL, e1, e2, kw1, kw2, l1, l2, t1, t2, k1, k2,
                         p1, p2)
        rec["pass_ms"] = t["pass_ms"]
        for kernel, err in (("stats", err1), ("grads", err2)):
            b_ms, b_by = gcl_bound(kernel, b, B, d, dt_name, b == B)
            tk = dict(t[kernel], shape=[b, B, d], dtype=dt_name,
                      row_offset=off, max_abs_err=err, bound_ms=b_ms,
                      bound_by=b_by, tc_floor_ms=gcl_tc_floor(
                          kernel, b, B, d, dt_name, b == B))
            timings[name, kernel] = tk
            rec.update({f"{kernel}_{k}": v for k, v in tk.items()
                        if k not in ("shape", "dtype", "row_offset",
                                     "max_abs_err")})
    emit(phase, **rec)


def phase_gcl(checks):
    """K1 / K2 vs their plain versions; returns {(case, kernel): timing
    dict} for the timed cases."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    timings = {}
    for case in GCL_CASES:
        _gcl_case(checks, gen, case, timings)
    checks.end_phase("gcl")
    return timings


# name, B, T, H, P, N, chunk, B/C dtype, dt bias (dt = softplus(z + bias));
# "main" marks zamba2-1.2b's shapes (timed): the prefill and the LM step
# at 2 x 4096, the contrastive step at 64 x 256 (phase hybrid_train)
SSD_CASES = [
    ("prefill", 2, 4096, 64, 64, 64, 256, "float32", -2.0, True),
    ("prefill_bf16", 2, 4096, 64, 64, 64, 256, "bfloat16", -2.0, True),
    ("hybrid_ctr", 64, 256, 64, 64, 64, 256, "float32", -2.0, True),
    ("ragged", 2, 4000, 64, 64, 64, 256, "float32", -2.0, False),
    ("short", 2, 100, 64, 64, 64, 256, "float32", -2.0, False),
    ("chunk64", 2, 4096, 64, 64, 64, 64, "float32", -2.0, False),
    # dt ~ 8..10: F reaches ~ -2500 over a chunk, where the ratio form
    # exp(F_i) / exp(F_j) would be 0/0
    ("large_decay", 2, 1024, 64, 64, 64, 256, "float32", 8.0, False),
    ("reduced", 2, 50, 16, 32, 16, 16, "float32", -2.0, False),
    ("reduced_bf16", 2, 50, 16, 32, 16, 16, "bfloat16", -2.0, False),
    ("jax_test", 2, 60, 3, 8, 4, 16, "float32", 0.0, False),
]


def ssd_flops(B, T, H, P, N, Lc):
    """The FLOPs the chunked algorithm needs for these T rows: per chunk
    of r rows, C B^T over the r(r+1)/2 causal pairs once per (batch,
    chunk), and per (batch, head) the masked M x product, the
    inter-chunk C S and the state update."""
    flops = 0
    for t0 in range(0, T, Lc):
        r = min(Lc, T - t0)
        pairs = r * (r + 1) // 2
        flops += B * pairs * N * 2
        flops += B * H * (pairs * P * 2 + 2 * r * N * P * 2)
    return flops


def ssd_bound(B, T, H, P, N, Lc, bc_item):
    """(ms, "bytes" | "operations") for one K4 call: x, log_a, B, C read
    once and y written once, against ``ssd_flops`` at the f32 peak (the
    kernel computes in f32 for any B/C type)."""
    flops = ssd_flops(B, T, H, P, N, Lc)
    nbytes = 4 * (2 * B * T * H * P + B * T * H) + 2 * B * T * N * bc_item
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ssd_passes(checks, case, x, la, Bm, Cm, Lc):
    """Each of K4's four passes against its plain version on the same
    inputs (the kernel's outputs of the earlier passes), and its device
    time.  Returns ({output: max abs err}, {pass: ms})."""
    import torch
    from repro_torch.kernels import ssd_chunk as K4
    G = K4.ssd_chunk_cb(Bm, Cm, Lc)
    cum, S = K4.ssd_chunk_state(x, la, Bm, Lc)
    S_in = K4.ssd_state_pass(cum, S.clone(), Lc)
    y = K4.ssd_chunk_scan(x, Cm, G, cum, S_in, Lc)
    want = {"cb": K4.ssd_chunk_cb_plain(Bm, Cm, Lc)}
    want["cum"], want["state"] = K4.ssd_chunk_state_plain(x, la, Bm, Lc)
    want["state_pass"] = K4.ssd_state_pass_plain(cum, S, Lc)
    want["scan"] = K4.ssd_chunk_scan_plain(x, Cm, G, cum, S_in, Lc)
    # the tiles of G above the diagonal are not written
    got = dict(cb=torch.tril(G), cum=cum, state=S, state_pass=S_in, scan=y)
    torch.cuda.synchronize()
    errs = {}
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        checks.check(bool(torch.isfinite(got[k]).all())
                     and got[k].shape == w.shape and err <= TOL_SSD * scale,
                     f"ssd {case} pass output {k}: max abs err {err} (tol "
                     f"{TOL_SSD} x {scale})")
        errs[k] = err
    del want, got
    S_work = S.clone()      # the state pass works in place
    times = dict(
        cb=device_ms(lambda: K4.ssd_chunk_cb(Bm, Cm, Lc), 20),
        state=device_ms(lambda: K4.ssd_chunk_state(x, la, Bm, Lc), 20),
        state_pass=device_ms(lambda: K4.ssd_state_pass(cum, S_work, Lc), 20),
        scan=device_ms(lambda: K4.ssd_chunk_scan(x, Cm, G, cum, S_in, Lc),
                       20))
    return errs, times


def phase_ssd(checks):
    """K4 vs its plain version; returns {case: timing dict} for the
    timed shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_chunk as K4
    gen = torch.Generator(device="cuda").manual_seed(3)
    timings = {}
    for name, B, T, H, P, N, chunk, dt_name, dt_bias, main in SSD_CASES:
        dt_bc = getattr(torch, dt_name)
        dt = F.softplus(torch.randn((B, T, H), generator=gen, device="cuda")
                        + dt_bias)
        x = torch.randn((B, T, H, P), generator=gen,
                        device="cuda") * dt[..., None]
        la = -dt
        # B and C as strided views of one buffer, as the model passes them
        bc = (torch.randn((B, T, 2 * N), generator=gen, device="cuda")
              * 0.5).to(dt_bc)
        Bm, Cm = bc[..., :N], bc[..., N:]
        y = K4.ssd_chunk(x, la, Bm, Cm, chunk=chunk)
        ref = K4.ssd_chunk_plain(x, la, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        ok = checks.check(
            y.dtype == torch.float32 and bool(torch.isfinite(y).all())
            and math.isfinite(err) and err <= TOL_SSD * scale,
            f"ssd_chunk {name}: max abs err {err} (tol {TOL_SSD} x {scale})")
        rec = dict(case=name, shape=[B, T, H, P], N=N, chunk=chunk,
                   bc_dtype=dt_name, dt_bias=dt_bias,
                   log_a_min=la.min().item(), max_abs_err=err,
                   max_abs_y=scale, tol=TOL_SSD * scale, ok=ok)
        if main:
            # a measurement only: kernel and plain version against the
            # same scan in f64, to tell which rounds closer to exact
            ref64 = K4.ssd_chunk_plain(x.double(), la.double(), Bm.double(),
                                       Cm.double(), chunk=chunk)
            rec.update(kernel_vs_f64_max_abs=(y.double() - ref64).abs().max(
            ).item(), plain_vs_f64_max_abs=(ref.double() - ref64).abs().max(
            ).item())
            del ref64
            Lc = min(chunk, T)
            pass_errs, pass_ms = _ssd_passes(checks, name, x, la, Bm, Cm, Lc)
            ms = device_ms(lambda: K4.ssd_chunk(x, la, Bm, Cm, chunk=chunk),
                           20)
            plain_ms = device_ms(lambda: K4.ssd_chunk_plain(
                x, la, Bm, Cm, chunk=chunk), 10)
            b_ms, b_by = ssd_bound(B, T, H, P, N, Lc, bc.element_size())
            tc_ms = 3 * ssd_flops(B, T, H, P, N, Lc) / PEAK_TF32 * 1e3
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       tc_floor_ms=tc_ms, pass_max_abs_err=pass_errs,
                       pass_ms=pass_ms, library_ms=None)
            timings[name] = dict(rec)
        emit("ssd", **rec)
        del x, la, bc, Bm, Cm, y, ref
    checks.end_phase("ssd")
    return timings


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def phase_ssd_grad(checks):
    """K4's gradients: per input against autograd of the plain scan, and
    per leaf of a reduced hybrid LM through the kernels against the plain
    path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_chunk as K4
    from repro_torch.models import backbones as BB
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dt_name in ("float32", "bfloat16"):
        B, T, H, P, N, chunk = 2, 1024, 16, 64, 64, 256
        dt = F.softplus(torch.randn((B, T, H), generator=gen, device="cuda")
                        - 2.0)
        bc = torch.randn((B, T, 2 * N), generator=gen, device="cuda") * 0.5
        ins = [(torch.randn((B, T, H, P), generator=gen, device="cuda")
                * dt[..., None]), -dt, bc[..., :N], bc[..., N:]]
        ins = [t.to(getattr(torch, dt_name)) if i >= 2 else t
               for i, t in enumerate(ins)]
        ins = [t.detach().contiguous().requires_grad_(True) for t in ins]
        gy = torch.randn((B, T, H, P), generator=gen, device="cuda")
        K4.ssd_chunk.launches = K4.ssd_chunk.cuda_launches = 0
        got = torch.autograd.grad(K4.ssd_chunk(*ins, chunk=chunk), ins, gy)
        launches = (K4.ssd_chunk.launches, K4.ssd_chunk.cuda_launches)
        want = torch.autograd.grad(K4.ssd_scan_plain(*ins, chunk=chunk)[0],
                                   ins, gy)
        torch.cuda.synchronize()
        rel = {n: _rel_l2(a, w) for n, a, w in zip(("x", "log_a", "B", "C"),
                                                   got, want)}
        dtypes_ok = all(a.dtype == w.dtype for a, w in zip(got, want))
        ok = checks.check(
            launches == (1, 4) and dtypes_ok and all(
                math.isfinite(v) and v <= TOL_SSD_GRAD for v in rel.values()),
            f"ssd_grad {dt_name}: rel L2 {rel}, launches {launches}")
        emit("ssd_grad", shape=[B, T, H, P], N=N, chunk=chunk,
             bc_dtype=dt_name, rel_l2=rel, tol=TOL_SSD_GRAD,
             launches_call_cuda=list(launches), ok=ok)
        del ins, got, want, gy
    # a reduced zamba2 forward + backward, kernels vs plain path
    cfg = get_arch(HYBRID_ARCH).reduced()
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device="cuda")
    ct, grads, counts = None, {}, {}
    for impl in ("flash", "chunked"):
        model.zero_grad(set_to_none=True)
        K4.ssd_chunk.launches = 0
        x, _ = BB.forward_hidden(model, cfg, {"tokens": tokens}, impl=impl)
        if ct is None:
            ct = torch.randn(x.shape, generator=gen, device="cuda")
        (x * ct).sum().backward()
        counts[impl] = K4.ssd_chunk.launches
        grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}
    torch.cuda.synchronize()
    rel = {n: _rel_l2(grads["flash"][n], w)
           for n, w in grads["chunked"].items()}
    worst = max(rel, key=rel.get)
    # under grad each layer runs K4 twice: forward and its recompute
    checks.check(grads["flash"].keys() == grads["chunked"].keys()
                 and counts == dict(flash=2 * cfg.n_layers, chunked=0)
                 and all(math.isfinite(v) and v <= TOL_SSD_GRAD
                         for v in rel.values()),
                 f"ssd_grad hybrid: worst leaf {worst} rel L2 {rel[worst]}, "
                 f"K4 calls {counts}")
    emit("ssd_grad_hybrid", arch=HYBRID_ARCH, reduced=True,
         n_layers=cfg.n_layers, tokens=list(tokens.shape), leaves=len(rel),
         k4_calls=counts, worst_leaf=worst, worst_rel_l2=rel[worst],
         tol=TOL_SSD_GRAD)
    del model, grads
    torch.cuda.empty_cache()
    checks.end_phase("ssd_grad")


def _device_rows(prof):
    """[(kernel name, device ms, launches)] straight from the profiler's
    device events (``key_averages`` builds an object per event, host
    and device, which takes seconds per 10,000 events); None where this
    torch does not expose them."""
    try:
        import torch
        cuda = torch._C._autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        agg = {}
        for e in events:
            # the enum, not its name: ~2.5 us an event less, 400,000
            # events in an xLSTM step
            if e.device_type() != cuda:
                continue
            t, n = agg.get(e.name(), (0.0, 0))
            agg[e.name()] = (t + e.duration_ns() / 1e6, n + 1)
    except (AttributeError, RuntimeError, TypeError):
        return None
    return [(k, t, n) for k, (t, n) in agg.items()] or None


def _profile(fn, match=None, categories=(), host_ops=True):
    """torch.profiler over one call: device time by kernel, launches and
    the device's idle share of the call's wall time; with ``match``, also
    every kernel whose name holds that string; with ``categories``
    (``(name, substrings)`` pairs), the device ms and launches of each,
    a kernel counted in the first whose substring its name holds, the
    rest under ``other``.  ``host_ops=False`` records the card's activity
    only: a full-width zamba2 training step runs ~80,000 kernels, and
    its host operators took about a minute to summarise."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    rows = None if host_ops else _device_rows(prof)
    kernels = True
    if rows is None:
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        # device-side events only (the kernels), so no time counts twice
        kernels = [e for e in events
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in (kernels or events)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = dict(wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=max(0.0, 1.0 - busy / wall_ms), kernels=len(rows),
               launches=sum(r[2] for r in rows),
               device_events_only=bool(kernels),
               top=[[k[:80], t, c] for k, t, c in rows[:15]])
    if match:
        out["matched"] = [[k[:80], t, c] for k, t, c in rows if match in k]
    if categories:
        cat = {name: [0.0, 0] for name, _ in categories}
        cat["other"] = [0.0, 0]
        for key, t, c in rows:
            name = next((n for n, subs in categories
                         if any(x in key for x in subs)), "other")
            cat[name][0] += t
            cat[name][1] += c
        out["by_category_ms_launches"] = cat
    return out


def phase_hybrid(checks):
    """Full-width zamba2-1.2b prefill and decode through the port's entry
    points; returns the kernels' launch counts in one prefill."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_chunk as K4
    from repro_torch.launch import serve, steps
    from repro_torch.models import backbones as BB

    cfg = get_arch(HYBRID_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    model = BB.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("hybrid_params", arch=HYBRID_ARCH, n_params=n_params,
         n_layers=cfg.n_layers, init_seconds=time.monotonic() - t0,
         param_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()))
    B, S = 2, 4096
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    prefill = {impl: steps.make_prefill_step(cfg, impl=impl)
               for impl in ("flash", "chunked", "naive")}
    prefill["flash"](model, batch)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K4.ssd_chunk.launches = 0
    K4.ssd_chunk.cuda_launches = 0
    FA.flash_attention.launches = 0
    t0 = time.monotonic()
    logits = prefill["flash"](model, batch)
    torch.cuda.synchronize()
    ms_flash = (time.monotonic() - t0) * 1e3
    counts = dict(ssd_chunk=K4.ssd_chunk.launches,
                  flash_attention=FA.flash_attention.launches)
    ssd_cuda_launches = K4.ssd_chunk.cuda_launches
    peak = torch.cuda.max_memory_allocated()
    n_super = cfg.n_layers // cfg.hybrid_attn_every
    want = dict(ssd_chunk=cfg.n_layers, flash_attention=n_super)
    checks.check(counts == want,
                 f"hybrid prefill: launches {counts}, want {want}")
    checks.check(ssd_cuda_launches == 4 * cfg.n_layers,
                 f"hybrid prefill: {ssd_cuda_launches} K4 CUDA launches, "
                 f"want 4 per Mamba2 layer")
    checks.check(tuple(logits.shape) == (B, 1, cfg.padded_vocab)
                 and bool(torch.isfinite(logits).all()),
                 f"hybrid prefill: logits {tuple(logits.shape)} not finite")
    # the plain path, then the kernel path again (turns: k, p, p, k)
    ms = {"flash": [ms_flash], "chunked": []}
    plain = None
    for impl in ("chunked", "chunked", "flash"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = prefill[impl](model, batch)
        torch.cuda.synchronize()
        ms[impl].append((time.monotonic() - t0) * 1e3)
        if impl == "chunked":
            plain = out
    rel = ((logits - plain).norm() / plain.norm()).item()
    checks.check(math.isfinite(rel) and rel <= TOL_HYBRID_REL,
                 f"hybrid prefill: kernel vs plain rel L2 {rel}")
    # a measurement only: how far two plain paths (chunked vs naive
    # attention, the same plain SSD) drift apart through 38 layers of
    # random weights, the yardstick of the kernel path's rel L2
    naive = prefill["naive"](model, batch)
    rel_plain = ((naive - plain).norm() / plain.norm()).item()
    emit("hybrid_prefill", batch=B, seq=S, launches=counts,
         launches_want=want, ssd_cuda_launches=ssd_cuda_launches,
         ms_per_prefill_kernel_path=ms["flash"],
         ms_per_prefill_plain_path=ms["chunked"],
         tokens_per_s_kernel_path=B * S / (min(ms["flash"]) / 1e3),
         kernel_vs_plain_rel_l2=rel, tol=TOL_HYBRID_REL,
         chunked_vs_naive_plain_rel_l2=rel_plain,
         max_memory_allocated=peak)
    try:       # a measurement only; no check depends on it
        # "ssd_": the four K4 passes by name
        prof = _profile(lambda: prefill["flash"](model, batch), match="ssd_")
        # the profiler's own cost inflates its wall time; the device's
        # idle share of an unprofiled prefill uses the timed one
        prof["idle_share_of_unprofiled_prefill"] = max(
            0.0, 1.0 - prof["device_busy_ms"] / min(ms["flash"]))
        emit("hybrid_profile", **prof)
    except Exception as e:
        emit("hybrid_profile", error=repr(e))
    del logits, plain, out, naive

    # prefill vs stepwise decode on the same 256 tokens
    T = 256
    short = {"tokens": tokens[:1, :T]}
    last = prefill["flash"](model, short)[:, 0]
    state = BB.prepare_decode_state(model, cfg, {}, 1, T)
    t0 = time.monotonic()
    with torch.inference_mode():
        for t in range(T):
            lg, state = BB.decode_step(model, cfg, state,
                                       short["tokens"][:, t:t + 1], t)
    torch.cuda.synchronize()
    dec_s = time.monotonic() - t0
    d = (lg - last).abs().max().item()
    checks.check(math.isfinite(d) and d <= TOL_PREFILL_DECODE,
                 f"hybrid: prefill vs decode max abs {d}")
    emit("hybrid_prefill_vs_decode", tokens=T, max_abs_err=d,
         tol=TOL_PREFILL_DECODE, decode_ms_per_token_batch1=dec_s / T * 1e3)
    del model, state, lg, last
    torch.cuda.empty_cache()

    # the decode launcher on the card
    argv = ["--arch", HYBRID_ARCH, "--batch", "4", "--prompt-len", "64",
            "--gen", "32"]
    K4.ssd_chunk.launches = 0
    FA.flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        toks = serve.main(argv)
    wall = time.monotonic() - t0
    serve_counts = dict(ssd_chunk=K4.ssd_chunk.launches,
                        flash_attention=FA.flash_attention.launches)
    lines = buf.getvalue().splitlines()
    tps = float(lines[0].split(" at ")[1].split(" tok/s")[0])
    checks.check(tuple(toks.shape) == (4, 96) and toks.device.type == "cuda"
                 and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
                 f"serve: tokens {tuple(toks.shape)} on {toks.device}")
    checks.check(serve_counts == dict(ssd_chunk=0, flash_attention=0),
                 f"serve: decode launched kernels {serve_counts}")
    emit("hybrid_serve", argv=argv, lines=lines, launches=serve_counts,
         decode_tokens_per_s=tps, wall_seconds=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del toks
    torch.cuda.empty_cache()
    checks.end_phase("hybrid")
    return counts, ssd_cuda_launches


DENSE_CATEGORIES = (
    ("k3_flash_attention", ("flash",)),
    ("gemm", ("gemm", "gemv")),
)


class _AttentionInF64:
    """Within the block, the plain path's attention (``models.attention.
    chunked_attention``) is an exact softmax in f64 on f64 copies of its
    inputs, returned in the input dtype: the prefill logits' reference."""

    def __enter__(self):
        import torch
        from repro_torch.models import attention as A
        self.mod, self.orig = A, A.chunked_attention

        def f64(q, k, v, *, causal=True, window=0, **_):
            Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
            kd, vd = k.double(), v.double()
            k_pos = torch.arange(Sk, device=q.device)
            outs = []
            for q0 in range(0, Sq, 512):
                qd = q[:, q0:q0 + 512].double()
                s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(hd)
                mask = A._block_mask(q0 + torch.arange(qd.shape[1],
                                                       device=q.device),
                                     k_pos, causal, window)
                p = torch.softmax(torch.where(mask, s, -math.inf), dim=-1)
                outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vd))
            return torch.cat(outs, dim=1).to(q.dtype)
        A.chunked_attention = f64

    def __exit__(self, *exc):
        self.mod.chunked_attention = self.orig


def _dense_prefill(checks, name, cfg, model, tokens, want_k3, extra=None,
                   want_by_seq=None, warm_up=True):
    """One model's prefill through both paths: exact launches (K3 only:
    ``want_k3`` at S x S, or ``want_by_seq``, {"SqxSk": launches}),
    finite logits, kernel vs plain within TOL_DENSE_PREFILL, both against
    the f64-attention reference (a measurement), ms in turns (k, p, p,
    k), peak memory.  ``extra``: the batch's other inputs (the vlm's
    image embeds, the audio frames); ``warm_up=False``: no untimed
    prefill first (the last of the four turns is then the warm kernel
    path's).  Returns (record, the prefill steps)."""
    import torch
    from repro_torch.launch import steps
    B, S = tokens.shape
    batch = {"tokens": tokens, **(extra or {})}
    want_by_seq = want_by_seq or {f"{S}x{S}": want_k3}
    want_k3 = sum(want_by_seq.values())
    prefill = {impl: steps.make_prefill_step(cfg, impl=impl)
               for impl in ("flash", "chunked")}
    if warm_up:
        prefill["flash"](model, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_hybrid_counters()
    t0 = time.monotonic()
    logits = prefill["flash"](model, batch)
    torch.cuda.synchronize()
    ms = {"flash": [(time.monotonic() - t0) * 1e3], "chunked": []}
    counts, by_seq = _hybrid_counters(), _by_seq()
    peak = torch.cuda.max_memory_allocated()
    want = {k: (want_k3 if k == "flash_attention" else 0) for k in counts}
    checks.check(counts == want and by_seq == want_by_seq,
                 f"{name} prefill: launches {counts} by (Sq, Sk) {by_seq}, "
                 f"want K3 {want_by_seq} and nothing else")
    checks.check(tuple(logits.shape) == (B, 1, cfg.padded_vocab)
                 and bool(torch.isfinite(logits).all()),
                 f"{name} prefill: logits {tuple(logits.shape)} not finite")
    plain = None
    for impl in ("chunked", "chunked", "flash"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = prefill[impl](model, batch)
        torch.cuda.synchronize()
        ms[impl].append((time.monotonic() - t0) * 1e3)
        if impl == "chunked":
            plain = out
    err = (logits - plain).abs().max().item()
    checks.check(math.isfinite(err) and err <= TOL_DENSE_PREFILL,
                 f"{name} prefill: kernel vs plain max abs {err} (tol "
                 f"{TOL_DENSE_PREFILL})")
    with _AttentionInF64():
        ref = prefill["chunked"](model, batch)

    def dist(x):
        return dict(max_abs=(x - ref).abs().max().item(),
                    rel_l2=((x - ref).norm() / ref.norm()).item())
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=B, seq=S,
               launches=counts, launches_by_seq=by_seq,
               kernel_vs_plain_max_abs=err, tol=TOL_DENSE_PREFILL,
               kernel_vs_plain_rel_l2=((logits - plain).norm()
                                       / plain.norm()).item(),
               logits_max_abs=plain.abs().max().item(),
               kernel_vs_f64_attention=dist(logits),
               plain_vs_f64_attention=dist(plain),
               ms_per_prefill_kernel_path=ms["flash"],
               ms_per_prefill_plain_path=ms["chunked"],
               tokens_per_s_kernel_path=B * S / (min(ms["flash"]) / 1e3),
               max_memory_allocated=peak)
    emit(f"{name}_prefill", **rec)
    return rec, prefill


def phase_dense(checks):
    """The dense LMs served on the card through the port's entry points:
    full-width qwen3-1.7b (28 layers, head dim 128, qk-norm, GQA) prefill
    at 2 x 4096, prefill vs decode, the decode launcher with its
    defaults; qwen1.5-32b at full width with 2 of its 64 layers (QKV
    bias, 40-head MHA) prefill at 1 x 4096.  Returns {case: K3 launches
    of one prefill}."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import backbones as BB

    t_phase = time.monotonic()
    cfg = get_arch(DENSE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    model = BB.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    checks.check(n_params == 1_722_147_840,
                 f"dense: {DENSE_ARCH} has {n_params} parameters")
    emit("dense_params", arch=DENSE_ARCH, n_params=n_params,
         n_layers=cfg.n_layers, head_dim=cfg.resolved_head_dim,
         init_seconds=time.monotonic() - t0,
         param_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()))
    tokens = torch.randint(0, cfg.vocab_size, (2, 4096), generator=gen,
                           device="cuda")
    rec, prefill = _dense_prefill(checks, "dense_qwen3", cfg, model, tokens,
                                  cfg.n_layers)
    out = {"qwen3": rec["launches_by_seq"]}
    try:       # a measurement only; no check depends on it
        prof = _profile(lambda: prefill["flash"](model, {"tokens": tokens}),
                        categories=DENSE_CATEGORIES)
        prof["idle_share_of_unprofiled_prefill"] = max(
            0.0, 1.0 - prof["device_busy_ms"]
            / min(rec["ms_per_prefill_kernel_path"]))
        emit("dense_qwen3_profile", **prof)
    except Exception as e:
        emit("dense_qwen3_profile", error=repr(e))

    # prefill vs stepwise decode on the same 256 tokens
    T = 256
    short = {"tokens": tokens[:1, :T]}
    last = prefill["flash"](model, short)[:, 0]
    state = BB.prepare_decode_state(model, cfg, {}, 1, T)
    _zero_hybrid_counters()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.inference_mode():
        for t in range(T):
            lg, state = BB.decode_step(model, cfg, state,
                                       short["tokens"][:, t:t + 1], t)
    torch.cuda.synchronize()
    dec_s = time.monotonic() - t0
    d = (lg - last).abs().max().item()
    dec_counts = _hybrid_counters()
    checks.check(math.isfinite(d) and d <= TOL_PREFILL_DECODE
                 and not any(dec_counts.values()),
                 f"dense: prefill vs decode max abs {d}, decode launched "
                 f"{dec_counts}")
    emit("dense_qwen3_prefill_vs_decode", tokens=T, max_abs_err=d,
         tol=TOL_PREFILL_DECODE, decode_launches=dec_counts,
         decode_ms_per_token_batch1=dec_s / T * 1e3)
    del model, state, lg, last, prefill
    torch.cuda.empty_cache()

    # the decode launcher with its defaults (qwen3-1.7b, batch 4, prompt
    # 16, 32 new tokens, on the card)
    _zero_hybrid_counters()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        toks = serve.main([])
    wall = time.monotonic() - t0
    serve_counts = _hybrid_counters()
    lines = buf.getvalue().splitlines()
    tps = float(lines[0].split(" at ")[1].split(" tok/s")[0])
    checks.check(lines[0].startswith(f"arch={DENSE_ARCH} batch=4 ")
                 and tuple(toks.shape) == (4, 48)
                 and toks.device.type == "cuda" and 0 <= int(toks.min())
                 and int(toks.max()) < cfg.vocab_size
                 and not any(serve_counts.values()),
                 f"dense serve: {lines[:1]} tokens {tuple(toks.shape)} on "
                 f"{toks.device}, launches {serve_counts}")
    emit("dense_serve", argv=[], lines=lines, launches=serve_counts,
         decode_tokens_per_s=tps, wall_seconds=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del toks
    torch.cuda.empty_cache()

    # qwen1.5-32b at full width, 2 of its 64 layers
    wide = get_arch(DENSE_WIDE_ARCH).replace(n_layers=2)
    t0 = time.monotonic()
    model = BB.init_params(wide, gen, "cuda")
    torch.cuda.synchronize()
    emit("dense_qwen1p5_params", arch=DENSE_WIDE_ARCH,
         n_params=sum(p.numel() for p in model.parameters()),
         n_layers=wide.n_layers, head_dim=wide.resolved_head_dim,
         init_seconds=time.monotonic() - t0)
    tokens = torch.randint(0, wide.vocab_size, (1, 4096), generator=gen,
                           device="cuda")
    rec, _ = _dense_prefill(checks, "dense_qwen1p5", wide, model, tokens,
                            wide.n_layers)
    out["qwen1p5"] = rec["launches_by_seq"]
    del model
    torch.cuda.empty_cache()
    emit("dense", seconds=time.monotonic() - t_phase)
    checks.end_phase("dense")
    return out


# ---------------------------------------------------------------------------
# phase moe: the MoE LMs served
# ---------------------------------------------------------------------------

# full width, cut in depth (f32 weights at full depth: 122.1 GB for
# qwen3-moe, 237.8 GB for llama4-scout; PERF.md § 4): qwen3-moe 8 of 48
# layers, llama4-scout 4 of 48 (2 super-blocks of a dense block and an
# MoE block)
MOE_ARCH, MOE_WIDE_ARCH = "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"
MOE_LAYERS = {MOE_ARCH: 8, MOE_WIDE_ARCH: 4}
MOE_PARAMS = {MOE_ARCH: 5_609_148_416, MOE_WIDE_ARCH: 6_855_547_904}
# unforced kernel path vs plain path: the most (token, expert) choices
# and capacity picks, summed over a prefill's layers, in which the two
# paths may differ (a 1e-6 difference of the hidden states flips a
# near-tied router top-k; PERF.md § 6 gives the arithmetic and the runs)
MOE_ROUTE_DIFF_CEILING = 64
MOE_CATEGORIES = (
    ("k3_flash_attention", ("flash",)),
    ("gemm", ("gemm", "gemv")),
    # routing (the stable sorts), dispatch, combine and the scatters
    ("moe_route_dispatch_combine", ("sort", "Sort", "scatter", "gather",
                                    "index")),
)


class _Routes:
    """Within the block, ``models.moe.route`` records each call's result
    (``record``) or returns ``replay``'s results in call order; the
    package has no option for either.  ``rederive``: a replayed call
    keeps the recorded choices and picks but takes their values from its
    own probabilities (``_forced_route``), so that gradients reach its
    router."""

    def __init__(self, replay=None, rederive=False):
        self.replay = None if replay is None else list(replay)
        self.rederive = rederive
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe as M
        self.mod, self.orig = M, M.route
        it = iter(self.replay or ())

        def wrapped(*a):
            if self.replay is None:
                r = self.orig(*a)
            elif self.rederive:
                r = _forced_route(*a, next(it))
            else:
                r = next(it)
            # detached: a recompute's route keeps no graph alive
            self.calls.append(type(r)(*(t.detach() for t in r)))
            return r
        M.route = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig


def _route_diffs(a, b, E):
    """Per layer: (token, expert) choices in one path's routing only, and
    kept (token, expert) picks in one path's only."""
    import torch

    def chosen(r):
        return torch.zeros(r.gates.shape[:2] + (E,), dtype=torch.bool,
                           device=r.gates.device).scatter_(-1, r.experts,
                                                           True)

    def kept(r):
        B, _, C = r.picks.shape
        S = r.gates.shape[1]
        return torch.zeros((B, E, S), dtype=torch.bool,
                           device=r.picks.device).scatter_(
                               -1, r.picks, r.pick_w > 0)
    return ([int((chosen(x) ^ chosen(y)).sum()) for x, y in zip(a, b)],
            [int((kept(x) ^ kept(y)).sum()) for x, y in zip(a, b)])


def _timed_prefill(fn, model, batch):
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn(model, batch)
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


def _moe_pieces_ms(cfg, moe, B, S):
    """One MoE layer at the prefill shape (random hidden states), CUDA
    events: the whole ``apply_moe``, its ``route`` and its combine."""
    import torch
    from repro_torch.models import moe as M
    gen = torch.Generator(device="cuda").manual_seed(5)
    m = cfg.moe
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    C = M.moe_capacity(S, m.n_experts, m.top_k, m.capacity_factor)
    with torch.inference_mode():
        probs = torch.softmax((moe.norm(x) @ moe.router).float(), dim=-1)
        r = M.route(probs, m.top_k, C)
        eo = torch.randn((m.n_experts * B * C, cfg.d_model), generator=gen,
                         device="cuda")
        return dict(
            apply_moe_ms=device_ms(lambda: M.apply_moe(moe, cfg, x), 5),
            route_ms=device_ms(lambda: M.route(probs, m.top_k, C), 5),
            combine_ms=device_ms(lambda: M._combine(
                eo, r, B, S, m.n_experts, C), 5),
            capacity=C)


def _moe_prefill(checks, name, cfg, model, tokens):
    """One MoE model's prefill on both paths: exact K3 launches, finite
    logits, the kernel path twice to the bit, the kernel path replaying
    the plain path's routing within TOL_DENSE_PREFILL of it, the
    unforced kernel path's routing differences against the plain path's
    per layer (within MOE_ROUTE_DIFF_CEILING), tokens dropped by the
    capacity per layer, ms, peak memory.  Returns (record, steps)."""
    import torch
    from repro_torch.launch import steps
    B, S = tokens.shape
    m = cfg.moe
    n_super = cfg.n_layers // m.every
    want_k3 = n_super * (2 if m.every == 2 else 1)
    batch = {"tokens": tokens}
    prefill = {impl: steps.make_prefill_step(cfg, impl=impl)
               for impl in ("flash", "chunked")}
    prefill["flash"](model, batch)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_hybrid_counters()
    logits, ms_k = _timed_prefill(prefill["flash"], model, batch)
    counts, by_seq = _hybrid_counters(), _by_seq()
    peak = torch.cuda.max_memory_allocated()
    want = {k: (want_k3 if k == "flash_attention" else 0) for k in counts}
    checks.check(counts == want and by_seq == {f"{S}x{S}": want_k3},
                 f"{name} prefill: launches {counts} by (Sq, Sk) {by_seq}, "
                 f"want {want_k3} K3 at {S}x{S} and nothing else")
    checks.check(tuple(logits.shape) == (B, 1, cfg.padded_vocab)
                 and bool(torch.isfinite(logits).all()),
                 f"{name} prefill: logits {tuple(logits.shape)} not finite")
    with _Routes() as rk:
        again, ms_k2 = _timed_prefill(prefill["flash"], model, batch)
    repeat = torch.equal(again, logits)
    checks.check(repeat, f"{name} prefill: two kernel-path prefills differ")
    with _Routes() as rp:
        plain, ms_p = _timed_prefill(prefill["chunked"], model, batch)
    with _Routes(rp.calls) as rr:
        forced, ms_k3 = _timed_prefill(prefill["flash"], model, batch)
    err = (forced - plain).abs().max().item()
    checks.check(len(rr.calls) == n_super and math.isfinite(err)
                 and err <= TOL_DENSE_PREFILL,
                 f"{name} prefill: kernel path on the plain path's routes "
                 f"vs plain max abs {err} (tol {TOL_DENSE_PREFILL})")
    choices, picks = _route_diffs(rk.calls, rp.calls, m.n_experts)
    checks.check(sum(choices) + sum(picks) <= MOE_ROUTE_DIFF_CEILING,
                 f"{name} prefill: unforced routing differs from the plain "
                 f"path's in {choices} choices, {picks} picks per layer "
                 f"(ceiling {MOE_ROUTE_DIFF_CEILING} in all)")
    dropped = [int(r.experts.numel()) - int((r.pick_w > 0).sum())
               for r in rp.calls]
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=B, seq=S,
               capacity=rp.calls[0].picks.shape[-1],
               launches=counts, launches_by_seq=by_seq,
               kernel_path_bitwise_repeatable=repeat,
               replayed_routes_vs_plain_max_abs=err,
               tol=TOL_DENSE_PREFILL,
               unforced_vs_plain_max_abs=(again - plain).abs().max().item(),
               unforced_choices_differ_per_layer=choices,
               unforced_picks_differ_per_layer=picks,
               route_diff_ceiling=MOE_ROUTE_DIFF_CEILING,
               routed_per_layer=int(rp.calls[0].experts.numel()),
               dropped_per_layer_plain=dropped,
               dropped_per_layer_kernel=[
                   int(r.experts.numel()) - int((r.pick_w > 0).sum())
                   for r in rk.calls],
               logits_max_abs=plain.abs().max().item(),
               ms_per_prefill_kernel_path=[ms_k, ms_k2, ms_k3],
               ms_per_prefill_plain_path=[ms_p],
               tokens_per_s_kernel_path=B * S / (min(ms_k, ms_k2) / 1e3),
               max_memory_allocated=peak)
    emit(f"{name}_prefill", **rec)
    return rec, prefill


def _moe_prefill_vs_decode(checks, name, cfg, model, tokens, T=256):
    """Prefill vs ``decode_step`` over the same T tokens at capacity
    factor 64 (no drops: JAX's rule for this check), within
    TOL_PREFILL_DECODE; decode launches nothing."""
    import dataclasses

    import torch
    from repro_torch.launch import steps
    from repro_torch.models import backbones as BB
    wide = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=64.0))
    short = {"tokens": tokens[:1, :T]}
    last = steps.make_prefill_step(wide)(model, short)[:, 0]
    state = BB.prepare_decode_state(model, wide, {}, 1, T)
    _zero_hybrid_counters()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.inference_mode():
        for t in range(T):
            lg, state = BB.decode_step(model, wide, state,
                                       short["tokens"][:, t:t + 1], t)
    torch.cuda.synchronize()
    dec_s = time.monotonic() - t0
    d = (lg - last).abs().max().item()
    dec_counts = _hybrid_counters()
    checks.check(math.isfinite(d) and d <= TOL_PREFILL_DECODE
                 and not any(dec_counts.values()),
                 f"{name}: prefill vs decode max abs {d}, decode launched "
                 f"{dec_counts}")
    emit(f"{name}_prefill_vs_decode", tokens=T, capacity_factor=64.0,
         max_abs_err=d, tol=TOL_PREFILL_DECODE, decode_launches=dec_counts,
         decode_ms_per_token_batch1=dec_s / T * 1e3)


def phase_moe(checks):
    """The MoE LMs served on the card through the port's entry points, at
    full width with a depth cut (seeded random weights, f32):
    qwen3-moe-30b-a3b (8 of 48 layers; 128 experts top-8, 32 heads over
    4 KV heads at head dim 128) prefill at 2 x 4096 on both paths,
    prefill vs decode, ``serve.generate`` at batch 4, a profile;
    llama4-scout-17b-a16e (4 of 48 layers; 16 experts top-1 and a shared
    expert every other layer, 40 heads over 8) prefill at 1 x 4096 on
    both paths (the capacity drops tokens by JAX's tie rule), prefill vs
    decode; the decode launcher at reduced qwen3-moe.  Returns {arch: K3
    launches by (Sq, Sk) of one prefill}."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import backbones as BB

    t_phase = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for arch, B in ((MOE_ARCH, 2), (MOE_WIDE_ARCH, 1)):
        cfg = get_arch(arch).replace(n_layers=MOE_LAYERS[arch])
        t0 = time.monotonic()
        model = BB.init_params(cfg, gen, "cuda")
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        n_params = sum(p.numel() for p in model.parameters())
        checks.check(n_params == MOE_PARAMS[arch],
                     f"moe: {arch} at {cfg.n_layers} layers has {n_params} "
                     f"parameters, want {MOE_PARAMS[arch]}")
        name = "moe_qwen3" if arch == MOE_ARCH else "moe_llama4"
        emit(f"{name}_params", arch=arch, n_params=n_params,
             n_layers=cfg.n_layers, n_experts=cfg.moe.n_experts,
             top_k=cfg.moe.top_k, init_seconds=init_s,
             param_bytes=sum(p.numel() * p.element_size()
                             for p in model.parameters()))
        tokens = torch.randint(0, cfg.vocab_size, (B, 4096), generator=gen,
                               device="cuda")
        rec, prefill = _moe_prefill(checks, name, cfg, model, tokens)
        out[arch] = rec["launches_by_seq"]
        if arch == MOE_WIDE_ARCH:
            checks.check(sum(rec["dropped_per_layer_plain"]) > 0,
                         f"{name}: the capacity dropped no token "
                         f"({rec['dropped_per_layer_plain']})")
        try:       # measurements only; no check depends on them
            prof = _profile(lambda: prefill["flash"](
                model, {"tokens": tokens}), categories=MOE_CATEGORIES)
            prof["idle_share_of_unprofiled_prefill"] = max(
                0.0, 1.0 - prof["device_busy_ms"]
                / min(rec["ms_per_prefill_kernel_path"]))
            emit(f"{name}_profile", **prof)
            emit(f"{name}_layer_pieces", batch=B, seq=4096,
                 **_moe_pieces_ms(cfg, model.supers[0].moe, B, 4096))
        except Exception as e:
            emit(f"{name}_profile", error=repr(e))
        _moe_prefill_vs_decode(checks, name, cfg, model, tokens)
        if arch == MOE_ARCH:
            # batched decode at the depth cut: serve.generate, batch 4,
            # prompt 16, 32 new tokens
            prompt = torch.randint(0, cfg.vocab_size, (4, 16),
                                   generator=gen, device="cuda")
            state = BB.prepare_decode_state(model, cfg, {}, 4, 48)
            _zero_hybrid_counters()
            toks, tps = serve.generate(model, cfg, state, prompt, 48, 32)
            gen_counts = _hybrid_counters()
            checks.check(tuple(toks.shape) == (4, 48)
                         and int(toks.max()) < cfg.vocab_size
                         and not any(gen_counts.values()),
                         f"{name} generate: tokens {tuple(toks.shape)}, "
                         f"launches {gen_counts}")
            emit(f"{name}_generate", batch=4, prompt=16, new_tokens=32,
                 decode_tokens_per_s=tps, launches=gen_counts)
        del model, prefill
        torch.cuda.empty_cache()

    # the decode launcher on the card (reduced: full depth does not fit
    # in f32)
    argv = ["--arch", MOE_ARCH, "--reduced"]
    _zero_hybrid_counters()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        toks = serve.main(argv)
    wall = time.monotonic() - t0
    serve_counts = _hybrid_counters()
    lines = buf.getvalue().splitlines()
    vocab = get_arch(MOE_ARCH).reduced().vocab_size
    checks.check(lines[0].startswith(f"arch={MOE_ARCH} batch=4 ")
                 and tuple(toks.shape) == (4, 48)
                 and toks.device.type == "cuda" and 0 <= int(toks.min())
                 and int(toks.max()) < vocab
                 and not any(serve_counts.values()),
                 f"moe serve: {lines[:1]} tokens {tuple(toks.shape)} on "
                 f"{toks.device}, launches {serve_counts}")
    emit("moe_serve", argv=argv, lines=lines, launches=serve_counts,
         wall_seconds=wall)
    emit("moe", seconds=time.monotonic() - t_phase)
    checks.end_phase("moe")
    return out


# ---------------------------------------------------------------------------
# phases vlm and audio: the cross-attention families served
# ---------------------------------------------------------------------------

# full width; the audio model at full depth (f32 weights: 5.12 GB), the
# vlm at 10 of its 40 layers, 2 of its 8 super-blocks (13.29 GB; 40.47
# at full depth), a cut that pays for phases vlm_train and audio_train
# in the run's time (PERF.md § 4); the parameter counts are JAX's at
# these depths (tests/test_torch_cross_train.py)
VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
VLM_SERVE_LAYERS = 10
CROSS_PARAMS = {VLM_ARCH: 3_323_293_696, AUDIO_ARCH: 1_280_636_928}
# prefill vs stepwise decode: the prompt's tokens on each family
CROSS_DECODE_TOKENS = {VLM_ARCH: 64, AUDIO_ARCH: 256}


def _cross_want_by_seq(cfg, S):
    """K3's launches by (Sq, Sk) in one prefill at sequence ``S``: the
    vlm's self-attentions (S, S) and cross blocks (S, n_image_tokens);
    the audio's encoder (S_enc, S_enc), decoder self (S, S) and cross
    (S, S_enc)."""
    if cfg.family == "vlm":
        return {f"{S}x{S}": cfg.n_layers,
                f"{S}x{cfg.n_image_tokens}": (cfg.n_layers
                                              // cfg.cross_attn_every)}
    E = S // cfg.audio_subsample
    return {f"{E}x{E}": cfg.enc_layers, f"{S}x{S}": cfg.n_layers,
            f"{S}x{E}": cfg.n_layers}


def _cross_config(arch, layers=None):
    """The arch's config, at ``layers`` layers where given."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return cfg.replace(n_layers=layers) if layers else cfg


class _AtDepth:
    """Within the block, ``get_arch(arch)`` returns the arch at ``layers``
    layers (the launchers' own lookup: a depth cut)."""

    def __init__(self, arch, layers):
        self.arch, self.layers = arch, layers

    def __enter__(self):
        from repro_torch.configs import base
        self.base, self.orig = base, base.get_arch(self.arch)
        if self.layers:
            base._REGISTRY[self.arch] = self.orig.replace(
                n_layers=self.layers)

    def __exit__(self, *exc):
        self.base._REGISTRY[self.arch] = self.orig


def _cross_family(checks, arch, layers=None):
    """One cross-attention family served at full width (at ``layers``
    layers where given): seeded init on the card and JAX's parameter
    count; a 2 x 4096 prefill
    through both paths (``_dense_prefill``: exact K3 launches by (Sq,
    Sk), kernel vs plain within TOL_DENSE_PREFILL, both against the
    f64-attention reference, ms in turns, peak memory) with the stub
    inputs of the serving launcher; a profile by kind of kernel and the
    idle share; prefill vs ``decode_step`` over CROSS_DECODE_TOKENS
    tokens from ``prepare_decode_state`` (cross caches filled once),
    neither launching K3; the decode launcher on the card.  Returns K3's
    launches by (Sq, Sk) of one prefill."""
    import contextlib
    import io

    import torch
    from repro_torch.launch import serve
    from repro_torch.models import backbones as BB

    t_phase = time.monotonic()
    name = "vlm" if arch == VLM_ARCH else "audio"
    cfg = _cross_config(arch, layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    model = BB.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    checks.check(n_params == CROSS_PARAMS[arch],
                 f"{name}: {arch} has {n_params} parameters, want "
                 f"{CROSS_PARAMS[arch]}")
    emit(f"{name}_params", arch=arch, n_params=n_params,
         n_layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         head_dim=cfg.resolved_head_dim, init_seconds=time.monotonic() - t0,
         param_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()))
    B, S = 2, 4096
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    extra = serve.stub_inputs(cfg, B, S, gen, "cuda")
    want_by_seq = _cross_want_by_seq(cfg, S)
    # the vlm's ~3.4 s prefill is timed cold once and warm once (turns k,
    # p, p, k) rather than run a fifth time to warm up
    rec, prefill = _dense_prefill(checks, name, cfg, model, tokens, 0,
                                  extra=extra, want_by_seq=want_by_seq,
                                  warm_up=cfg.family != "vlm")
    out = rec["launches_by_seq"]
    try:       # a measurement only; no check depends on it
        prof = _profile(lambda: prefill["flash"](
            model, {"tokens": tokens, **extra}), categories=DENSE_CATEGORIES)
        prof["idle_share_of_unprofiled_prefill"] = max(
            0.0, 1.0 - prof["device_busy_ms"]
            / min(rec["ms_per_prefill_kernel_path"]))
        emit(f"{name}_profile", **prof)
    except Exception as e:
        emit(f"{name}_profile", error=repr(e))

    # prefill vs stepwise decode over the same prompt, the cross caches
    # filled once from the same stub inputs (no launch in either)
    T = CROSS_DECODE_TOKENS[arch]
    short = {"tokens": tokens[:1, :T],
             **serve.stub_inputs(cfg, 1, T, gen, "cuda")}
    last = prefill["flash"](model, short)[:, 0]
    _zero_hybrid_counters()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = BB.prepare_decode_state(model, cfg, short, 1, T)
    torch.cuda.synchronize()
    prep_ms = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    with torch.inference_mode():
        for t in range(T):
            lg, state = BB.decode_step(model, cfg, state,
                                       short["tokens"][:, t:t + 1], t)
    torch.cuda.synchronize()
    dec_s = time.monotonic() - t0
    d = (lg - last).abs().max().item()
    dec_counts = _hybrid_counters()
    cross_shape = list(state["cross_kv"]["k"].shape)
    checks.check(math.isfinite(d) and d <= TOL_PREFILL_DECODE
                 and not any(dec_counts.values()),
                 f"{name}: prefill vs decode max abs {d}, "
                 f"prepare_decode_state and decode launched {dec_counts}")
    emit(f"{name}_prefill_vs_decode", tokens=T, max_abs_err=d,
         tol=TOL_PREFILL_DECODE, decode_launches=dec_counts,
         cross_cache_shape=cross_shape, prepare_decode_state_ms=prep_ms,
         decode_ms_per_token_batch1=dec_s / T * 1e3)
    del model, state, lg, last, prefill, extra
    torch.cuda.empty_cache()

    # the decode launcher on the card at the phase's depth (batch 4,
    # prompt 16, 32 new tokens; its stub inputs fill the cross caches)
    argv = ["--arch", arch]
    _zero_hybrid_counters()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf), _AtDepth(arch, layers):
        toks = serve.main(argv)
    wall = time.monotonic() - t0
    serve_counts = _hybrid_counters()
    lines = buf.getvalue().splitlines()
    tps = float(lines[0].split(" at ")[1].split(" tok/s")[0])
    checks.check(lines[0].startswith(f"arch={arch} batch=4 ")
                 and tuple(toks.shape) == (4, 48)
                 and toks.device.type == "cuda" and 0 <= int(toks.min())
                 and int(toks.max()) < cfg.vocab_size
                 and not any(serve_counts.values()),
                 f"{name} serve: {lines[:1]} tokens {tuple(toks.shape)} on "
                 f"{toks.device}, launches {serve_counts}")
    emit(f"{name}_serve", argv=argv, n_layers=cfg.n_layers, lines=lines,
         launches=serve_counts,
         decode_tokens_per_s=tps, wall_seconds=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del toks
    torch.cuda.empty_cache()
    emit(name, seconds=time.monotonic() - t_phase)
    checks.end_phase(name)
    return out


def phase_vlm(checks):
    """``llama-3.2-vision-11b`` served at full width and
    ``VLM_SERVE_LAYERS`` layers (``_cross_family``)."""
    return _cross_family(checks, VLM_ARCH, VLM_SERVE_LAYERS)


def phase_audio(checks):
    """``seamless-m4t-large-v2`` served whole (``_cross_family``)."""
    return _cross_family(checks, AUDIO_ARCH)


# ---------------------------------------------------------------------------
# phase hybrid_train: zamba2-1.2b trained under both objectives
# ---------------------------------------------------------------------------

# the launchers' runs (full width, f32, seed 0; --impl flash and
# --loss-impl fused are the defaults): the LM objective at the prefill
# phase's 2 x 4096, the contrastive one at the JAX launcher's default
# batch, 64, with one full 256-token chunk per row
# phase hybrid_train's depth: 8 of zamba2-1.2b's 38 layers (1 of its 6
# super-blocks, so 1 call of the shared block, and the 2-layer tail) at
# full width, a cut that keeps the whole run inside its time (20 before
# phase moe_train; PERF.md § 4)
HYBRID_TRAIN_LAYERS = 8
HYBRID_LM_ARGS = ["--arch", HYBRID_ARCH, "--objective", "lm",
                  "--global-batch", "2", "--seq-len", "4096", "--steps",
                  "3", "--log-every", "1", "--device", "cuda", "--seed",
                  "0", "--precision", "f32"]
HYBRID_CTR_ARGS = ["--arch", HYBRID_ARCH, "--version", "v3",
                   "--global-batch", "64", "--seq-len", "256", "--steps",
                   "3", "--log-every", "1", "--device", "cuda", "--seed",
                   "0", "--precision", "f32"]
# the launchers' defaults that the in-process runs repeat
HYBRID_N_SAMPLES, HYBRID_LR = 2048, 1e-3
# bf16 against f32, the step-0 loss: relative
TOL_HYBRID_BF16 = 1e-2
# zamba2's step-0 gradients are held to a reference whose SSD scans run
# in f64 (the plain scan; every other op as the plain path in f32): each
# leaf of the kernel path within this relative L2 of it, per objective.
# TOL_TRAIN_GRAD against the plain path is below f32's floor at full
# depth: two plain f32 paths, the SSD at chunk 256 and at 128, differ by
# 1.07e-4 relative L2 per leaf (median; 259 of 356 leaves over 1e-4).
# Readings at 20 layers (H100, full width, seed 0; PERF.md),
# worst leaf, kernel path / plain f32 path / the kernel path in bf16 (a
# control): LM 8.01e-5 / 7.95e-5 / ~1; contrastive 4.87e-3 / 9.55e-2 /
# ~3 (its random-init loss cancels, so rounding in the towers is
# amplified; the plain SSD's rounding most).  The f32 readings repeat
# bit for bit from run to run.  Each limit is about twice the kernel
# path's reading: the LM's twice the plain path's too, the contrastive
# one under the plain path's, and both far under the control's
TOL_HYBRID_GRAD = {"lm": 1.6e-4, "contrastive": 1e-2}
# a training step's kernels by what they compute
HYBRID_CATEGORIES = (
    ("k4_ssd_chunk", ("ssd_",)),
    ("k3_flash_attention", ("flash",)),
    ("k1_k2_fcco", ("stats_partial", "stats_merge", "grads_weights",
                    "grads_product")),
    ("gemm", ("gemm", "gemv")),
)


def _hybrid_step_launches(cfg, steps, contrastive):
    """Launches of ``steps`` hybrid training steps under the recompute:
    each Mamba2 layer runs forward and in its recompute (2 K4 calls, 4
    CUDA launches each), each shared-block call twice (K3); the
    contrastive loss adds one K1 and one K2 call (2 CUDA launches
    each)."""
    n_super = cfg.n_layers // cfg.hybrid_attn_every
    k4 = 2 * cfg.n_layers
    k12 = steps if contrastive else 0
    return dict(flash_attention=steps * 2 * n_super, gcl_pair_stats=k12,
                gcl_pair_grads=k12, gcl_pair_stats_cuda=2 * k12,
                gcl_pair_grads_cuda=2 * k12, ssd_chunk=steps * k4,
                ssd_chunk_cuda=4 * steps * k4)


def _hybrid_counters():
    from repro_torch.kernels import ssd_chunk as K4
    return dict(_counters(), ssd_chunk=K4.ssd_chunk.launches,
                ssd_chunk_cuda=K4.ssd_chunk.cuda_launches)


def _zero_hybrid_counters():
    from repro_torch.kernels import ssd_chunk as K4
    _zero_counters()
    K4.ssd_chunk.launches = K4.ssd_chunk.cuda_launches = 0


def _state_leaves(state):
    """{name: tensor} of a train state: the model's parameters, the
    moments, the counters and the FCCO state."""
    out = {f"params/{n}": p for n, p in state["params"].named_parameters()}
    for k, v in state["opt"].items():
        if isinstance(v, dict):
            out.update({f"opt/{k}/{n}": t for n, t in v.items()})
        else:
            out[f"opt/{k}"] = v
    for k, v in state.get("fc", {}).items():
        if isinstance(v, dict):
            out.update({f"fc/{k}/{n}": t for n, t in v.items()})
        else:
            out[f"fc/{k}"] = v
    out["step"] = state["step"]
    return out


def _fingerprints(state):
    """{leaf: (sum, sum of squares, position-weighted sum)} of each
    leaf's 32-bit patterns as int64, wrapping; the third weighs entry i
    by i mod 65521 (a prime), so entries that trade places within a leaf
    change it too.  A leaf that differs in any bit or order changes them
    unless its changes cancel in all three.  Computed on the card (14 GB
    of state would take seconds to copy and hash)."""
    import torch
    out = {}
    for k, t in _state_leaves(state).items():
        x = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(x.numel(), device=x.device) % 65521
        out[k] = (int(x.sum()), int((x * x).sum()), int((x * w).sum()))
    return out


def _fresh_state(model, host, fc_cfg=None):
    """``model`` reset to the host copy of its init (``host``) or, with
    ``host`` None, to its init drawn again on the card from seed 0 (the
    draws of ``init_params`` with a card generator, bit for bit); zero
    AdamW moments, step 0 (and, for the contrastive step, a fresh FCCO
    state): the state ``init_train_state`` / ``init_lm_train_state``
    build, without drawing the random numbers on the host again."""
    import torch
    from repro_torch.core import fastclip as FC
    from repro_torch.optim import adamw
    dev = next(model.parameters()).device
    with torch.no_grad():
        if host is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            for m in model.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters(gen)
        else:
            for n, p in model.named_parameters():
                p.copy_(host[n], non_blocking=True)
    state = {"params": model,
             "opt": adamw().init({k: p.detach()
                                  for k, p in model.named_parameters()}),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if fc_cfg is not None:
        state["fc"] = FC.init_state(fc_cfg, dev)
    return state


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    _zero_hybrid_counters()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3, _hybrid_counters()


def _grads_rel(g_k, g_p):
    """Per-leaf relative L2 of gradients ``g_k`` against ``g_p`` (0 where
    both are 0: a leaf the loss does not reach)."""
    return {k: ((g_k[k] - g_p[k]).norm()
                / g_p[k].norm().clamp_min(1e-30)).item() for k in g_p}


class _SSDInF64:
    """Within the block, the plain path's SSD scans (``models.ssm.
    ssd_chunked``) run in f64 on f64 copies of their inputs and return
    f32: the gradients' reference."""

    def __enter__(self):
        from repro_torch.kernels import ssd_chunk as K4
        from repro_torch.models import ssm as SSM
        self.ssm, self.orig = SSM, SSM.ssd_chunked

        def f64(x, log_a, Bm, Cm, S0=None, chunk=256):
            y, S = K4.ssd_scan_plain(x.double(), log_a.double(),
                                     Bm.double(), Cm.double(), chunk=chunk)
            return y.float(), S.float()
        SSM.ssd_chunked = f64

    def __exit__(self, *exc):
        self.ssm.ssd_chunked = self.orig


def _leaf_summary(rel):
    import statistics
    worst = max(rel, key=rel.get)
    return dict(worst_leaf=worst, worst=rel[worst],
                median=statistics.median(rel.values()),
                over_tol_train_grad=sum(v > TOL_TRAIN_GRAD
                                        for v in rel.values()))


def _backward_ms(B, T):
    """CUDA events at one objective's layer shapes (``B`` rows of ``T``
    tokens at full width): the backward of ``_SSDChunk`` (autograd of the
    plain scan) and of ``_FlashMHA`` (the chunked recompute) per call,
    as forward + backward minus forward."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_chunk as K4
    gen = torch.Generator(device="cuda").manual_seed(7)
    H, P, N, Ha, hd = 64, 64, 64, 32, 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    ins = [randn(B, T, H, P),
           -torch.nn.functional.softplus(randn(B, T, H) - 2.0),
           randn(B, T, N), randn(B, T, N)]
    ins = [t.requires_grad_(True) for t in ins]
    gy = randn(B, T, H, P)
    qkv = [randn(B, T, Ha, hd).requires_grad_(True) for _ in range(3)]
    go = randn(B, T, Ha, hd)

    def ssd_fwd():
        with torch.no_grad():
            K4.ssd_chunk(*ins, chunk=256)

    def ssd_both():
        torch.autograd.grad(K4.ssd_chunk(*ins, chunk=256), ins, gy)

    def attn_fwd():
        with torch.no_grad():
            FA.flash_mha(*qkv, causal=True)

    def attn_both():
        torch.autograd.grad(FA.flash_mha(*qkv, causal=True), qkv, go)

    out = {}
    for name, fwd, both, shape in (
            ("ssd_chunk", ssd_fwd, ssd_both, [B, T, H, P, N]),
            ("flash_mha", attn_fwd, attn_both, [B, T, Ha, hd])):
        f, b = device_ms(fwd, iters=5), device_ms(both, iters=5)
        out[name] = dict(shape=shape, forward_ms=f, forward_backward_ms=b,
                         backward_ms=b - f)
    del ins, gy, qkv, go
    torch.cuda.empty_cache()
    return out


def _hybrid_objective(checks, name, cfg, model, host, batches, kind):
    """One objective in this process, from the launcher's init (``host``)
    on its first 3 batches, already on the card: step-0 gradients of the
    kernel path and the plain path against the f64-SSD reference
    (``TOL_HYBRID_GRAD``), the launches of one step, two identical
    kernel-path steps equal (fingerprints), the first timed, the second
    profiled; 3 plain-path steps; one bf16 step; the backward of K4's and
    K3's Functions timed at these shapes.  Returns the kernel path's
    step-0 metrics, the plain path's record and its final log-u
    (contrastive)."""
    import dataclasses

    import torch
    from repro_torch.core import train_step as TS
    from repro_torch.launch import steps as ST
    from repro_torch.models import backbones as BB
    from repro_torch.models.precision import get_precision
    contrastive = kind == "contrastive"
    dev = next(model.parameters()).device
    if contrastive:
        tcs = {impl: _hybrid_ctr_config(cfg, impl, loss_impl)
               for impl, loss_impl in (("flash", "fused"),
                                       ("chunked", "dense"))}
        fc_cfg = tcs["flash"].fc
        make = {impl: TS.make_train_step(tc, dev)
                for impl, tc in tcs.items()}

        def run(step, state, b):
            return step(state, b[1], b[0])

        def grads(impl, state, b, precision=None):
            tc = tcs[impl]
            if precision is not None:
                tc = dataclasses.replace(tc, precision=precision)
            core = TS.make_loss_core(tc.fc, tc.loss_impl)
            return TS.step_grads(tc, core, state, b[1], b[0],
                                 tc.fc.gamma_fn()(state["step"]))[2]
        bf16 = TS.make_train_step(
            dataclasses.replace(tcs["flash"], precision="bf16"), dev)
    else:
        fc_cfg = None
        make = {impl: ST.make_lm_train_step(
            cfg, lr=HYBRID_LR, wd=0.1, total_steps=3, impl=impl,
            device=dev)[0] for impl in ("flash", "chunked")}

        def run(step, state, b):
            return step(state, b[1])

        def grads(impl, state, b, precision=None):
            with torch.enable_grad():
                loss, _ = BB.lm_loss(state["params"], cfg, b[1], impl=impl,
                                     precision=get_precision(precision))
                return TS.param_grads(loss, state["params"])
        bf16 = ST.make_lm_train_step(cfg, lr=HYBRID_LR, wd=0.1,
                                     total_steps=3, precision="bf16",
                                     device=dev)[0]
    want1 = _hybrid_step_launches(cfg, 1, contrastive)
    out = {}
    seconds = {}
    t0 = time.monotonic()

    def lap(part):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[part] = time.monotonic() - t0
        t0 = time.monotonic()
    # step-0 gradients of the kernel path and the plain path against the
    # f64-SSD reference, and the launches of one forward + backward; the
    # kernel path in bf16 against it too, a control that the bound tells
    # a lower precision apart
    state = _fresh_state(model, host, fc_cfg)
    g_k, ms_g, n_g = _timed(lambda: grads("flash", state, batches[0]))
    g_p = grads("chunked", state, batches[0])
    rel = _grads_rel(g_k, g_p)
    lap("grads_kernel_plain")
    with _SSDInF64():
        g_r = grads("chunked", state, batches[0])
    err_k, err_p = _grads_rel(g_k, g_r), _grads_rel(g_p, g_r)
    del g_k, g_p
    err_b = _grads_rel(grads("flash", state, batches[0], "bf16"), g_r)
    del g_r
    torch.cuda.empty_cache()
    lap("grads_f64_ssd")
    bound = TOL_HYBRID_GRAD[kind]
    worst = max(err_k, key=err_k.get)
    checks.check(all(math.isfinite(v) and v <= bound
                     for v in err_k.values()),
                 f"{name}: step-0 grads against the f64-SSD reference, "
                 f"worst leaf {worst} rel L2 {err_k[worst]}, bound {bound}")
    # two identical kernel-path steps: the first timed, the second
    # profiled
    fps, ms_k = [], []
    for i in range(2):
        state = _fresh_state(model, host, fc_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 0:
            (state, m0), ms, n1 = _timed(lambda: run(make["flash"], state,
                                                     batches[0]))
            ms_k.append(ms)
            peak = torch.cuda.max_memory_allocated()
            out["metrics0"] = {k: float(v) for k, v in m0.items()}
        else:
            held = {}

            def one():
                held["out"] = run(make["flash"], state, batches[0])
            prof = _profile(one, categories=HYBRID_CATEGORIES,
                            host_ops=False)
            state, _ = held.pop("out")
        fps.append(_fingerprints(state))
        del state
        torch.cuda.empty_cache()
    differ = [k for k in fps[0] if fps[0][k] != fps[1][k]]
    checks.check(not differ, f"{name}: two identical steps differ in "
                 f"{differ[:8]}")
    lap("two_kernel_steps")
    checks.check(n1 == want1 and n_g == want1,
                 f"{name}: launches of one step {n1} (its forward and "
                 f"backward alone {n_g}), want {want1}")
    # the plain path, 3 steps
    state = _fresh_state(model, host, fc_cfg)
    rec_p, ms_p = [], []
    for i, b in enumerate(batches):
        (state, m), ms, _ = _timed(lambda: run(make["chunked"], state, b))
        rec_p.append({k: float(v) for k, v in m.items()})
        ms_p.append(ms)
    if contrastive:
        out["u_plain"] = {u: state["fc"][u].detach().cpu()
                          for u in ("u1", "u2")}
    del state
    torch.cuda.empty_cache()
    lap("plain_steps")
    # one bf16 step
    state = _fresh_state(model, host, fc_cfg)
    state, mb = run(bf16, state, batches[0])
    loss_b = float(mb["loss"])
    err = _dtype_error(state)
    del state
    torch.cuda.empty_cache()
    lap("bf16_step")
    # the device's idle share of the timed (unprofiled) step: the same
    # work as the profiled one, so a negative share would show a mismatch
    prof["idle_share_of_timed_step"] = 1.0 - prof["device_busy_ms"] / ms_k[0]
    B, T = batches[0][1]["tokens"].shape
    backward = _backward_ms(B, T)
    lap("backward_timings")
    rel_b = abs(loss_b - out["metrics0"]["loss"]) / abs(
        out["metrics0"]["loss"])
    checks.check(math.isfinite(loss_b) and rel_b <= TOL_HYBRID_BF16
                 and err is None,
                 f"{name}: bf16 step-0 loss {loss_b} rel {rel_b} against "
                 f"f32 {out['metrics0']['loss']}, dtypes {err}")
    out["record_plain"] = rec_p
    emit(f"{name}_device", batch_on_device=True, grad_leaves=len(rel),
         grads_kernel_vs_f64_ssd=_leaf_summary(err_k),
         grads_plain_vs_f64_ssd=_leaf_summary(err_p),
         grads_bf16_control_vs_f64_ssd=_leaf_summary(err_b),
         grads_kernel_vs_plain=_leaf_summary(rel), grad_bound=bound,
         ms_grads_kernel_path=ms_g,
         launches_one_step=n1, launches_want=want1,
         two_steps_equal=not differ, leaves_compared=len(fps[0]),
         ms_per_step_kernel_path=ms_k, ms_per_step_plain_path=ms_p,
         max_memory_allocated_kernel_step=peak,
         loss_kernel_step0=out["metrics0"]["loss"],
         losses_plain=[r["loss"] for r in rec_p], loss_bf16=loss_b,
         bf16_rel=rel_b, tol_bf16=TOL_HYBRID_BF16, profile=prof,
         backward_per_call=backward, seconds=seconds)
    return out


def _hybrid_ctr_config(cfg, impl, loss_impl):
    """The launcher's v3 step at HYBRID_CTR_ARGS."""
    from repro_torch.core import fastclip as FC
    from repro_torch.core import train_step as TS
    from repro_torch.core.schedules import lr_warmup_cosine
    from repro_torch.optim import adamw
    fc = FC.FastCLIPConfig(version="v3", n_samples=HYBRID_N_SAMPLES,
                           rho=6.5, eps=1e-14, gamma_min=0.2, tau_init=0.07,
                           lr_tau=2e-4, steps_per_epoch=HYBRID_N_SAMPLES // 64,
                           gamma_decay_epochs=1)
    return TS.TrainStepConfig(arch=cfg, fc=fc, optimizer=adamw(),
                              lr_fn=lr_warmup_cosine(HYBRID_LR, 1, 3),
                              wd=0.1, impl=impl, loss_impl=loss_impl)


def _hybrid_batches(cfg, kind, gb=None):
    """The launcher's first 3 (idx, batch) on the card (global batch
    ``gb``, by default the launcher's: 2 for the LM, 64 for the
    contrastive objective)."""
    import numpy as np
    import torch
    from repro_torch.data import (LMDataset, PairedEmbeddingDataset,
                                  ShardedLoader)
    if kind == "lm":
        ds, gb = LMDataset(n=HYBRID_N_SAMPLES, seq_len=4096,
                           vocab_size=cfg.vocab_size), gb or 2
    else:
        ds, gb = PairedEmbeddingDataset(n=HYBRID_N_SAMPLES, seq_len=256,
                                        vocab_size=cfg.vocab_size), gb or 64
    return [(torch.from_numpy(np.asarray(idx)).cuda(),
             {k: torch.from_numpy(v).cuda() for k, v in b.items()})
            for _, _, idx, b in ShardedLoader(ds, global_batch=gb,
                                              seed=0).steps(3)]


def _hybrid_launcher_checks(checks, name, cfg, finished, lines, inproc,
                            contrastive, want=None, phase="hybrid_train"):
    """The launcher's child process (3 kernel-path steps): exit 0, its
    step lines, launches exact (``want``, by default the hybrid's), f32
    masters, its step-0 loss equal to the in-process run's, its
    trajectory against the in-process plain path within rtol
    TOL_TRAIN_TRAJ (and the log-u rows), the retrieval line of the
    contrastive run."""
    rc, rep, u, err = finished
    lines = [ln for ln in lines if ln]
    if rc or rep is None:
        print(err, file=sys.stderr, flush=True)
    if not checks.check(rc == 0 and rep is not None,
                        f"{name}: launcher process exit code {rc}"):
        checks.end_phase(phase)
    rec = rep["record"]
    step_lines = [ln for ln in lines if ln.startswith("step ")]
    if want is None:
        want = _hybrid_step_launches(cfg, 3, contrastive)
    got = dict(rep["launches"], **rep["k4"])
    checks.check(got == want, f"{name}: launches {got}, want {want}")
    checks.check(len(rec) == 3 and len(step_lines) == 3
                 and all(math.isfinite(r["loss"]) for r in rec)
                 and rep["dtype_error"] is None,
                 f"{name}: steps {len(rec)}, lines {step_lines}, dtypes "
                 f"{rep['dtype_error']}")
    checks.check(rec[0]["loss"] == inproc["metrics0"]["loss"],
                 f"{name}: the launcher's step-0 loss {rec[0]['loss']} is "
                 f"not the in-process one {inproc['metrics0']['loss']}")
    # the losses of every step; the contrastive run's other metrics at
    # steps 0 and 1, whose params are the init (lr is 0 at step 0).  From
    # step 2 on its params carry the first update, where AdamW moves every
    # gradient entry whose sign rounding decides by +-lr (the plain f32
    # path's own step-0 gradients sit ~2e-2 from the f64-SSD reference at
    # this random init): those metrics and the final log-u are measured
    keys = ("loss", "tau", "loss_value", "u_mean") if contrastive else (
        "loss", "ce")
    rel = [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in keys}
           for a, b in zip(rec, inproc["record_plain"])]
    traj = max(r[k] for i, r in enumerate(rel) for k in keys
               if k in ("loss", "ce") or i < 2)
    u_err = (_log_u_rel(checks, name, u, inproc["u_plain"])
             if contrastive else None)
    checks.check(len(rel) == 3 and traj <= TOL_TRAIN_TRAJ,
                 f"{name}: kernel vs plain trajectory rel {rel}")
    acc = [ln for ln in lines if ln.startswith("retrieval accuracy: ")]
    checks.check(bool(acc) == contrastive,
                 f"{name}: retrieval lines {acc}")
    emit(f"{name}_launcher", steps=3, lines=step_lines + acc,
         launches=got, launches_want=want,
         losses=[r["loss"] for r in rec],
         losses_plain=[r["loss"] for r in inproc["record_plain"]],
         worst_rel_traj_checked=traj, rel_by_step=rel,
         log_u_rel_err_measured=u_err, tol=TOL_TRAIN_TRAJ,
         ms_per_step_after_warmup=(rec[-1]["time"] - rec[0]["time"]) / 2
         * 1e3, max_memory_allocated=rep["max_memory_allocated"],
         wall_seconds=rep["wall_seconds"])
    return got


def phase_hybrid_train(checks, child=None):
    """zamba2-1.2b at full width and ``HYBRID_TRAIN_LAYERS`` layers trained
    under the LM and the contrastive objective, f32, seed 0: each
    launcher in a child process (3 steps through the kernels), and the
    same init and batches here (``_hybrid_objective``).  ``child``: a
    held ``_LauncherProcess`` for the LM launcher.  Returns the kernels'
    launches per launcher run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    cfg = get_arch(HYBRID_ARCH).replace(n_layers=HYBRID_TRAIN_LAYERS)
    out = {}
    # both launchers start now, the contrastive one held (its imports
    # done by its turn)
    held = {"lm": child, "contrastive": _LauncherProcess()}
    for kind, argv in (("lm", HYBRID_LM_ARGS), ("contrastive",
                                                 HYBRID_CTR_ARGS)):
        name = f"hybrid_train_{kind}"
        t0 = time.monotonic()
        child = (held[kind] or _LauncherProcess()).start(
            argv, layers=HYBRID_TRAIN_LAYERS)
        try:
            if kind == "lm":
                # the launcher's init, drawn on the host as the launcher
                # draws it, while the child starts
                model = BB.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cuda")
                host = {n: p.detach().cpu().pin_memory()
                        for n, p in model.named_parameters()}
        finally:
            finished = child.finish(1200)
        t_child = time.monotonic() - t0
        torch.cuda.empty_cache()
        inproc = _hybrid_objective(checks, name, cfg, model, host,
                                   _hybrid_batches(cfg, kind), kind)
        out[kind] = _hybrid_launcher_checks(
            checks, name, cfg, finished, child.lines, inproc,
            kind == "contrastive")
        emit(f"{name}_seconds", seconds=time.monotonic() - t0,
             child_seconds=t_child)
    del model, host
    torch.cuda.empty_cache()
    checks.end_phase("hybrid_train")
    return out


# ---------------------------------------------------------------------------
# Phase dense_train: qwen3-1.7b trained under both objectives, and the
# contrastive objective of an LM backbone on the (data, fsdp) mesh
# ---------------------------------------------------------------------------

DENSE_LM_ARGS = ["--arch", DENSE_ARCH, "--objective", "lm",
                 "--global-batch", "2", "--seq-len", "4096", "--steps", "3",
                 "--log-every", "1", "--device", "cuda", "--seed", "0",
                 "--precision", "f32"]
# phase dense_train's depth: 10 of qwen3-1.7b's 28 layers at full width
# (JAX's rule: 2 groups of 5, as 7 groups of 4 at full depth), a cut
# that pays for phases moe and moe_train in the run's time (14 before
# phase moe_train; PERF.md § 4)
DENSE_TRAIN_LAYERS = 10
# qwen3-1.7b on data:1,fsdp:2 (2 gloo ranks sharing the card) at full
# width with 4 of its 28 layers (JAX's rule recomputes each of 4 layers
# on its own: default_remat_group(4) is 1); both ranks run one device's
# reference steps at once (a whole state ~14 GB: two fit the card)
DENSE_MESH_LAYERS = 4
# step-0 gradients of the kernel path against the plain path: every leaf
# within this relative L2, per objective (phase train's bound)
TOL_DENSE_GRAD = {"lm": TOL_TRAIN_GRAD, "contrastive": TOL_TRAIN_GRAD}
# a dense training step's kernels by what they compute
DENSE_TRAIN_CATEGORIES = (
    ("k3_flash_attention", ("flash",)),
    ("k1_k2_fcco", ("stats_partial", "stats_merge", "grads_weights",
                    "grads_product")),
    ("gemm", ("gemm", "gemv")),
)


def _dense_step_launches(cfg, steps, contrastive, nested=False):
    """Launches of ``steps`` dense training steps under JAX's grouped
    recompute: K3 in each layer's forward and again in its group's
    recompute; in JAX's nested form (``nested``, phase remat_forms only)
    once more in the layer's own recompute, but for each group's last
    layer, whose output no saved tensor needs (``torch.utils.checkpoint``
    stops a recompute early); the contrastive loss adds one K1 and one K2
    call (2 CUDA launches each); no K4."""
    from repro_torch.models import layers as L
    n, g = cfg.n_layers, L.default_remat_group(cfg.n_layers)
    grouped = not (g <= 1 or n % g or n <= g)
    per = 2 * n + (n - n // g if grouped and nested else 0)
    k12 = steps if contrastive else 0
    return dict(flash_attention=steps * per, gcl_pair_stats=k12,
                gcl_pair_grads=k12, gcl_pair_stats_cuda=2 * k12,
                gcl_pair_grads_cuda=2 * k12, ssd_chunk=0, ssd_chunk_cuda=0)


class _HostGrads:
    """Pinned host buffers for one set of gradients, {name: tensor},
    filled by ``take`` (a copy of every leaf, then one sync)."""

    def __init__(self, model):
        import torch
        self.buf = {n: torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                    for n, p in model.named_parameters()}

    def take(self, grads):
        import torch
        for n, g in grads.items():
            self.buf[n].copy_(g.detach(), non_blocking=True)
        torch.cuda.synchronize()


class _HostGradsBehind:
    """``_HostGrads`` for ``model`` allocated on a thread (pinning ~9 GB
    of host memory takes seconds), beside the card's work until the
    first ``take``."""

    def __init__(self, model):
        import concurrent.futures
        t0 = time.monotonic()
        self.seconds = None

        def alloc():
            hg = _HostGrads(model)
            self.seconds = time.monotonic() - t0
            return hg
        pool = concurrent.futures.ThreadPoolExecutor(1)
        self.future = pool.submit(alloc)
        pool.shutdown(wait=False)       # the thread ends with ``alloc``

    @property
    def buf(self):
        return self.future.result().buf

    def take(self, grads):
        self.future.result().take(grads)


def _host_rel(a, b, dev):
    """Per-leaf relative L2 of host gradients ``a`` against ``b``, on the
    card one leaf at a time (0 where both are 0)."""
    out = {}
    for k, hb in b.items():
        x, y = a[k].to(dev, non_blocking=True), hb.to(dev, non_blocking=True)
        out[k] = ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
    return out


class _CaptureGrads:
    """Within the block, the first gradients a step computes go to
    ``sink`` before the optimizer runs: those of
    ``core.train_step.param_grads``, which the LM step calls, or with
    ``contrastive`` of ``core.train_step.step_grads``, the contrastive
    step's."""

    def __init__(self, sink, contrastive=False):
        self.sink = sink
        self.name = "step_grads" if contrastive else "param_grads"

    def __enter__(self):
        from repro_torch.core import train_step as TS
        self.ts, self.orig = TS, getattr(TS, self.name)
        done = []

        def capture(*a, **k):
            out = self.orig(*a, **k)
            if not done:
                done.append(True)
                self.sink(out[2] if self.name == "step_grads" else out)
            return out
        setattr(TS, self.name, capture)

    def __exit__(self, *exc):
        setattr(self.ts, self.name, self.orig)


def _attn_backward_ms(B, T, H, hd, Sk=None, causal=True):
    """CUDA events at an attention layer's shape (``B`` rows of ``T``
    queries over ``Sk`` keys, ``T`` by default, ``H`` heads after the GQA
    repeat): the backward of ``_FlashMHA`` (the chunked recompute) per
    call, as forward + backward minus forward."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    Sk = Sk or T
    gen = torch.Generator(device="cuda").manual_seed(7)
    qkv = [torch.randn((B, S, H, hd), generator=gen,
                       device="cuda").requires_grad_(True)
           for S in (T, Sk, Sk)]
    go = torch.randn((B, T, H, hd), generator=gen, device="cuda")

    def fwd():
        with torch.no_grad():
            FA.flash_mha(*qkv, causal=causal)

    def both():
        torch.autograd.grad(FA.flash_mha(*qkv, causal=causal), qkv, go)
    f, b = device_ms(fwd, iters=5), device_ms(both, iters=5)
    del qkv, go
    torch.cuda.empty_cache()
    return dict(shape=[B, T, Sk, H, hd], causal=causal, forward_ms=f,
                forward_backward_ms=b, backward_ms=b - f)


def _dense_f64_evidence(grads_fn, g_k, g_p, dev):
    """Where the kernel path misses the plain path: both against a
    reference whose attention runs in f64 (``_AttentionInF64``), per
    leaf, so that a bound can rest on that evidence."""
    with _AttentionInF64():
        g_r = grads_fn()
    ref = {n: g.detach().cpu() for n, g in g_r.items()}
    del g_r
    return dict(kernel_vs_f64_attention=_leaf_summary(
        _host_rel(g_k, ref, dev)), plain_vs_f64_attention=_leaf_summary(
        _host_rel(g_p, ref, dev)))


def _lm_grads(cfg, model, host, batch, impl):
    """Step-0 gradients of the LM objective from the init (``host``):
    the forward and backward of ``make_lm_train_step``, no update."""
    import torch
    from repro_torch.core import train_step as TS
    from repro_torch.models import backbones as BB
    st = _fresh_state(model, host)
    with torch.enable_grad():
        loss, _ = BB.lm_loss(st["params"], cfg, batch, impl=impl)
        return TS.param_grads(loss, st["params"])


def _dense_lm(checks, cfg, model, host, batches, hg):
    """The LM objective here, from the launcher's init (``host``) on its
    first 3 batches: a profiled kernel-path step, then a timed one (its
    launches exact, its peak memory), neither copying anything to the
    host; the kernel path's step-0 gradients from a forward and backward
    of their own; 3 plain-path steps whose step-0 gradients are held to
    those per leaf (``TOL_DENSE_GRAD``); K3's backward timed at the layer
    shape.  Returns the step-0 metrics and the plain path's record."""
    import torch
    from repro_torch.launch import steps as ST
    dev = next(model.parameters()).device
    make = {impl: ST.make_lm_train_step(
        cfg, lr=HYBRID_LR, wd=0.1, total_steps=3, impl=impl,
        device=dev)[0] for impl in ("flash", "chunked")}
    out, seconds = {}, {}
    t0 = time.monotonic()

    def lap(part):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[part] = time.monotonic() - t0
        t0 = time.monotonic()
    # a profiled step first (it also takes the first call's costs: the
    # allocator's growth, library handles), then the same step timed
    state = _fresh_state(model, host)
    held = {}

    def one():
        held["out"] = make["flash"](state, batches[0][1])
    prof = _profile(one, categories=DENSE_TRAIN_CATEGORIES, host_ops=False)
    del held, state
    torch.cuda.empty_cache()
    lap("profiled_step")
    state = _fresh_state(model, host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (state, m), ms, n = _timed(lambda: make["flash"](state, batches[0][1]))
    want = _dense_step_launches(cfg, 1, False)
    timed = dict(ms_per_step=ms, launches=n, launches_want=want,
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 loss=float(m["loss"]))
    del state
    torch.cuda.empty_cache()
    checks.check(n == want, f"dense_train_lm: launches of one step {n}, "
                 f"want {want}")
    out["metrics0"] = {"loss": timed["loss"]}
    lap("timed_step")
    hg["kernel"].take(_lm_grads(cfg, model, host, batches[0][1], "flash"))
    torch.cuda.empty_cache()
    lap("kernel_grads")
    # the plain path, 3 steps; step 0's gradients against the kernel's
    state = _fresh_state(model, host)
    rec_p, ms_p = [], []
    for i, (_, b) in enumerate(batches):
        with _CaptureGrads(hg["plain"].take if i == 0 else lambda g: None):
            (state, m), ms, _ = _timed(lambda: make["chunked"](state, b))
        rec_p.append({k: float(v) for k, v in m.items()})
        ms_p.append(ms)
    del state
    torch.cuda.empty_cache()
    lap("plain_steps")
    rel = _host_rel(hg["kernel"].buf, hg["plain"].buf, dev)
    bound = TOL_DENSE_GRAD["lm"]
    worst = max(rel, key=rel.get)
    evidence = None
    if not all(math.isfinite(v) and v <= bound for v in rel.values()):
        evidence = _dense_f64_evidence(
            lambda: _lm_grads(cfg, model, host, batches[0][1], "chunked"),
            hg["kernel"].buf, hg["plain"].buf, dev)
        lap("f64_attention_reference")
    checks.check(all(math.isfinite(v) and v <= bound for v in rel.values()),
                 f"dense_train_lm: step-0 grads kernel vs plain, worst leaf "
                 f"{worst} rel L2 {rel[worst]}, bound {bound}")
    B, T = batches[0][1]["tokens"].shape
    backward = _attn_backward_ms(B, T, cfg.n_heads, cfg.resolved_head_dim)
    lap("k3_backward_timing")
    # the device's idle share of the timed (unprofiled) step: the same
    # work as the profiled one, so a negative share would show a mismatch
    prof["idle_share_of_timed_step"] = 1.0 - prof["device_busy_ms"] / timed[
        "ms_per_step"]
    out["record_plain"] = rec_p
    emit("dense_train_lm_device", batch_on_device=True, timed_step=timed,
         grad_leaves=len(rel), grads_kernel_vs_plain=_leaf_summary(rel),
         grad_bound=bound, f64_attention_evidence=evidence,
         # step 0's includes the copy of its gradients to the host
         ms_per_step_plain_path=ms_p,
         losses_plain=[r["loss"] for r in rec_p], profile=prof,
         k3_backward_per_call=backward, seconds=seconds)
    return out


def _dense_contrastive(checks, cfg, model, host, batches, hg):
    """The contrastive objective (v3) here, from the same init on the
    launcher's first batches at 64 x 256: two kernel-path steps timed,
    launches exact, then step-0 gradients of both paths held to each
    other per leaf (``TOL_DENSE_GRAD``)."""
    import torch
    from repro_torch.core import train_step as TS
    tcs = {impl: _hybrid_ctr_config(cfg, impl, loss_impl)
           for impl, loss_impl in (("flash", "fused"), ("chunked", "dense"))}
    fc_cfg = tcs["flash"].fc
    dev = next(model.parameters()).device
    step = TS.make_train_step(tcs["flash"], dev)
    seconds = {}
    t0 = time.monotonic()
    state = _fresh_state(model, host, fc_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, launches, metrics = [], [], []
    for idx, b in batches[:2]:
        (state, m), t, n = _timed(lambda: step(state, b, idx))
        ms.append(t)
        launches.append(n)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    want = _dense_step_launches(cfg, 1, True)
    checks.check(launches == [want] * 2 and all(
        math.isfinite(m["loss"]) for m in metrics),
        f"dense_train_contrastive: launches per step {launches}, want "
        f"{want}; metrics {metrics}")
    seconds["two_kernel_steps"] = time.monotonic() - t0
    t0 = time.monotonic()

    def grads(impl):
        tc = tcs[impl]
        st = _fresh_state(model, host, fc_cfg)
        idx, b = batches[0]
        core = TS.make_loss_core(tc.fc, tc.loss_impl)
        return TS.step_grads(tc, core, st, b, idx,
                             tc.fc.gamma_fn()(st["step"]))[2]
    for impl, key in (("flash", "kernel"), ("chunked", "plain")):
        hg[key].take(grads(impl))
        torch.cuda.empty_cache()
    rel = _host_rel(hg["kernel"].buf, hg["plain"].buf, dev)
    seconds["grads_kernel_plain"] = time.monotonic() - t0
    bound = TOL_DENSE_GRAD["contrastive"]
    worst = max(rel, key=rel.get)
    evidence = None
    if not all(math.isfinite(v) and v <= bound for v in rel.values()):
        evidence = _dense_f64_evidence(lambda: grads("chunked"),
                                       hg["kernel"].buf, hg["plain"].buf,
                                       dev)
    checks.check(all(math.isfinite(v) and v <= bound for v in rel.values()),
                 f"dense_train_contrastive: step-0 grads kernel vs plain, "
                 f"worst leaf {worst} rel L2 {rel[worst]}, bound {bound}")
    emit("dense_train_contrastive_device", batch_on_device=True,
         shape=list(batches[0][1]["tokens"].shape), ms_per_step=ms,
         launches_per_step=launches, launches_want=want, metrics=metrics,
         max_memory_allocated=peak, grad_leaves=len(rel),
         grads_kernel_vs_plain=_leaf_summary(rel), grad_bound=bound,
         f64_attention_evidence=evidence, seconds=seconds)
    return {k: 2 * v for k, v in want.items()}


def _dense_mesh_batches(cfg, rank, steps, full):
    """The first ``steps`` (idx, batch) at 64 x 256 of a 2-shard loader
    of ``PairedEmbeddingDataset``: this rank's rows, or (``full``) the
    whole global batch, on the card."""
    import numpy as np
    import torch
    from repro_torch.data import PairedEmbeddingDataset, ShardedLoader
    ds = PairedEmbeddingDataset(n=HYBRID_N_SAMPLES, seq_len=256,
                                vocab_size=cfg.vocab_size)
    loader = ShardedLoader(ds, global_batch=64, n_shards=2, seed=0,
                           owned_shards=None if full else (rank,))
    out = []
    for _, _, idx, batch in loader.steps(steps):
        idx = idx if full else loader._owned_rows(idx)
        out.append((torch.from_numpy(np.asarray(idx)).cuda(),
                    {k: torch.from_numpy(v).cuda() for k, v in batch.items()}))
    return out


def _await_signal(path, timeout=900.0):
    """The word in ``path`` ("go" or "stop") once the file is there."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                word = f.read().strip()
            if word:
                return word
        time.sleep(0.2)
    raise TimeoutError(f"no signal in {path} after {timeout} s")


def _signal(path, word):
    """Write ``word`` to ``path`` atomically (once: a later word is
    ignored)."""
    if not os.path.exists(path):
        with open(path + ".tmp", "w") as f:
            f.write(word)
        os.replace(path + ".tmp", path)


def _mesh_local_vs_one(mesh, dims, start, now, one, loss_one, loss_mesh):
    """``_mesh_vs_one``'s report from this rank's shards alone: the mesh's
    state after a step (``now``) against one device's after the same step
    from the same ``start`` (``one``: this rank's slices of it, on the
    host), all flat; each sum over a sharded leaf or a sample-owned row
    added over the ranks (a replicated leaf counted once), each max taken
    over them."""
    import torch
    import torch.distributed as dist
    groups = _leaf_groups(dims)
    params = [p for ps in groups.values() for p in ps]
    # per leaf: |du - du_one|^2, |du_one|^2, |m - m_one|^2, |m_one|^2,
    # entries more than 5e-5 from one device's
    sums = torch.zeros((len(params), 5), dtype=torch.float64)
    dparam = dlogu = 0.0
    for i, p in enumerate(params):
        if dims[p] is None and mesh.rank:
            continue
        x, x0 = now[f"params/{p}"], start[f"params/{p}"]
        y = one[f"params/{p}"].to(x.device)
        du, du_one = (x - x0).double(), (y - x0).double()
        m = now[f"opt/m/{p}"].double()
        m_one = one[f"opt/m/{p}"].to(x.device).double()
        d = (x - y).abs()
        sums[i] = torch.stack([(du - du_one).square().sum(),
                               du_one.square().sum(),
                               (m - m_one).square().sum(),
                               m_one.square().sum(),
                               (d > 5e-5).sum().double()]).cpu()
        dparam = max(dparam, float(d.max()))
    for k in now:
        if k.startswith(("fc/u1", "fc/u2")):
            a = now[k].double()
            b = one[k].to(a.device).double()
            d = (a - b).abs()
            d[a == b] = 0.0                      # matching -inf log-u rows
            dlogu = max(dlogu, float(d.max()) if d.numel() else 0.0)
    maxes = torch.tensor([dparam, dlogu], dtype=torch.float64)
    dist.all_reduce(sums)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX)
    s = sums.tolist()
    at = {p: i for i, p in enumerate(params)}

    def rel(num, den):
        return math.sqrt(num / max(den, 1e-300))

    def group_rel(ps, a, b):
        return rel(sum(s[at[p]][a] for p in ps), sum(s[at[p]][b] for p in ps))
    leaf_upd = {p: rel(s[at[p]][0], s[at[p]][1]) for p in params}
    leaf_mom = {p: rel(s[at[p]][2], s[at[p]][3]) for p in params}
    return dict(
        moment_rel_l2={g: group_rel(ps, 2, 3) for g, ps in groups.items()},
        update_rel_l2={g: group_rel(ps, 0, 1) for g, ps in groups.items()},
        same_keys=sorted(now) == sorted(one),
        dloss=abs(loss_mesh - loss_one), dparam=float(maxes[0]),
        dlogu=float(maxes[1]),
        params_over_5e_5=int(sum(r[4] for r in s)),
        params_moved=sum(r[1] > 0 for r in s), params=len(params),
        update_worst_leaf=max(leaf_upd, key=leaf_upd.get),
        update_worst_rel_l2=max(leaf_upd.values()),
        moment_worst_leaf=max(leaf_mom, key=leaf_mom.get),
        moment_worst_rel_l2=max(leaf_mom.values()))


def _to(tree, device):
    """A nested dict of tensors, each leaf moved to ``device``."""
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _mesh_worker_lm(argv, arch, layers, together=False):
    """One rank of ``arch`` at full width and ``layers`` layers (phase
    dense_train's qwen3-1.7b, phase moe_train's qwen3-moe) on
    data:1,fsdp:2 (2 ranks sharing the card; spawned by those phases,
    never by hand): the init on the host; once ``argv[0]`` says "go",
    each rank in turn (``together``: both at once, where two whole
    states fit the card) runs one device's 2 steps on the whole global
    batch from the init and keeps its own shards of the state after each
    on the host (the card holds one whole state at a time); then the 2
    contrastive ZeRO steps over the rank's rows, their launches and ms,
    the first from the init and the second from one device's state after
    its first step, each held to one device's step from the same state
    through this rank's shards alone (``_mesh_local_vs_one``: gathering
    the whole states over gloo took ~23 s a step at qwen3-moe's 1.25 B
    parameters)."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import bridge, flatten
    from repro_torch.configs import get_arch
    from repro_torch.core import shard_state as SS
    from repro_torch.core import train_step as TS
    from repro_torch.core.schedules import lr_warmup_cosine
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import multiprocess as MP
    signal_path = argv[0]
    rank = int(argv[argv.index("--process-id") + 1])
    dev = MP.initialize(argv[argv.index("--coordinator") + 1],
                        int(argv[argv.index("--num-processes") + 1]), rank,
                        "cuda")
    rep = {"mesh_rank": rank, "steps": []}
    try:
        mesh = MS.make_train_mesh(1, 2, device=dev)
        rep["backend"] = mesh.backend
        cfg = get_arch(arch).replace(n_layers=layers)
        tc1 = dataclasses.replace(_hybrid_ctr_config(cfg, "flash", "fused"),
                                  lr_fn=lr_warmup_cosine(HYBRID_LR, 0, 2))
        step = TS.make_train_step(dataclasses.replace(
            tc1, fsdp=True, mesh_axes=MESH_AXES))
        dims = step.param_dims
        rep["leaves"] = {g: len(ps) for g, ps in _leaf_groups(dims).items()}
        st1 = TS.init_train_state(torch.Generator().manual_seed(0), tc1,
                                  "cpu")
        rep["n_params"] = sum(p.numel() for p in st1["params"].parameters())
        # the init's leaves themselves: nothing writes to them
        tree = bridge.state_to_tree(st1)
        if _await_signal(signal_path) != "go":
            rep["stopped"] = True
            print(json.dumps(rep), flush=True)
            return
        full = _dense_mesh_batches(cfg, rank, 2, full=True)
        t0 = time.monotonic()
        ones, loss_one = [], []
        for turn in range(1 if together else mesh.world_size):
            if together or turn == rank:
                st = bridge.state_from_tree(
                    {**st1, "params": st1["params"].cuda()}, tree)
                fn1 = TS.make_train_step(tc1, "cuda")
                for idx, batch in full:
                    st, m1 = fn1(st, batch, idx)
                    loss_one.append(float(m1["loss"]))
                    ones.append(_to(SS.shard_train_state(
                        bridge.state_to_tree(st), mesh, dims), "cpu"))
                del st, st1, fn1
                # this rank's shards of the init, the first step's start
                s = SS.shard_train_state(tree, mesh, dims)
                del tree
                torch.cuda.empty_cache()
            torch.distributed.barrier()
        rep["one_device_seconds"] = time.monotonic() - t0
        local = _dense_mesh_batches(cfg, rank, 2, full=False)
        torch.cuda.reset_peak_memory_stats()
        for k, (idx, batch) in enumerate(local):
            if k:
                s = _to(ones[k - 1], dev)      # one device's start
            start = {p: v.clone() for p, v in flatten(s).items()
                     if p.startswith("params/")}
            torch.cuda.synchronize()
            torch.distributed.barrier()      # both ranks start together
            _zero_counters()
            t0 = time.monotonic()
            s, m = step(s, batch, idx)
            torch.cuda.synchronize()
            res = dict(launches=_counters(), loss=float(m["loss"]),
                       lr=float(m["lr"]),
                       ms=(time.monotonic() - t0) * 1e3)
            if k == 0:
                rep["max_memory_allocated_step"] = (
                    torch.cuda.max_memory_allocated())
            t1 = time.monotonic()
            res.update(_mesh_local_vs_one(mesh, dims, start, flatten(s),
                                          flatten(ones[k]), loss_one[k],
                                          res["loss"]))
            res["compare_s"] = time.monotonic() - t1
            rep["steps"].append(res)
            del start
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    finally:
        MS.set_mesh(None)
        MP.shutdown()
    print(json.dumps(rep), flush=True)


def _dense_mesh(checks, spawned, t0, arch=DENSE_ARCH,
                layers=DENSE_MESH_LAYERS, name="dense_train_mesh",
                phase="dense_train"):
    """P6a': an LM backbone's contrastive objective on data:1,fsdp:2 (2
    gloo ranks on the card) at full width and ``layers`` layers
    (qwen3-1.7b at ``DENSE_MESH_LAYERS``, or qwen3-moe at
    ``MOE_MESH_LAYERS``), 2 steps that both move the params, each
    against one device from the same state at phase rn50_mesh's bounds
    (loss 1e-5 and log-u 1e-4 max abs; moments and update by relative L2
    per group of leaves); exact launches per rank and step.
    ``spawned``: the ranks' future (started at ``t0``, told to go)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).replace(n_layers=layers)
    t_go = time.monotonic()
    res, reps = spawned.result()
    wall = time.monotonic() - t0
    rcs = [r.returncode for r in res]
    for r in res:
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr, flush=True)
    checks.check(rcs == [0, 0] and all(reps),
                 f"{name}: exit codes {rcs}")
    checks.end_phase(phase)
    want = _dense_step_launches(cfg, 1, True)
    want = {k: v for k, v in want.items() if not k.startswith("ssd")}
    per_step = [[st["launches"] for st in rp["steps"]] for rp in reps]
    checks.check(per_step == [[want] * 2] * 2,
                 f"{name}: launches per step {per_step}, want "
                 f"{want}")
    for k, st in enumerate(reps[0]["steps"]):
        ok = (st["same_keys"] and st["lr"] > 0
              and st["params_moved"] == st["params"]
              and st["dloss"] <= 1e-5 and st["dlogu"] <= 1e-4
              and all(v <= TOL_MESH_MOMENT
                      for v in st["moment_rel_l2"].values())
              and all(v <= TOL_MESH_UPDATE[k]
                      for v in st["update_rel_l2"].values()))
        checks.check(ok, f"{name}: step {k} vs one device {st}")
    emit(name, mesh="data:1,fsdp:2", arch=arch,
         n_layers=layers, n_params=reps[0].get("n_params"),
         exit_codes=rcs, backend=reps[0].get("backend"),
         launches_per_step=per_step[0], launches_want=want,
         ms_per_step_per_rank=[[st["ms"] for st in rp["steps"]]
                               for rp in reps],
         steps=reps[0]["steps"],
         bounds=dict(loss=1e-5, log_u=1e-4,
                     moments_group_rel_l2=TOL_MESH_MOMENT,
                     update_group_rel_l2_per_step=TOL_MESH_UPDATE),
         leaves=reps[0].get("leaves"),
         max_memory_allocated_per_rank=[rp.get("max_memory_allocated")
                                        for rp in reps],
         one_device_seconds=reps[0].get("one_device_seconds"),
         wall_seconds=wall, seconds_after_go=time.monotonic() - t_go)
    return per_step[0][0]


def _dense_train_launches(dense_train, kernel):
    """One kernel's launches in phase dense_train's runs."""
    return {run: dense_train[run][kernel]
            for run in ("lm", "contrastive", "mesh_per_rank_per_step")}


def phase_dense_train(checks, child=None):
    """qwen3-1.7b at full width and ``DENSE_TRAIN_LAYERS`` layers trained
    (f32, seed 0): the LM launcher in a child process (3 steps at 2 x
    4096), the same init and batches here
    under both objectives (``_dense_lm``, ``_dense_contrastive``), and
    the contrastive objective on data:1,fsdp:2 (``_dense_mesh``), whose
    ranks start with the phase and do their host work beside the others,
    but touch the card only once these are done.  ``child``: a held
    ``_LauncherProcess`` for the LM launcher.  Returns the kernels'
    launches per run."""
    import concurrent.futures

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    cfg = get_arch(DENSE_ARCH).replace(n_layers=DENSE_TRAIN_LAYERS)
    t_phase = time.monotonic()
    torch.cuda.empty_cache()      # the card's memory to the child
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dense_")
    signal_path = os.path.join(tmp, "signal")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        spawned = pool.submit(_spawn_mesh, "dense", [signal_path], 1200,
                              nproc=2)
        child = (child or _LauncherProcess()).start(
            DENSE_LM_ARGS, layers=DENSE_TRAIN_LAYERS)
        try:
            # the launcher's init, drawn on the host as the launcher draws
            # it, while the child trains (nothing of this process on the
            # card)
            host_model = BB.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu")
            host = {n: p.detach().pin_memory()
                    for n, p in host_model.named_parameters()}
            del host_model
        finally:
            finished = child.finish(900)
        t_child = time.monotonic() - t_phase
        torch.cuda.empty_cache()
        model = BB.meta_model(cfg).to_empty(device="cuda")
        hg = {k: _HostGrads(model) for k in ("kernel", "plain")}
        lm = _dense_lm(checks, cfg, model, host, _hybrid_batches(cfg, "lm"),
                       hg)
        out = {"lm": _hybrid_launcher_checks(
            checks, "dense_train_lm", cfg, finished, child.lines, lm, False,
            want=_dense_step_launches(cfg, 3, False), phase="dense_train")}
        t_lm = time.monotonic() - t_phase
        out["contrastive"] = _dense_contrastive(
            checks, cfg, model, host, _hybrid_batches(cfg, "contrastive"),
            hg)
        del model, host, hg
        torch.cuda.empty_cache()
        t_ctr = time.monotonic() - t_phase - t_lm
        checks.end_phase("dense_train")
        _signal(signal_path, "go")
        out["mesh_per_rank_per_step"] = _dense_mesh(checks, spawned, t_phase)
    finally:
        _signal(signal_path, "stop")      # no-op after "go"
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    emit("dense_train_seconds", seconds=time.monotonic() - t_phase,
         lm_child_seconds=t_child, lm_seconds=t_lm,
         contrastive_seconds=t_ctr)
    checks.end_phase("dense_train")
    return out


# ---------------------------------------------------------------------------
# Phase moe_train: qwen3-moe-30b-a3b trained under both objectives, and its
# contrastive objective on the (data, fsdp) mesh
# ---------------------------------------------------------------------------

# phase moe_train's depth: 2 of qwen3-moe-30b-a3b's 48 layers at full width
# (JAX's rule recomputes each super-block on its own below 8).  A train
# step holds the params, the gradients, both AdamW moments and, while
# ``adamw().update`` returns, the new params and moments: 7 times the f32
# params (qwen3-1.7b's full-depth step peaked at 7.0 of them), 87.2 GB at 4
# layers and 69.8 GB at 3 (``--only moe_depth`` tries 4).  3 until the
# xLSTM's phases needed the run's time: at 2 the gradient still crosses a
# recomputed MoE layer, its K3 and its dispatch backward, into the one
# below (PERF.md § 4)
MOE_TRAIN_LAYERS = 2
# data:1,fsdp:2 (2 gloo ranks sharing the card) at 1 of the 48 layers
MOE_MESH_LAYERS = 1
MOE_LM_ARGS = ["--arch", MOE_ARCH, "--objective", "lm", "--global-batch",
               "2", "--seq-len", "4096", "--steps", "3", "--log-every", "1",
               "--device", "cuda", "--seed", "0", "--precision", "f32"]
# an MoE training step's kernels by what they compute; the rest
# (elementwise, reductions, copies) under "other"
MOE_TRAIN_CATEGORIES = (
    ("k3_flash_attention", ("flash",)),
    ("k1_k2_fcco", ("stats_partial", "stats_merge", "grads_weights",
                    "grads_product")),
    ("gemm", ("gemm", "gemv")),
    # the routing's sorts and their backward, the dispatch and combine
    # (gathers, index_select / index_copy, scatters)
    ("moe_sort_gather_index", ("sort", "Sort", "scatter", "gather",
                               "index")),
)


def _forced_route(probs, k, C, r):
    """``r``'s choices (``experts``) and picks on this call's router
    probabilities: the gates and selection weights are gathered from
    ``probs`` at those indices (the values ``route`` takes when it makes
    the same choices, and the gradient it gives them)."""
    import torch
    from repro_torch.models import moe as M
    gates = torch.gather(probs, -1, r.experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    sel = torch.zeros_like(probs).scatter_(-1, r.experts, gates)
    return M.Route(gates, r.experts,
                   torch.gather(sel.transpose(1, 2), -1, r.picks), r.picks)


def _routes_equal(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _load(model, host):
    import torch
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(host[n], non_blocking=True)


def _recompute_order(cfg):
    """The layers of the route calls a backward's recomputes make, in
    call order: the groups last first, each group's layers in order."""
    from repro_torch.models import layers as L
    n = cfg.n_layers // cfg.moe.every
    g = L.default_remat_group(n)
    if g <= 1 or n % g or n <= g:
        g = 1
    return [i for s in reversed(range(0, n, g)) for i in range(s, s + g)]


def _moe_lm_grads(cfg, model, host, batch, impl, routes):
    """Step-0 gradients of the LM objective from the init (``host``), no
    optimizer state, ``models.moe.route`` under ``routes`` (a
    ``_Routes``)."""
    import torch
    from repro_torch.core import train_step as TS
    from repro_torch.models import backbones as BB
    _load(model, host)
    with routes, torch.enable_grad():
        loss, _ = BB.lm_loss(model, cfg, batch, impl=impl)
        return TS.param_grads(loss, model)


def _dispatch_backward_ms(cfg, r, B, S):
    """CUDA events at a layer's shape, on the routing ``r``: the
    deterministic dispatch backward (``models.moe.dispatch_backward``,
    an expert at a time) per call, and the gather's own autograd backward
    (one ``index_put_`` accumulating with atomics) on the same
    gradient."""
    import torch
    from repro_torch.models import moe as M
    E, C = cfg.moe.n_experts, r.picks.shape[-1]
    dev = r.picks.device
    idx = (r.picks + S * torch.arange(B, device=dev)[:, None, None]
           ).transpose(0, 1).reshape(E, B * C)
    g = torch.randn((E, B * C, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    det = M.dispatch_backward(g, idx, B * S)
    acc = torch.zeros_like(det).index_put_((idx,), g, accumulate=True)
    out = dict(shape=[E, B * C, cfg.d_model], rows=B * S,
               deterministic_ms=device_ms(
                   lambda: M.dispatch_backward(g, idx, B * S), 5),
               atomic_index_put_ms=device_ms(
                   lambda: torch.zeros_like(det).index_put_(
                       (idx,), g, accumulate=True), 5),
               max_abs_diff_vs_atomic=(det - acc).abs().max().item())
    del g, det, acc
    torch.cuda.empty_cache()
    return out


def _moe_lm(checks, cfg, model, host, batches):
    """The LM objective here, from the launcher's init (``host``) on its
    first batch: a profiled kernel-path step, then a timed one (launches
    exact, peak memory); the kernel path's step-0 gradients twice, to
    the bit, each recompute routing as its forward; the plain path's on
    the kernel path's routes, each leaf within ``TOL_TRAIN_GRAD``; the
    unforced plain routing's differences (``MOE_ROUTE_DIFF_CEILING``);
    K3's backward and the dispatch backward timed at the layer shape."""
    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.models import backbones as BB
    dev = next(model.parameters()).device
    m_cfg = cfg.moe
    n_super = cfg.n_layers // m_cfg.every
    make = ST.make_lm_train_step(cfg, lr=HYBRID_LR, wd=0.1, total_steps=3,
                                 device=dev)[0]
    batch = batches[0][1]
    seconds = {}
    t0 = time.monotonic()

    def lap(part):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[part] = time.monotonic() - t0
        t0 = time.monotonic()
    state = _fresh_state(model, host)
    held = {}

    def one():
        held["out"] = make(state, batch)
    prof = _profile(one, categories=MOE_TRAIN_CATEGORIES, host_ops=False)
    del held, state
    torch.cuda.empty_cache()
    lap("profiled_step")
    state = _fresh_state(model, host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (state, m), ms, n = _timed(lambda: make(state, batch))
    peak = torch.cuda.max_memory_allocated()
    metrics0 = {k: float(v) for k, v in m.items()}
    del state
    torch.cuda.empty_cache()
    want = _dense_step_launches(cfg, 1, False)
    checks.check(n == want and sorted(metrics0) == [
        "ce", "loss", "moe_lb", "moe_z"] and all(
            math.isfinite(v) for v in metrics0.values()),
        f"moe_train_lm: launches of one step {n}, want {want}; metrics "
        f"{metrics0}")
    lap("timed_step")
    # the kernel path's gradients twice from one state
    rk, rk2 = _Routes(), _Routes()
    g_k = _moe_lm_grads(cfg, model, host, batch, "flash", rk)
    g_k2 = _moe_lm_grads(cfg, model, host, batch, "flash", rk2)
    differ = [k for k in g_k if not torch.equal(g_k[k], g_k2[k])]
    del g_k2
    torch.cuda.empty_cache()
    fwd = rk.calls[:n_super]
    order = _recompute_order(cfg)
    recompute_as_forward = len(rk.calls) == 2 * n_super and all(
        _routes_equal(rk.calls[n_super + i], fwd[s])
        for i, s in enumerate(order))
    routes_repeat = len(rk2.calls) == len(rk.calls) and all(
        _routes_equal(a, b) for a, b in zip(rk.calls, rk2.calls))
    del rk2
    checks.check(not differ and recompute_as_forward and routes_repeat,
                 f"moe_train_lm: two backward passes differ in "
                 f"{differ[:8]}; recomputes route as forward "
                 f"{recompute_as_forward}; routes repeat {routes_repeat}")
    lap("kernel_grads_twice")
    # the plain path on the kernel path's routes (the kernel path's
    # gradients wait on the host: the plain attention's recompute needs
    # their room)
    hk = _HostGrads(model)
    hk.take(g_k)
    del g_k
    torch.cuda.empty_cache()
    rp = _Routes(rk.calls, rederive=True)
    g_p = _moe_lm_grads(cfg, model, host, batch, "chunked", rp)
    rel = _host_rel(hk.buf, g_p, dev)
    replayed = len(rp.calls)
    del g_p, hk, rp
    torch.cuda.empty_cache()
    bound = TOL_TRAIN_GRAD
    worst = max(rel, key=rel.get)
    checks.check(replayed == 2 * n_super and all(
        math.isfinite(v) and v <= bound for v in rel.values()),
        f"moe_train_lm: step-0 grads kernel vs plain on the kernel path's "
        f"routes, worst leaf {worst} rel L2 {rel[worst]}, bound {bound}")
    lap("plain_grads_replayed")
    # the plain path unforced: its routing against the kernel path's
    with _Routes() as ru, torch.no_grad():
        BB.forward_hidden(model, cfg, batch, impl="chunked")
    choices, picks = _route_diffs(fwd, ru.calls, m_cfg.n_experts)
    checks.check(sum(choices) + sum(picks) <= MOE_ROUTE_DIFF_CEILING,
                 f"moe_train_lm: unforced routing differs from the plain "
                 f"path's in {choices} choices, {picks} picks per layer "
                 f"(ceiling {MOE_ROUTE_DIFF_CEILING} in all)")
    lap("unforced_plain_routes")
    B, T = batch["tokens"].shape
    backward = _attn_backward_ms(B, T, cfg.n_heads, cfg.resolved_head_dim)
    dispatch = _dispatch_backward_ms(cfg, fwd[0], B, T)
    lap("k3_and_dispatch_backward_timing")
    prof["idle_share_of_timed_step"] = 1.0 - prof["device_busy_ms"] / ms
    emit("moe_train_lm_device", batch_on_device=True, n_layers=cfg.n_layers,
         timed_step=dict(ms_per_step=ms, launches=n, launches_want=want,
                         max_memory_allocated=peak, metrics=metrics0),
         grad_leaves=len(rel), grads_kernel_vs_plain=_leaf_summary(rel),
         grad_bound=bound, two_backward_passes_equal=not differ,
         recomputes_route_as_forward=recompute_as_forward,
         routes_repeat=routes_repeat,
         unforced_choices_differ_per_layer=choices,
         unforced_picks_differ_per_layer=picks,
         route_diff_ceiling=MOE_ROUTE_DIFF_CEILING,
         dropped_per_layer=[int(r.experts.numel()) - int((r.pick_w > 0).sum())
                            for r in fwd],
         profile=prof, k3_backward_per_call=backward,
         dispatch_backward_per_layer=dispatch,
         dispatch_backward_ms_per_step=dispatch["deterministic_ms"]
         * n_super, seconds=seconds)
    return {"metrics0": metrics0}


def _moe_contrastive(checks, cfg, model, host, batches):
    """The contrastive objective (v3) here, from the same init on the
    launcher's first batches at 64 x 256: two kernel-path steps timed,
    launches exact (K3, and K1 and K2 once a step); step-0 gradients of
    the plain path on the kernel path's routes, each leaf within
    ``TOL_TRAIN_GRAD``; the unforced routing's differences."""
    import torch
    from repro_torch.core import fastclip as FC
    from repro_torch.core import train_step as TS
    from repro_torch.models import backbones as BB
    tcs = {impl: _hybrid_ctr_config(cfg, impl, loss_impl)
           for impl, loss_impl in (("flash", "fused"), ("chunked", "dense"))}
    fc_cfg = tcs["flash"].fc
    dev = next(model.parameters()).device
    n_super = cfg.n_layers // cfg.moe.every
    step = TS.make_train_step(tcs["flash"], dev)
    seconds = {}
    t0 = time.monotonic()
    state = _fresh_state(model, host, fc_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, launches, metrics = [], [], []
    for idx, b in batches[:2]:
        (state, m), t, n = _timed(lambda: step(state, b, idx))
        ms.append(t)
        launches.append(n)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    want = _dense_step_launches(cfg, 1, True)
    checks.check(launches == [want] * 2 and all(
        math.isfinite(m["loss"]) for m in metrics),
        f"moe_train_contrastive: launches per step {launches}, want "
        f"{want}; metrics {metrics}")
    seconds["two_kernel_steps"] = time.monotonic() - t0
    t0 = time.monotonic()

    def grads(impl, routes):
        tc = tcs[impl]
        _load(model, host)
        st = {"params": model, "fc": FC.init_state(fc_cfg, dev),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        idx, b = batches[0]
        core = TS.make_loss_core(tc.fc, tc.loss_impl)
        with routes:
            return TS.step_grads(tc, core, st, b, idx,
                                 tc.fc.gamma_fn()(st["step"]))[2]
    rk = _Routes()
    g_k = grads("flash", rk)
    rp = _Routes(rk.calls, rederive=True)
    g_p = grads("chunked", rp)
    rel = _grads_rel(g_k, g_p)
    del g_k, g_p
    torch.cuda.empty_cache()
    with _Routes() as ru, torch.no_grad():
        BB.forward_hidden(model, cfg, {"tokens": batches[0][1]["tokens"]},
                          impl="chunked")
    choices, picks = _route_diffs(rk.calls[:n_super], ru.calls,
                                  cfg.moe.n_experts)
    seconds["grads_kernel_plain"] = time.monotonic() - t0
    bound = TOL_TRAIN_GRAD
    worst = max(rel, key=rel.get)
    checks.check(len(rp.calls) == 2 * n_super and all(
        math.isfinite(v) and v <= bound for v in rel.values()),
        f"moe_train_contrastive: step-0 grads kernel vs plain on the "
        f"kernel path's routes, worst leaf {worst} rel L2 {rel[worst]}, "
        f"bound {bound}")
    checks.check(sum(choices) + sum(picks) <= MOE_ROUTE_DIFF_CEILING,
                 f"moe_train_contrastive: unforced routing differs in "
                 f"{choices} choices, {picks} picks per layer")
    emit("moe_train_contrastive_device", batch_on_device=True,
         shape=list(batches[0][1]["tokens"].shape), ms_per_step=ms,
         launches_per_step=launches, launches_want=want, metrics=metrics,
         max_memory_allocated=peak, grad_leaves=len(rel),
         grads_kernel_vs_plain=_leaf_summary(rel), grad_bound=bound,
         unforced_choices_differ_per_layer=choices,
         unforced_picks_differ_per_layer=picks, seconds=seconds)
    return {k: 2 * v for k, v in want.items()}


def _moe_launcher_checks(checks, cfg, finished, lines, metrics0):
    """The LM launcher's child process (3 kernel-path steps): exit 0, 3
    step lines logging ``moe_lb`` and ``moe_z``, finite losses, launches
    exact, f32 masters, its step-0 loss equal to the in-process one."""
    rc, rep, _, err = finished
    lines = [ln for ln in lines if ln]
    if rc or rep is None:
        print(err, file=sys.stderr, flush=True)
    if not checks.check(rc == 0 and rep is not None,
                        f"moe_train_lm: launcher process exit code {rc}"):
        checks.end_phase("moe_train")
    rec = rep["record"]
    step_lines = [ln for ln in lines if ln.startswith("step ")]
    keys = [sorted(json.loads(ln[ln.index("{"):])) for ln in step_lines]
    want = _dense_step_launches(cfg, 3, False)
    got = dict(rep["launches"], **rep["k4"])
    checks.check(got == want, f"moe_train_lm: launches {got}, want {want}")
    checks.check(len(rec) == 3 and keys == [["ce", "loss", "moe_lb",
                                             "moe_z"]] * 3
                 and all(math.isfinite(r[k]) for r in rec for k in keys[0])
                 and rep["dtype_error"] is None,
                 f"moe_train_lm: steps {len(rec)}, lines {step_lines}, "
                 f"dtypes {rep['dtype_error']}")
    checks.check(rec[0]["loss"] == metrics0["loss"],
                 f"moe_train_lm: the launcher's step-0 loss {rec[0]['loss']} "
                 f"is not the in-process one {metrics0['loss']}")
    emit("moe_train_lm_launcher", steps=3, lines=step_lines, launches=got,
         launches_want=want, by_seq=rep["by_seq"],
         losses=[r["loss"] for r in rec],
         ms_per_step_after_warmup=(rec[-1]["time"] - rec[0]["time"]) / 2
         * 1e3, max_memory_allocated=rep["max_memory_allocated"],
         wall_seconds=rep["wall_seconds"])
    return got


def phase_moe_train(checks):
    """qwen3-moe-30b-a3b at full width and ``MOE_TRAIN_LAYERS`` layers
    trained (f32, seed 0): the LM launcher in a child process (3 steps at
    2 x 4096), the same init and batches here under both objectives
    (``_moe_lm``, ``_moe_contrastive``), and the contrastive objective
    on data:1,fsdp:2 at ``MOE_MESH_LAYERS`` layers (``_dense_mesh``'s
    ranks, started with the phase, on the card once the rest is done).
    Returns the kernels' launches per run."""
    import concurrent.futures

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    cfg = get_arch(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    t_phase = time.monotonic()
    torch.cuda.empty_cache()      # the card's memory to the child
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    signal_path = os.path.join(tmp, "signal")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        spawned = pool.submit(_spawn_mesh, "moe", [signal_path], 1200,
                              nproc=2)
        child = _LauncherProcess(MOE_LM_ARGS, layers=MOE_TRAIN_LAYERS)
        try:
            # the launcher's init, drawn on the host as the launcher draws
            # it, while the child trains; each leaf freed once pinned
            host_model = BB.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu")
            host = {}
            for n, p in host_model.named_parameters():
                host[n] = p.detach().pin_memory()
                p.data = torch.empty(0)
            del host_model
        finally:
            finished = child.finish(900)
        t_child = time.monotonic() - t_phase
        torch.cuda.empty_cache()
        model = BB.meta_model(cfg).to_empty(device="cuda")
        lm = _moe_lm(checks, cfg, model, host, _hybrid_batches(cfg, "lm"))
        out = {"lm": _moe_launcher_checks(checks, cfg, finished, child.lines,
                                          lm["metrics0"])}
        t_lm = time.monotonic() - t_phase
        out["contrastive"] = _moe_contrastive(
            checks, cfg, model, host, _hybrid_batches(cfg, "contrastive"))
        del model, host
        torch.cuda.empty_cache()
        # the pinned blocks cached for the host copies back to the system,
        # for the ranks' host memory (where this torch has the call)
        getattr(torch._C, "_host_emptyCache", lambda: None)()
        t_ctr = time.monotonic() - t_phase - t_lm
        checks.end_phase("moe_train")
        _signal(signal_path, "go")
        out["mesh_per_rank_per_step"] = _dense_mesh(
            checks, spawned, t_phase, arch=MOE_ARCH, layers=MOE_MESH_LAYERS,
            name="moe_train_mesh", phase="moe_train")
    finally:
        _signal(signal_path, "stop")      # no-op after "go"
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    emit("moe_train_seconds", seconds=time.monotonic() - t_phase,
         lm_child_seconds=t_child, lm_seconds=t_lm,
         contrastive_seconds=t_ctr)
    checks.end_phase("moe_train")
    return out


def phase_moe_depth(checks):
    """A diagnostic (``--only moe_depth``): one LM step of qwen3-moe at
    full width and 4 layers (2 x 4096, f32, seed 0 drawn on the card)
    from a fresh state, the peak of its forward and backward alone and
    whether the whole step (AdamW's update included) fits the card: the
    measurement behind ``MOE_TRAIN_LAYERS``.  It checks nothing."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import train_step as TS
    from repro_torch.launch import steps as ST
    from repro_torch.models import backbones as BB
    cfg = get_arch(MOE_ARCH).replace(n_layers=4)
    torch.cuda.empty_cache()
    batch = _hybrid_batches(cfg, "lm")[0][1]
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    rec = dict(arch=MOE_ARCH, n_layers=4, n_params=n_params,
               param_bytes=4 * n_params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        loss, _ = BB.lm_loss(model, cfg, batch)
        grads = TS.param_grads(loss, model)
    torch.cuda.synchronize()
    rec["forward_backward_max_memory_allocated"] = (
        torch.cuda.max_memory_allocated())
    del grads, loss
    torch.cuda.empty_cache()
    step, opt = ST.make_lm_train_step(cfg, device="cuda")
    state = {"params": model, "opt": opt.init(
        {k: p.detach() for k, p in model.named_parameters()}),
        "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    try:
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec.update(step_fits=True, loss=float(m["loss"]))
    except torch.cuda.OutOfMemoryError as e:
        rec.update(step_fits=False, out_of_memory=str(e)[:400])
    rec["step_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["card_total_memory"] = torch.cuda.get_device_properties(
        0).total_memory
    del state, model
    torch.cuda.empty_cache()
    emit("moe_depth", **rec)
    checks.end_phase("moe_depth")


def _nested_grouped(remat, layers, f, x, *, group):
    """JAX's nested form of ``layers.run_layers_grouped``
    (``inner_remat``): each group recomputed as one and, inside it, each
    layer recomputed on its own as well."""
    from repro_torch.models import layers as L
    n = len(layers)
    if group <= 1 or n % group or n <= group:
        return L.run_layers_grouped(remat, layers, f, x, group=group)

    def body(grp):
        def run(h):
            for lyr in grp:
                h = remat(lambda y, lyr=lyr: f(lyr, y), (lyr,), h)
            return h
        return run
    for i in range(0, n, group):
        grp = layers[i:i + group]
        x = remat(body(grp), tuple(grp), x)
    return x


def phase_remat_forms(checks):
    """A diagnostic (``--only remat_forms``): full-width qwen3-1.7b's LM
    step at 2 x 4096 (f32, seed 0) under the port's one-level grouped
    recompute and under JAX's nested form (``_nested_grouped``), in the
    order one-level, nested, nested, one-level after a warm-up step:
    ms per step, peak memory, launches exact, every state equal to the
    bit."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as ST
    from repro_torch.models import backbones as BB
    from repro_torch.models import layers as L
    cfg = get_arch(DENSE_ARCH)
    torch.cuda.empty_cache()
    model = BB.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    host = {n: p.detach().cpu().pin_memory()
            for n, p in model.named_parameters()}
    batch = _hybrid_batches(cfg, "lm")[0][1]
    step = ST.make_lm_train_step(cfg, lr=HYBRID_LR, wd=0.1, total_steps=3,
                                 device="cuda")[0]
    grouped = L.run_layers_grouped
    runs = {"one_level": [], "nested": []}
    fps = {}
    try:
        for form in ("warm_up", "one_level", "nested", "nested",
                     "one_level"):
            L.run_layers_grouped = (_nested_grouped if form == "nested"
                                    else grouped)
            state = _fresh_state(model, host)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (state, m), ms, n = _timed(lambda: step(state, batch))
            fp = _fingerprints(state)
            del state
            torch.cuda.empty_cache()
            if form == "warm_up":
                continue
            want = _dense_step_launches(cfg, 1, False, form == "nested")
            checks.check(n == want, f"remat_forms {form}: launches {n}, "
                         f"want {want}")
            fps.setdefault(form, fp)
            runs[form].append(dict(
                ms_per_step=ms, loss=float(m["loss"]),
                max_memory_allocated=torch.cuda.max_memory_allocated()))
    finally:
        L.run_layers_grouped = grouped
    differ = [k for k in fps["one_level"]
              if fps["one_level"][k] != fps["nested"][k]]
    checks.check(not differ, f"remat_forms: the nested and one-level steps "
                 f"differ in {differ[:8]}")
    emit("remat_forms", arch=DENSE_ARCH, shape=[2, 4096],
         group=L.default_remat_group(cfg.n_layers), runs=runs,
         states_equal=not differ, leaves_compared=len(fps["nested"]))
    del model, host
    torch.cuda.empty_cache()
    checks.end_phase("remat_forms")


# ---------------------------------------------------------------------------
# phases vlm_train and audio_train: the cross-attention families trained
# ---------------------------------------------------------------------------

# the vlm's training depth: 5 of its 40 layers at full width, one
# super-block (4 self blocks and 1 cross block; 5 is the least depth with
# a cross block): a step holds ~7x the f32 params at AdamW's update, 61
# GB here, 283 GB at full depth; the audio model trains whole
VLM_TRAIN_LAYERS = 5
CROSS_TRAIN_PARAMS = {VLM_ARCH: 2_190_786_560, AUDIO_ARCH: 1_280_636_928}
# the LM objective's global batch (x 4096 tokens): the vlm's step at 2
# rows peaks under the card's memory (phase vlm_remat_forms measures it)
CROSS_TRAIN_LM_BATCH = {VLM_ARCH: 2, AUDIO_ARCH: 2}
# the leaves each objective does not reach: a zero gradient, moved by
# the decoupled weight decay alone (as under jax.grad)
CROSS_UNREACHED = {
    ("lm", VLM_ARCH): ("ctr_proj", "pair_proj"),
    ("lm", AUDIO_ARCH): ("ctr_proj", "pair_proj"),
    ("contrastive", VLM_ARCH): ("lm_head",),
    ("contrastive", AUDIO_ARCH): ("dec_blocks", "embed", "final_norm",
                                  "lm_head"),
}


def _cross_train_config(arch):
    return _cross_config(arch, VLM_TRAIN_LAYERS if arch == VLM_ARCH
                         else None)


def _cross_batches(cfg, kind, gb=None):
    """``_hybrid_batches`` with the family's stub input in each batch,
    drawn as the serving launcher draws it (standard normal x 0.1, from a
    seeded generator on the card)."""
    import torch
    from repro_torch.launch import serve
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for idx, b in _hybrid_batches(cfg, kind, gb):
        B, S = b["tokens"].shape
        out.append((idx, {**b, **serve.stub_inputs(cfg, B, S, gen,
                                                   "cuda")}))
    return out


def _cross_step_want(cfg, S, contrastive):
    """K3's launches by (Sq, Sk) in one training step at sequence ``S``:
    each attention once forward and once in its block's recompute; the
    audio model's contrastive tower is its encoder alone."""
    want = _cross_want_by_seq(cfg, S)
    if cfg.family == "audio" and contrastive:
        E = S // cfg.audio_subsample
        want = {f"{E}x{E}": cfg.enc_layers}
    return {k: 2 * n for k, n in want.items()}


def _cross_counts(k3, contrastive):
    """One training step's launches: ``k3`` of K3, and for the
    contrastive loss one K1 and one K2 call (2 CUDA launches each); no
    K4."""
    k12 = 1 if contrastive else 0
    return dict(flash_attention=k3, gcl_pair_stats=k12, gcl_pair_grads=k12,
                gcl_pair_stats_cuda=2 * k12, gcl_pair_grads_cuda=2 * k12,
                ssd_chunk=0, ssd_chunk_cuda=0)


def _unreached(model, groups):
    return [n for n, _ in model.named_parameters()
            if n.split(".")[0] in groups]


def _cross_lm(checks, name, cfg, model, batches, hg):
    """The LM objective from the seeded init: 3 kernel-path steps (step 0
    warms up and sends its gradients to the host, step 1 timed with its
    peak memory, step 2 profiled by kind of kernel), K3 counted exactly
    per step and by (Sq, Sk); then 3 plain-path steps, step 0's gradients
    of every leaf held to the kernel path's (``TOL_TRAIN_GRAD``, the
    unreached leaves zero on both), every step's loss within
    ``TOL_TRAIN_TRAJ``.  Returns K3's launches by (Sq, Sk) over the 3
    kernel-path steps."""
    import torch
    from repro_torch.launch import steps as ST
    make = {impl: ST.make_lm_train_step(
        cfg, lr=HYBRID_LR, wd=0.1, total_steps=3, impl=impl,
        device="cuda")[0] for impl in ("flash", "chunked")}
    B, S = batches[0][1]["tokens"].shape
    want = _cross_step_want(cfg, S, False)
    want_n = _cross_counts(sum(want.values()), False)
    unreached = _unreached(model, CROSS_UNREACHED["lm", cfg.name])
    dev = next(model.parameters()).device
    zero = {}

    def take(grads):
        zero["kernel"] = all(not grads[n].any() for n in unreached)
        hg.take(grads)
    seconds, t0 = {}, time.monotonic()
    state = _fresh_state(model, None)
    rec_k, ms_k, counts, by_seq = [], [], [], []
    prof, peak = None, None
    for i, (_, b) in enumerate(batches):
        if i == 0:
            with _CaptureGrads(take):
                (state, m), ms, n = _timed(lambda: make["flash"](state, b))
        elif i == 1:
            torch.cuda.reset_peak_memory_stats()
            (state, m), ms, n = _timed(lambda: make["flash"](state, b))
            peak = torch.cuda.max_memory_allocated()
        else:
            held = {}
            _zero_hybrid_counters()
            prof = _profile(lambda: held.update(out=make["flash"](state, b)),
                            categories=DENSE_TRAIN_CATEGORIES,
                            host_ops=False)
            # popped: the dict must not keep this path's state alive
            (state, m), ms, n = held.pop("out"), prof["wall_ms"], (
                _hybrid_counters())
        counts.append(n)
        by_seq.append(_by_seq())
        ms_k.append(ms)
        rec_k.append({k: float(v) for k, v in m.items()})
    del state
    torch.cuda.empty_cache()
    seconds["kernel_steps"] = time.monotonic() - t0
    t0 = time.monotonic()
    checks.check(counts == [want_n] * 3 and by_seq == [want] * 3,
                 f"{name}_lm: launches per step {counts} by (Sq, Sk) "
                 f"{by_seq}, want {want_n} {want}")
    # the plain path; its step-0 gradients against the kernel path's
    rel = {}

    def compare(grads):
        zero["plain"] = all(not grads[n].any() for n in unreached)
        rel.update(_host_rel(hg.buf, grads, dev))
    state = _fresh_state(model, None)
    rec_p, ms_p, counts_p = [], [], []
    for i, (_, b) in enumerate(batches):
        with _CaptureGrads(compare if i == 0 else lambda g: None):
            (state, m), ms, n = _timed(lambda: make["chunked"](state, b))
        rec_p.append({k: float(v) for k, v in m.items()})
        ms_p.append(ms)
        counts_p.append(n["flash_attention"])
    del state
    torch.cuda.empty_cache()
    seconds["plain_steps"] = time.monotonic() - t0
    worst = max(rel, key=rel.get)
    checks.check(all(math.isfinite(v) and v <= TOL_TRAIN_GRAD
                     for v in rel.values()) and zero == {
                         "kernel": True, "plain": True},
                 f"{name}_lm: step-0 grads kernel vs plain, worst leaf "
                 f"{worst} rel L2 {rel[worst]}, bound {TOL_TRAIN_GRAD}; "
                 f"unreached leaves zero {zero}")
    traj = max(abs(a[k] - p[k]) / max(abs(p[k]), 1e-30)
               for a, p in zip(rec_k, rec_p) for k in ("loss", "ce"))
    checks.check(math.isfinite(traj) and traj <= TOL_TRAIN_TRAJ
                 and counts_p == [0] * 3,
                 f"{name}_lm: losses kernel {rec_k} plain {rec_p} (rel "
                 f"{traj}, bound {TOL_TRAIN_TRAJ}); plain-path K3 "
                 f"launches {counts_p}")
    prof["idle_share_of_timed_step"] = 1.0 - prof["device_busy_ms"] / ms_k[1]
    emit(f"{name}_lm_device", arch=cfg.name, n_layers=cfg.n_layers,
         shape=[B, S], batch_on_device=True, ms_per_step=ms_k,
         ms_per_step_after_warmup=ms_k[1], max_memory_allocated=peak,
         launches_per_step=counts[1], launches_by_seq_per_step=by_seq[1],
         losses=[r["loss"] for r in rec_k],
         losses_plain=[r["loss"] for r in rec_p], trajectory_rel=traj,
         traj_bound=TOL_TRAIN_TRAJ, ms_per_step_plain_path=ms_p,
         grad_leaves=len(rel), grads_kernel_vs_plain=_leaf_summary(rel),
         grad_bound=TOL_TRAIN_GRAD, unreached=CROSS_UNREACHED["lm",
                                                            cfg.name],
         unreached_zero=zero, profile=prof, seconds=seconds)
    return {k: 3 * n for k, n in want.items()}


def _cross_contrastive(checks, name, cfg, model, batches, hg):
    """The contrastive objective (v3, the LM launchers' 64 x 256) from
    the seeded init: 2 kernel-path steps (timed; one K1 and one K2 call
    and K3 exactly per step), step 0's gradients to the host, the
    unreached leaves zero there and, after the steps, moved by the
    decoupled weight decay alone; 2 plain-path steps, step 0's gradients
    held to the kernel path's (``TOL_TRAIN_GRAD``) and the loss, tau,
    loss value and u mean of both steps within ``TOL_TRAIN_TRAJ``.
    Returns the launches of the 2 kernel-path steps."""
    import torch
    from repro_torch.core import train_step as TS
    tcs = {impl: _hybrid_ctr_config(cfg, impl, loss_impl)
           for impl, loss_impl in (("flash", "fused"), ("chunked", "dense"))}
    fc_cfg = tcs["flash"].fc
    step = {impl: TS.make_train_step(tc, "cuda") for impl, tc in tcs.items()}
    B, S = batches[0][1]["tokens"].shape
    want = _cross_step_want(cfg, S, True)
    want_n = _cross_counts(sum(want.values()), True)
    unreached = _unreached(model, CROSS_UNREACHED["contrastive", cfg.name])
    dev = next(model.parameters()).device
    zero = {}

    def take(grads):
        zero["kernel"] = all(not grads[n].any() for n in unreached)
        hg.take(grads)
    seconds, t0 = {}, time.monotonic()
    state = _fresh_state(model, None, fc_cfg)
    params = dict(model.named_parameters())
    init = {n: params[n].detach().clone() for n in unreached}
    torch.cuda.reset_peak_memory_stats()
    rec_k, ms_k, counts, by_seq = [], [], [], []
    for i, (idx, b) in enumerate(batches[:2]):
        with _CaptureGrads(take if i == 0 else lambda g: None,
                           contrastive=True):
            (state, m), ms, n = _timed(lambda: step["flash"](state, b, idx))
        counts.append(n)
        by_seq.append(_by_seq())
        ms_k.append(ms)
        rec_k.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    lr1 = float(tcs["flash"].lr_fn(1))
    decay = [n for n in unreached if not (
        not torch.equal(params[n], init[n]) and torch.allclose(
            params[n], init[n] * (1 - lr1 * 0.1), rtol=1e-6, atol=0))]
    del state, init
    torch.cuda.empty_cache()
    seconds["kernel_steps"] = time.monotonic() - t0
    t0 = time.monotonic()
    checks.check(counts == [want_n] * 2 and by_seq == [want] * 2,
                 f"{name}_contrastive: launches per step {counts} by (Sq, "
                 f"Sk) {by_seq}, want {want_n} {want}")
    rel = {}

    def compare(grads):
        zero["plain"] = all(not grads[n].any() for n in unreached)
        rel.update(_host_rel(hg.buf, grads, dev))
    state = _fresh_state(model, None, fc_cfg)
    rec_p = []
    for i, (idx, b) in enumerate(batches[:2]):
        with _CaptureGrads(compare if i == 0 else lambda g: None,
                           contrastive=True):
            state, m = step["chunked"](state, b, idx)
        rec_p.append({k: float(v) for k, v in m.items()})
    del state
    torch.cuda.empty_cache()
    seconds["plain_steps"] = time.monotonic() - t0
    worst = max(rel, key=rel.get)
    traj = _traj_rel(rec_k, rec_p)
    checks.check(all(math.isfinite(v) and v <= TOL_TRAIN_GRAD
                     for v in rel.values()) and zero == {
                         "kernel": True, "plain": True} and not decay,
                 f"{name}_contrastive: step-0 grads kernel vs plain, worst "
                 f"leaf {worst} rel L2 {rel[worst]}, bound {TOL_TRAIN_GRAD};"
                 f" unreached leaves zero {zero}, not moved by the decay "
                 f"alone {decay[:4]}")
    checks.check(math.isfinite(traj) and traj <= TOL_TRAIN_TRAJ,
                 f"{name}_contrastive: kernel {rec_k} plain {rec_p} (rel "
                 f"{traj}, bound {TOL_TRAIN_TRAJ})")
    emit(f"{name}_contrastive_device", arch=cfg.name, shape=[B, S],
         batch_on_device=True, ms_per_step=ms_k, max_memory_allocated=peak,
         launches_per_step=counts, launches_by_seq_per_step=by_seq,
         metrics=rec_k, metrics_plain=rec_p, trajectory_rel=traj,
         traj_bound=TOL_TRAIN_TRAJ, grad_leaves=len(rel),
         grads_kernel_vs_plain=_leaf_summary(rel),
         grad_bound=TOL_TRAIN_GRAD,
         unreached=CROSS_UNREACHED["contrastive", cfg.name],
         unreached_leaves=len(unreached), unreached_zero=zero,
         unreached_decay_lr=lr1, seconds=seconds)
    return dict({k: 2 * v for k, v in want_n.items()},
                by_seq={k: 2 * n for k, n in want.items()})


def _launcher_refuses(checks, name, arch):
    """``repro_torch.launch.train --arch arch`` under both objectives
    (in this process): exit 2, naming F6."""
    import contextlib
    import io
    from repro_torch.launch import train
    out = {}
    for objective in ("lm", "contrastive"):
        err = io.StringIO()
        code = 0
        with contextlib.redirect_stderr(err):
            try:
                train.main(["--arch", arch, "--objective", objective,
                            "--steps", "1"])
            except SystemExit as e:
                code = e.code
        out[objective] = dict(exit_code=code, stderr=err.getvalue()[-400:])
        checks.check(code == 2 and "F6" in err.getvalue(),
                     f"{name}: the launcher under {objective} exited {code}"
                     f": {err.getvalue()[-400:]}")
    emit(f"{name}_launcher", **out)


def _cross_train(checks, arch):
    """One cross-attention family trained at full width (the vlm at
    ``VLM_TRAIN_LAYERS``): seeded init on the card and JAX's parameter
    count, the LM objective (``_cross_lm``) and the contrastive one
    (``_cross_contrastive``) from it, ``_FlashMHA``'s backward timed at
    the cross shapes, the launcher's refusal.  Returns K3's, K1's and
    K2's launches on each objective's kernel path."""
    import torch
    from repro_torch.models import backbones as BB
    name = "vlm_train" if arch == VLM_ARCH else "audio_train"
    t_phase = time.monotonic()
    cfg = _cross_train_config(arch)
    torch.cuda.empty_cache()
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    checks.check(n_params == CROSS_TRAIN_PARAMS[arch],
                 f"{name}: {arch} at {cfg.n_layers} layers has {n_params} "
                 f"parameters, want {CROSS_TRAIN_PARAMS[arch]}")
    emit(f"{name}_params", arch=arch, n_layers=cfg.n_layers,
         enc_layers=cfg.enc_layers, n_params=n_params,
         param_bytes=4 * n_params)
    hg = _HostGradsBehind(model)
    out = {"lm": _cross_lm(checks, name, cfg, model, _cross_batches(
        cfg, "lm", CROSS_TRAIN_LM_BATCH[arch]), hg)}
    t_lm = time.monotonic() - t_phase
    out["contrastive"] = _cross_contrastive(
        checks, name, cfg, model, _cross_batches(cfg, "contrastive"), hg)
    host_seconds = hg.seconds
    del model, hg
    torch.cuda.empty_cache()
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    E = 4096 // cfg.audio_subsample if cfg.family == "audio" else (
        cfg.n_image_tokens)
    backward = {"lm_cross": _attn_backward_ms(
        CROSS_TRAIN_LM_BATCH[arch], 4096, H, hd, Sk=E, causal=False)}
    if cfg.family == "vlm":
        # its self-attention's shape is qwen3-moe's (phase moe_train)
        backward["contrastive_cross"] = _attn_backward_ms(
            64, 256, H, hd, Sk=E, causal=False)
    else:
        # the decoder's and the encoder's self-attention, for the
        # step's whole K3 backward
        backward["lm_self"] = _attn_backward_ms(2, 4096, H, hd)
        backward["lm_encoder"] = _attn_backward_ms(2, E, H, hd)
    emit(f"{name}_k3_backward", **backward)
    _launcher_refuses(checks, name, arch)
    emit(name, seconds=time.monotonic() - t_phase, lm_seconds=t_lm,
         host_buffer_seconds=host_seconds)
    checks.end_phase(name)
    return out


def phase_vlm_train(checks):
    """``llama-3.2-vision-11b`` trained at full width and
    ``VLM_TRAIN_LAYERS`` layers (``_cross_train``)."""
    return _cross_train(checks, VLM_ARCH)


def phase_audio_train(checks):
    """``seamless-m4t-large-v2`` trained whole (``_cross_train``)."""
    return _cross_train(checks, AUDIO_ARCH)


def _vlm_stack_super(model, x, img, impl, remat):
    """The vlm's super-blocks, each recomputed as one (JAX's outer
    level alone)."""
    from repro_torch.models import backbones as BB

    def block(sup):
        def run(h):
            for blk in sup.selfs:
                h = blk(h, impl=impl)
            return sup.cross_blk(h, kv_x=img, impl=impl)
        return run
    for sup in model.supers:
        x = BB._run(remat, block(sup), (sup,), x)
    return x


def _vlm_stack_nested(model, x, img, impl, remat):
    """JAX's nested form: each super-block recomputed as one and, inside
    it, each self block recomputed on its own as well."""
    import functools

    from repro_torch.models import backbones as BB

    def block(sup):
        def run(h):
            for blk in sup.selfs:
                h = BB._run(remat, functools.partial(blk, impl=impl),
                            (blk,), h)
            return sup.cross_blk(h, kv_x=img, impl=impl)
        return run
    for sup in model.supers:
        x = BB._run(remat, block(sup), (sup,), x)
    return x


def phase_vlm_remat_forms(checks):
    """A diagnostic (``--only vlm_remat_forms``): the vlm's LM step at
    ``VLM_TRAIN_LAYERS`` layers and ``CROSS_TRAIN_LM_BATCH`` x 4096 (f32,
    seed 0) under the port's one-level recompute (each block on its
    own), a recompute per super-block and JAX's nested form, in the
    order one-level, super-block, nested, nested, super-block, one-level
    after a warm-up step: ms per step, peak memory, K3's launches exact
    (each block's attention twice; in the nested form each self block's
    once more), every state equal to the bit.  A form that runs out of
    memory is reported, not raised."""
    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.models import backbones as BB
    cfg = _cross_train_config(VLM_ARCH)
    torch.cuda.empty_cache()
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    batch = _cross_batches(cfg, "lm", CROSS_TRAIN_LM_BATCH[VLM_ARCH])[0][1]
    step = ST.make_lm_train_step(cfg, lr=HYBRID_LR, wd=0.1, total_steps=3,
                                 device="cuda")[0]
    forms = {"one_level": BB._vlm_stack, "super_block": _vlm_stack_super,
             "nested": _vlm_stack_nested}
    n_self = cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    base = sum(_cross_step_want(cfg, 4096, False).values())
    runs = {f: [] for f in forms}
    fps = {}
    try:
        for form in ("warm_up", "one_level", "super_block", "nested",
                     "nested", "super_block", "one_level"):
            BB._vlm_stack = forms.get(form, forms["one_level"])
            state = _fresh_state(model, None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            try:
                (state, m), ms, n = _timed(lambda: step(state, batch))
            except torch.cuda.OutOfMemoryError as e:
                del state
                torch.cuda.empty_cache()
                runs.get(form, []).append(dict(out_of_memory=str(e)[:300]))
                continue
            peak = torch.cuda.max_memory_allocated()
            fp = _fingerprints(state)
            del state
            torch.cuda.empty_cache()
            if form == "warm_up":
                continue
            want = base + (n_self if form == "nested" else 0)
            checks.check(n["flash_attention"] == want,
                         f"vlm_remat_forms {form}: K3 launches "
                         f"{n['flash_attention']}, want {want}")
            fps.setdefault(form, fp)
            runs[form].append(dict(ms_per_step=ms, loss=float(m["loss"]),
                                   max_memory_allocated=peak))
    finally:
        BB._vlm_stack = forms["one_level"]
    differ = sorted({k for f in fps for k in fps[f]
                     if fps[f][k] != fps["one_level"][k]})
    checks.check(len(fps) == 3 and not differ,
                 f"vlm_remat_forms: forms run {sorted(fps)}, states differ "
                 f"in {differ[:8]}")
    emit("vlm_remat_forms", arch=VLM_ARCH, n_layers=cfg.n_layers,
         shape=list(batch["tokens"].shape), runs=runs,
         states_equal=not differ, card_total_memory=torch.cuda.
         get_device_properties(0).total_memory)
    del model
    torch.cuda.empty_cache()
    checks.end_phase("vlm_remat_forms")


def _first_batch(cfg):
    """The launcher's first (idx, batch) at TRAIN_ARGS, on the card, and
    the host seconds that assembling the numpy batch took."""
    import numpy as np
    import torch
    from repro_torch.data import ContrastiveDataset, ShardedLoader
    ds = ContrastiveDataset(n=2048, image_size=cfg.clip.image_size,
                            context_length=cfg.clip.context_length,
                            vocab_size=cfg.vocab_size, n_classes=64)
    t0 = time.monotonic()
    _, _, idx, batch = next(ShardedLoader(ds, global_batch=256,
                                          seed=0).steps(1))
    host_s = time.monotonic() - t0
    return (torch.from_numpy(np.asarray(idx)).cuda(),
            {k: torch.from_numpy(v).cuda() for k, v in batch.items()},
            host_s)


def _train_config(cfg, impl, loss_impl):
    """The launcher's v3 step configuration at TRAIN_ARGS."""
    from repro_torch.core import fastclip as FC
    from repro_torch.core import train_step as TS
    from repro_torch.core.schedules import lr_warmup_cosine
    from repro_torch.optim import adamw
    fc = FC.FastCLIPConfig(version="v3", n_samples=2048, rho=6.5,
                           steps_per_epoch=8, gamma_decay_epochs=1)
    return TS.TrainStepConfig(arch=cfg, fc=fc, optimizer=adamw(),
                              lr_fn=lr_warmup_cosine(1e-3, 1, 3), impl=impl,
                              loss_impl=loss_impl)


def _step1_grads(cfg, impl, loss_impl, state, idx, batch):
    from repro_torch.core import train_step as TS
    tc = _train_config(cfg, impl, loss_impl)
    core = TS.make_loss_core(tc.fc, loss_impl)
    _, _, grads, _ = TS.step_grads(tc, core, state, batch, idx,
                                   tc.fc.gamma_fn()(state["step"]))
    return grads


# the port's numerics policy (repro_torch.device.set_numerics_policy)
POLICY_FLAGS = dict(matmul_tf32=False, cudnn_tf32=False,
                    cudnn_deterministic=True, cudnn_benchmark=False)
# a step's kernels by what they compute (the first match names a kernel)
STEP_CATEGORIES = (
    ("k3_flash_attention", ("flash",)),
    ("k1_k2_fcco", ("stats_partial", "stats_merge", "grads_weights",
                    "grads_product")),
    ("cudnn_conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit",
                    "winograd")),
    ("group_norm", ("RowwiseMoments", "FusedParams", "GroupNorm",
                    "group_norm", "InternalGradients", "GammaBeta")),
    ("gemm", ("gemm", "gemv")),
)


def _family_argv(arch, *extra):
    argv = list(TRAIN_ARGS)
    argv[argv.index("--arch") + 1] = arch
    return argv + list(extra)


def _backend_flags():
    import torch
    return dict(matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_tf32=torch.backends.cudnn.allow_tf32,
                cudnn_deterministic=torch.backends.cudnn.deterministic,
                cudnn_benchmark=torch.backends.cudnn.benchmark)


def _by_seq():
    """K3's launches by (Sq, Sk) since the counts were set to 0."""
    from repro_torch.kernels import flash_attention as FA
    return {f"{q}x{k}": n for (q, k), n in
            sorted(FA.flash_attention.launches_by_seq.items())}


def _k3_by_seq(cfg, steps):
    """K3's launches by (Sq, Sk) in ``steps`` training steps: each text
    layer at the context length, each ViT layer at its patches and CLS
    (the ResNet has none)."""
    ctx = cfg.clip.context_length
    want = {f"{ctx}x{ctx}": steps * cfg.n_layers}
    if cfg.clip.vision_arch == "vit":
        S = (cfg.clip.image_size // cfg.clip.patch_size) ** 2 + 1
        want[f"{S}x{S}"] = (want.get(f"{S}x{S}", 0)
                            + steps * cfg.clip.vision_layers)
    return want


def _dtype_error(state):
    """None when every float leaf of a train state is f32 (f32 masters
    under any tower precision), else why not."""
    from repro_torch.core import train_step as TS
    try:
        TS.check_state_dtypes(state)
    except AssertionError as e:
        return str(e)
    return None


def _launcher_worker(argv):
    """The training launcher's ``main`` in a process of its own (spawned by
    ``_LauncherProcess``, never by hand) that sets no backend flag, so the
    run starts from the port's device policy alone.  ``argv[0]``: an npz
    path for the final log-u (a contrastive run); prints the launches (K4's
    apart), the backend flags before and after, the f32-master check, the
    step records, the run's seconds and the peak memory on one JSON
    line."""
    import numpy as np
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch.launch import train
    out, argv = argv[0], argv[1:]
    if argv[:1] == ["--layers"]:
        # a depth cut: the launcher's get_arch returns the arch at this
        # depth in this process
        from repro_torch.configs import base
        name = argv[argv.index("--arch") + 1]
        base._REGISTRY[name] = base.get_arch(name).replace(
            n_layers=int(argv[1]))
        argv = argv[2:]
    # the allocator's cached blocks go back to the card as a checkpoint
    # write (host work) begins, so that the work beside it has the memory
    CK.set_fault_hook(lambda event: torch.cuda.empty_cache()
                      if event == "pre_npz" else None)
    from repro_torch.kernels import ssd_chunk as K4
    before = _backend_flags()
    record = []
    t0 = time.monotonic()
    st = train.main(argv, record=record)
    wall = time.monotonic() - t0
    if "fc" in st:          # the LM objective has no FCCO state
        np.savez(out, **{u: st["fc"][u].cpu().numpy()
                         for u in ("u1", "u2")})
    print(json.dumps({"launcher_worker": dict(
        launches=_counters(), by_seq=_by_seq(),
        k4=dict(ssd_chunk=K4.ssd_chunk.launches,
                ssd_chunk_cuda=K4.ssd_chunk.cuda_launches),
        flags_before=before, flags_after=_backend_flags(),
        dtype_error=_dtype_error(st), record=record, wall_seconds=wall,
        max_memory_allocated=torch.cuda.max_memory_allocated())}),
        flush=True)


# ---------------------------------------------------------------------------
# children started ahead of their turn
# ---------------------------------------------------------------------------

# A child of this script spends seconds importing torch and the port
# before it does anything, whether one or eight start at once, so a child
# is started early, "held": it imports, then waits for the argv its
# parent writes to its hold file (or "stop").  Its turn then starts with
# the imports done.  Every hold file is released or stopped at exit.
_HOLDS = []


def _hold_path():
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_hold_"), "go")
    _HOLDS.append(path)
    return path


def _release(path, argv):
    """Start a held child on ``argv`` (this script's own arguments)."""
    _signal(path, json.dumps(list(argv)))


def _stop_held():
    """At exit: every held child still waiting ends (a no-op for the
    released ones)."""
    for path in _HOLDS:
        _signal(path, "stop")
    time.sleep(0.5)
    for path in _HOLDS:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def _hold(path):
    """In a held child: the imports, then its argv from ``path``; exits
    on "stop" or when its parent is gone."""
    import torch  # noqa: F401  (the slow part of a start)
    import repro_torch.launch.train  # noqa: F401
    ppid = os.getppid()
    while True:
        if os.path.exists(path):
            with open(path) as f:
                word = f.read().strip()
            if word == "stop":
                sys.exit(0)
            if word:
                return json.loads(word)
        if os.getppid() != ppid:
            sys.exit(0)
        time.sleep(0.1)


class _LauncherProcess:
    """``_launcher_worker`` on ``argv`` in a child process whose output a
    thread reads as it comes: ``wait_for`` a line, then ``finish`` for
    (exit code, its report or None, {u1, u2} or None, stderr's tail).
    ``layers``: the arch at that depth (a depth cut).  With no ``argv``
    the child is held (imports done, waiting) until ``start``."""

    def __init__(self, argv=None, layers=None):
        import threading
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_lw_")
        self.out = os.path.join(self.dir, "u.npz")
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.hold = _hold_path()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "chip_smoke", "--hold", self.hold],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=self.err, text=True,
            env={**os.environ, "PYTHONPATH": os.pathsep.join([SRC, ROOT])})
        self.lines = []
        self.cond = threading.Condition()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        if argv is not None:
            self.start(argv, layers)

    def start(self, argv, layers=None):
        _release(self.hold, ["--launcher-worker", self.out,
                             *(["--layers", str(layers)] if layers else []),
                             *argv])
        return self

    def _read(self):
        for ln in self.proc.stdout:
            with self.cond:
                self.lines.append(ln.rstrip("\n"))
                self.cond.notify_all()
        with self.cond:
            self.lines.append(None)          # end of output
            self.cond.notify_all()

    def wait_for(self, pred, timeout):
        """Block until a line satisfies ``pred`` (True) or the output ends
        or ``timeout`` passes (False)."""
        with self.cond:
            return self.cond.wait_for(
                lambda: any(ln is None or pred(ln) for ln in self.lines),
                timeout) and any(ln is not None and pred(ln)
                                 for ln in self.lines)

    def finish(self, timeout):
        import numpy as np
        _signal(self.hold, "stop")       # a no-op once started
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.reader.join(60)
        rep = [ln for ln in self.lines
               if ln and ln.startswith('{"launcher_worker"')]
        rep = json.loads(rep[-1])["launcher_worker"] if rep else None
        u = dict(np.load(self.out)) if os.path.exists(self.out) else None
        self.err.seek(0)
        err = self.err.read()[-3000:]
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        return rc, rep, u, err


def _run_here(argv):
    """The launcher in this process: (state, record, launches, launches by
    (Sq, Sk), wall seconds, peak memory, its standard output), the counts
    set to 0 just before and read just after."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import train
    record, out = [], io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        st = train.main(argv, record=record)
    torch.cuda.synchronize()
    return (st, record, _counters(), _by_seq(), time.monotonic() - t0,
            torch.cuda.max_memory_allocated(), out.getvalue())


def _traj_rel(rec_a, rec_b):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
               for a, b in zip(rec_a, rec_b)
               for k in ("loss", "tau", "loss_value", "u_mean"))


def _log_u_rel(checks, name, u_a, u_b):
    """Largest error of the touched log-u rows of ``u_a`` against
    ``u_b`` (relative, floor 0.1); untouched rows are -inf in both."""
    import torch
    err = 0.0
    for k in ("u1", "u2"):
        a, b = torch.as_tensor(u_a[k]).cpu(), torch.as_tensor(u_b[k]).cpu()
        fin = torch.isfinite(b)
        checks.check(bool((torch.isfinite(a) == fin).all()),
                     f"{name}: touched log-u rows differ")
        err = max(err, ((a[fin] - b[fin]).abs()
                        / b[fin].abs().clamp_min(1e-1)).max().item())
    return err


def _device_checks(checks, cfg, name, idx, batch):
    """Untimed, on a batch on the card: step-1 gradients of the kernel
    path against the plain path (relative L2 per leaf), and two identical
    kernel-path steps from one init, bitwise (sha256 per leaf).  Returns
    the state after those steps."""
    import torch
    from repro_torch.checkpoint import bridge
    from repro_torch.core import train_step as TS
    tc = _train_config(cfg, "flash", "fused")
    state = TS.init_train_state(torch.Generator().manual_seed(0), tc,
                                "cuda")
    g_k = _step1_grads(cfg, "flash", "fused", state, idx, batch)
    g_p = _step1_grads(cfg, "naive", "dense", state, idx, batch)
    rel = {k: ((g_k[k] - g_p[k]).norm()
               / g_p[k].norm().clamp_min(1e-30)).item() for k in g_p}
    del g_k, g_p, state
    worst = max(rel, key=rel.get)
    checks.check(all(math.isfinite(v) and v <= TOL_TRAIN_GRAD
                     for v in rel.values()),
                 f"{name}: step-1 grads, worst leaf {worst} rel L2 "
                 f"{rel[worst]}")
    step = TS.make_train_step(tc, "cuda")
    digests = []
    for _ in range(2):
        state = TS.init_train_state(torch.Generator().manual_seed(0), tc,
                                    "cuda")
        state, _ = step(state, batch, idx)
        digests.append(_state_digests(bridge.state_to_tree(state)))
    bitwise = digests[0] == digests[1]
    differ = [k for k in digests[0] if digests[0][k] != digests[1].get(k)]
    checks.check(bitwise, f"{name}: two identical steps differ in "
                 f"{differ[:8]}")
    emit(f"{name}_device_checks", grad_leaves=len(rel),
         grad_worst_leaf=worst, grad_worst_rel_l2=rel[worst],
         tol=TOL_TRAIN_GRAD, two_steps_bitwise=bitwise,
         leaves_hashed=len(digests[0]))
    return state


def _device_timing(cfg, name, state, idx, batch):
    """Steps on a batch already on the card (no host data pipeline): ms
    per step of the kernel path and of the plain path in turns (kernel,
    plain, kernel: a warm-up and 2 timed steps each), and a
    torch.profiler breakdown of one kernel-path step by kind of kernel."""
    import torch
    from repro_torch.core import train_step as TS
    steps = {impl: TS.make_train_step(_train_config(cfg, impl, loss_impl),
                                      "cuda")
             for impl, loss_impl in (("flash", "fused"), ("naive", "dense"))}
    ms = {k: [] for k in steps}
    for impl in ("flash", "naive", "flash"):
        state, _ = steps[impl](state, batch, idx)       # warm-up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(2):
            state, _ = steps[impl](state, batch, idx)
        torch.cuda.synchronize()
        ms[impl].append((time.monotonic() - t0) / 2 * 1e3)
    held = [state]
    del state

    def one():
        held[0], _ = steps["flash"](held[0], batch, idx)
    prof = _profile(one, categories=STEP_CATEGORIES)
    del held
    torch.cuda.empty_cache()
    emit(f"{name}_device_steps", batch_on_device=True,
         ms_per_step_kernel_path=ms["flash"],
         ms_per_step_plain_path=ms["naive"], profile=prof)


def _kernel_run_checks(checks, cfg, name, run, steps=3):
    """The kernel path's launcher run (``run``: its record, launches,
    launches by (Sq, Sk), f32-master check): launches exact, losses
    finite, f32 masters."""
    want = _train_launches(cfg, steps, 0, 0, 1)
    want_seq = _k3_by_seq(cfg, steps)
    rec = run["record"]
    checks.check(run["launches"] == want and run["by_seq"] == want_seq,
                 f"{name}: launches {run['launches']} {run['by_seq']}, "
                 f"want {want} {want_seq}")
    checks.check(len(rec) == steps and all(math.isfinite(r["loss"])
                                           for r in rec),
                 f"{name}: losses {[r['loss'] for r in rec]}")
    checks.check(run["dtype_error"] is None,
                 f"{name}: dtypes {run['dtype_error']}")
    emit(f"{name}_kernel_path", steps=steps, launches=run["launches"],
         launches_want=want, by_seq=run["by_seq"], by_seq_want=want_seq,
         losses=[r["loss"] for r in rec], taus=[r["tau"] for r in rec],
         sat_rate=[r["sat_rate"] for r in rec],
         ms_per_step_after_warmup=(rec[-1]["time"] - rec[0]["time"])
         / (steps - 1) * 1e3, max_memory_allocated=run[
             "max_memory_allocated"], f32_masters=run["dtype_error"] is None,
         **run["extra"])


def _plain_path(checks, arch, name, run):
    """The plain path's launcher run (``--impl naive --loss-impl dense``)
    against the kernel path's ``run``: each logged loss, tau, loss value
    and mean log-u, and the final log-u rows, within rtol
    TOL_TRAIN_TRAJ."""
    import torch
    st, rec_p, _, _, wall, mem, _ = _run_here(_family_argv(
        arch, "--steps", "3", "--precision", "f32", "--impl", "naive",
        "--loss-impl", "dense"))
    u_err = _log_u_rel(checks, name, run["u"], st["fc"])
    del st
    torch.cuda.empty_cache()
    rec_k = run["record"]
    traj = _traj_rel(rec_k, rec_p) if len(rec_p) == len(rec_k) == 3 else 1.0
    checks.check(traj <= TOL_TRAIN_TRAJ and u_err <= TOL_TRAIN_TRAJ,
                 f"{name}: kernel vs plain trajectory rel {traj}, log-u "
                 f"rel {u_err}")
    emit(f"{name}_plain_path", losses=[r["loss"] for r in rec_p],
         taus=[r["tau"] for r in rec_p], worst_rel_traj=traj,
         log_u_rel_err=u_err, tol=TOL_TRAIN_TRAJ,
         ms_per_step_after_warmup=(rec_p[-1]["time"] - rec_p[0]["time"])
         / 2 * 1e3, wall_seconds=wall, max_memory_allocated=mem)


def _bf16_step(checks, arch, name):
    """One bf16 step of the launcher: a finite loss, f32 masters."""
    import torch
    st, rec, _, _, wall, mem, _ = _run_here(_family_argv(
        arch, "--steps", "1", "--precision", "bf16"))
    err = _dtype_error(st)
    del st
    torch.cuda.empty_cache()
    checks.check(err is None, f"{name} bf16: dtypes {err}")
    checks.check(len(rec) == 1 and math.isfinite(rec[0]["loss"]),
                 f"{name} bf16: loss {rec}")
    emit(f"{name}_bf16", loss=rec[0]["loss"] if rec else None,
         f32_masters=err is None, wall_seconds=wall,
         max_memory_allocated=mem)


def _train_arch(checks, arch, name, ckpt=None, keep_tree=False,
                beside_write=None, child=None):
    """One CLIP setting at full width, v3, AdamW, global batch 256: 3 f32
    steps of the launcher on the kernel path, held to the plain path's
    run; step-1 gradients and two identical steps on one batch (untimed);
    a bf16 step; then the device-resident timings.  With ``ckpt``, the
    kernel path runs in a child process that sets no backend flag (the
    device policy alone decides them) and writes its step-3 checkpoint
    there; that write is host work, and only untimed work runs beside
    it: those checks, then ``beside_write()``.  ``child``: a held
    ``_LauncherProcess`` for that run (started early, its imports done).
    Returns the kernel run's record, launches and launches by (Sq, Sk),
    with ``keep_tree`` its final state as a flat host tree."""
    import torch
    from repro_torch.checkpoint import bridge, flatten
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    idx, batch, host_s = _first_batch(cfg)
    emit(f"{name}_host_batch", global_batch=256, host_seconds=host_s)
    argv = _family_argv(arch, "--steps", "3", "--precision", "f32")
    out = {}
    if ckpt is None:
        st, rec, counts, by_seq, wall, mem, _ = _run_here(argv)
        run = dict(record=rec, launches=counts, by_seq=by_seq,
                   max_memory_allocated=mem, dtype_error=_dtype_error(st),
                   u={u: st["fc"][u].cpu() for u in ("u1", "u2")},
                   extra=dict(wall_seconds=wall))
        if keep_tree:
            out["tree"] = {k: v.detach().cpu().numpy() for k, v in flatten(
                bridge.state_to_tree(st)).items()}
        del st
        torch.cuda.empty_cache()
        state = _device_checks(checks, cfg, name, idx, batch)
        _bf16_step(checks, arch, name)
    else:
        t0 = time.monotonic()
        child = (child or _LauncherProcess()).start(
            argv + ["--ckpt-dir", ckpt, "--ckpt-every", "3"])
        try:
            # the child's last step is logged before its checkpoint write
            # begins
            child.wait_for(lambda ln: ln.startswith("step     2 "), 600)
            state = _device_checks(checks, cfg, name, idx, batch)
            _bf16_step(checks, arch, name)
            if beside_write is not None:
                beside_write()
        finally:
            rc, rep, u, err = child.finish(600)
        if rc or rep is None:
            print(err, file=sys.stderr, flush=True)
        checks.check(rc == 0 and rep is not None and u is not None,
                     f"{name}: launcher process exit code {rc}")
        checks.end_phase(name)
        checks.check(rep["flags_after"] == POLICY_FLAGS,
                     f"{name}: backend flags after the run "
                     f"{rep['flags_after']}, want {POLICY_FLAGS}")
        run = dict(rep, u=u, extra=dict(
            flags_before=rep["flags_before"], flags_after=rep["flags_after"],
            wall_seconds_with_the_checks_here=time.monotonic() - t0))
    _kernel_run_checks(checks, cfg, name, run)
    _plain_path(checks, arch, name, run)
    _device_timing(cfg, name, state, idx, batch)
    del state, batch
    torch.cuda.empty_cache()
    out.update(record=run["record"], launches=run["launches"],
               by_seq=run["by_seq"])
    return out


def phase_train(checks):
    """Full-width ``clip-vitb32-cc12m`` v3 training through the port's
    launcher (``_train_arch``) and its periodic eval; returns the kernel
    run's launches, record and final state tree (phase mesh holds its
    data:1,fsdp:1 run to them)."""
    from repro_torch.configs import get_arch
    out = _train_arch(checks, ARCH, "train", keep_tree=True)
    _train_eval_every(checks, get_arch(ARCH))
    checks.end_phase("train")
    return out["launches"], out["record"], out["tree"]


def _train_eval_every(checks, cfg):
    """The trainer's periodic eval on the card: ``--eval-every 2`` over 3
    steps evals at steps 2 and 3 (the final eval), each through K3 (both
    towers, the prompt head) and K1 (``eval_loss``, the trainer's default
    ``--loss-impl fused``); launches exact; the last ``eval`` line is the
    evaluator's on the final params, whose ``eval_loss`` is the dense
    loss's within rtol TOL_K1."""
    import torch
    from repro_torch.data import ZeroShotEvalDataset
    from repro_torch.eval import ClipEvaluator
    steps, every, classes, per_class, batch = 3, 2, 8, 8, 64
    st, _, counts, _, wall, mem, out = _run_here(
        TRAIN_ARGS + ["--steps", str(steps), "--precision", "f32",
                      "--eval-every", str(every), "--eval-classes",
                      str(classes), "--eval-per-class", str(per_class),
                      "--eval-batch", str(batch)])
    evals = [(int(m.group(1)), json.loads(m.group(2))) for m in map(
        re.compile(r"^eval  ([ \d]{5}) (\{.*\})$").match,
        out.splitlines()) if m]
    want = _train_launches(cfg, steps, 2, classes * per_class, batch)
    checks.check(counts == want and [s for s, _ in evals] == [2, 3],
                 f"train --eval-every: launches {counts}, want {want}; "
                 f"eval steps {[s for s, _ in evals]}")
    ds = ZeroShotEvalDataset(
        n_classes=classes, n_per_class=per_class,
        image_size=cfg.clip.image_size,
        context_length=cfg.clip.context_length, vocab_size=cfg.vocab_size,
        seed=int(TRAIN_ARGS[TRAIN_ARGS.index("--seed") + 1]) + 1)
    fused, dense = (ClipEvaluator(cfg, ds, impl="flash", precision="f32",
                                  batch_size=batch, loss_impl=impl,
                                  device="cuda").evaluate(st["params"])
                    for impl in ("fused", "dense"))
    del st
    torch.cuda.empty_cache()
    rel = abs(fused["eval_loss"] - dense["eval_loss"]) / abs(
        dense["eval_loss"])
    last = evals[-1][1] if evals else None
    checks.check(last == {k: round(v, 5) for k, v in fused.items()}
                 and rel <= TOL_K1 and all(
                     fused[k] == dense[k] for k in fused if k != "eval_loss"),
                 f"train --eval-every: last eval {last}, fused {fused}, "
                 f"dense {dense}")
    emit("train_eval_every", steps=steps, eval_every=every,
         N=classes * per_class, launches=counts, launches_want=want,
         evals=evals, eval_loss_fused=fused["eval_loss"],
         eval_loss_dense=dense["eval_loss"], eval_loss_rel=rel, rtol=TOL_K1,
         wall_seconds=wall, max_memory_allocated=mem)


# ---------------------------------------------------------------------------
# phase clip_family: the paper's other two CLIP settings
# ---------------------------------------------------------------------------

RN50, VITB16 = "clip-rn50-cc3m", "clip-vitb16-laion"
# the eval pass of the ResNet-50 CLIP, as phase eval's
FAMILY_EVAL_ARGS = ["--impl", "flash", "--classes", str(EVAL_CLASSES),
                    "--per-class", str(EVAL_PER_CLASS), "--batch-size",
                    str(EVAL_BATCH), "--chunk", str(EVAL_CHUNK), "--device",
                    "cuda"]


def _mesh_worker_family(argv):
    """One rank of ``clip-rn50-cc3m`` on data:1,fsdp:2 (2 ranks sharing
    the card; spawned by phase clip_family, never by hand): 2 ZeRO steps
    over the rank's rows, the launches per step; on rank 0 each step
    against one single-device step on the same global batch from the same
    state (the init, then the mesh's gathered state after step 1), so
    that no step inherits the other's rounding.  The lr has no warm-up,
    so that both steps move the params."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import bridge, flatten, unflatten
    from repro_torch.configs import get_arch
    from repro_torch.core import shard_state as SS
    from repro_torch.core import train_step as TS
    from repro_torch.core.schedules import lr_warmup_cosine
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import multiprocess as MP
    rank = int(argv[argv.index("--process-id") + 1])
    dev = MP.initialize(argv[argv.index("--coordinator") + 1],
                        int(argv[argv.index("--num-processes") + 1]), rank,
                        "cuda")
    rep = {"mesh_rank": rank, "steps": []}
    try:
        mesh = MS.make_train_mesh(1, 2, device=dev)
        rep["backend"] = mesh.backend
        cfg = get_arch(RN50)
        tc1 = dataclasses.replace(_train_config(cfg, "flash", "fused"),
                                  lr_fn=lr_warmup_cosine(1e-3, 0, 2))
        step = TS.make_train_step(dataclasses.replace(
            tc1, fsdp=True, mesh_axes=MESH_AXES))
        dims = step.param_dims
        rep["leaves"] = {g: len(ps) for g, ps in _leaf_groups(dims).items()}
        st1 = TS.init_train_state(torch.Generator().manual_seed(0), tc1,
                                  "cpu")
        tree = unflatten({k: v.clone() for k, v in flatten(
            bridge.state_to_tree(st1)).items()})
        s = SS.shard_train_state(tree, mesh, dims)
        local = _mesh_batches(cfg, rank, 2, full=False, n_shards=2)
        full = (_mesh_batches(cfg, rank, 2, full=True, n_shards=2)
                if rank == 0 else None)
        fn1 = TS.make_train_step(tc1, "cuda") if rank == 0 else None
        for k, (idx, batch) in enumerate(local):
            _zero_counters()
            s, m = step(s, batch, idx)
            res = dict(launches=_counters(), loss=float(m["loss"]),
                       lr=float(m["lr"]))
            after = {p: v.cpu() for p, v in flatten(
                SS.gather_train_state(s, mesh, dims)).items()}
            if rank == 0:
                # one device, one step from the state the mesh started at
                st1 = bridge.state_from_tree(
                    {**st1, "params": st1["params"].cuda()}, tree)
                if k == 0:
                    rep["grad_sensitivity"] = _grad_sensitivity(
                        tc1, st1, full[k][1], full[k][0], dims)
                st1, m1 = fn1(st1, full[k][1], full[k][0])
                one = {p: v.cpu() for p, v in flatten(
                    bridge.state_to_tree(st1)).items()}
                res.update(_mesh_vs_one(after, one, tree, float(m1["loss"]),
                                        res["loss"], dims))
                del one
            rep["steps"].append(res)
            tree = unflatten(after)           # the next step's start
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    finally:
        MS.set_mesh(None)
        MP.shutdown()
    print(json.dumps(rep), flush=True)


def _leaf_groups(dims):
    """The params' JAX paths in two groups: sharded over fsdp (their
    gradients reduce-scattered) and replicated (all-reduced)."""
    return {"sharded": sorted(p for p, d in dims.items() if d is not None),
            "replicated": sorted(p for p, d in dims.items() if d is None)}


def _rel_tree(pairs):
    """Relative L2 over a whole group of (got, want) pairs."""
    num = sum(float((a - b).double().square().sum()) for a, b in pairs)
    den = sum(float(b.double().square().sum()) for _, b in pairs)
    return math.sqrt(num / max(den, 1e-300))


def _grad_sensitivity(tc, state, batch, idx, dims):
    """Relative L2, over each group of leaves and over the whole tree, by
    which one device's step gradients move when its images move by 1e-7
    (relative, seeded noise): how far the step amplifies a rounding of
    its forward."""
    import torch
    from repro_torch.checkpoint import bridge, flatten
    from repro_torch.core import train_step as TS
    core = TS.make_loss_core(tc.fc, tc.loss_impl)
    gamma = tc.fc.gamma_fn()(state["step"])
    img = batch["images"]
    gen = torch.Generator(device=img.device).manual_seed(0)
    noise = torch.randn(img.shape, device=img.device, generator=gen)
    g = [flatten(bridge.named_to_tree(state["params"], TS.step_grads(
        tc, core, state, {**batch, "images": im}, idx, gamma)[2]))
        for im in (img, img * (1 + 1e-7 * noise))]
    out = {grp: _rel_tree([(g[1][p], g[0][p]) for p in ps])
           for grp, ps in _leaf_groups(dims).items()}
    out["tree"] = _rel_tree([(g[1][p], g[0][p]) for p in g[0]])
    return out


def _mesh_vs_one(mesh, one, start, loss_one, loss_mesh, dims):
    """One step on the mesh against one step on one device from the same
    ``start`` (flat state trees on the host): loss, log-u and params by
    max abs error; the first moments (the reduced gradients' running
    mean) and the step's update by relative L2 over each group of leaves
    (``_leaf_groups``), and the worst leaf of each."""
    import torch
    from repro_torch.checkpoint import flatten
    start = flatten(start)
    groups = _leaf_groups(dims)

    def maxdiff(prefix):
        out = 0.0
        for k in one:
            if k.startswith(prefix):
                a, b = mesh[k].double(), one[k].double()
                d = (a - b).abs()
                d[a == b] = 0.0                  # matching -inf log-u rows
                out = max(out, float(d.max()) if d.numel() else 0.0)
        return out

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    def upd(side, p):
        return side[f"params/{p}"] - start[f"params/{p}"]
    params = [p for ps in groups.values() for p in ps]
    leaf_upd = {p: rel(upd(mesh, p), upd(one, p)) for p in params}
    leaf_mom = {p: rel(mesh[f"opt/m/{p}"], one[f"opt/m/{p}"])
                for p in params}
    return dict(
        moment_rel_l2={g: _rel_tree([(mesh[f"opt/m/{p}"], one[f"opt/m/{p}"])
                                     for p in ps])
                       for g, ps in groups.items()},
        update_rel_l2={g: _rel_tree([(upd(mesh, p), upd(one, p))
                                     for p in ps])
                       for g, ps in groups.items()},
        same_keys=(sorted(mesh) == sorted(one) and sorted(
            f"params/{p}" for p in params) == sorted(
                k for k in one if k.startswith("params/"))),
        dloss=abs(loss_mesh - loss_one), dparam=maxdiff("params/"),
        dlogu=max(maxdiff("fc/u1"), maxdiff("fc/u2")),
        params_over_5e_5=sum(int(((mesh[f"params/{p}"] - one[f"params/{p}"])
                                  .abs() > 5e-5).sum()) for p in params),
        params_moved=sum(not torch.equal(one[f"params/{p}"],
                                         start[f"params/{p}"])
                         for p in params),
        params=len(params),
        update_worst_leaf=max(leaf_upd, key=leaf_upd.get),
        update_worst_rel_l2=max(leaf_upd.values()),
        moment_worst_leaf=max(leaf_mom, key=leaf_mom.get),
        moment_worst_rel_l2=max(leaf_mom.values()))


# the mesh's steps against one device's: relative L2 over each group of
# leaves, of the first moments (the reduced gradients) and of the update
# at each step (AdamW's first step moves each entry by lr times the sign
# of its gradient, so there an entry whose sign rounding decides moves
# by 2 lr)
TOL_MESH_MOMENT, TOL_MESH_UPDATE = 1e-2, (5e-2, 1e-2)


def _rn50_mesh(checks, group):
    """``clip-rn50-cc3m`` on data:1,fsdp:2, 2 steps that both move the
    params, each against one device from the same state: loss 1e-5 and
    log-u 1e-4 by max abs error; exact launches per rank.  The gradients
    (first moments) and the update are held by relative L2 over each
    group of leaves, the sharded ones (reduce-scatter) and the replicated
    ones (all-reduce) apart, not per entry: at its random init the
    ResNet's step moves its gradients by ~1e-3 when its images move by
    1e-7 (``grad_sensitivity``, measured here), a half batch runs other
    conv algorithms than a whole one, and AdamW's first steps move each
    entry by about lr times the sign of its gradient, so an entry whose
    sign that rounding decides moves by up to 2 lr.  A lost reduction
    moves a group's moments and update by ~1; a doubled one its moments
    by 1."""
    from repro_torch.configs import get_arch
    cfg = get_arch(RN50)
    t0 = time.monotonic()
    res, reps = group.start("family", []).result()
    wall = time.monotonic() - t0
    rcs = [r.returncode for r in res]
    for r in res:
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr, flush=True)
    checks.check(rcs == [0, 0] and all(reps),
                 f"rn50_mesh: exit codes {rcs}")
    checks.end_phase("clip_family")
    want = _train_launches(cfg, 1, 0, 0, 1)
    per_step = [[st["launches"] for st in rp["steps"]] for rp in reps]
    checks.check(per_step == [[want] * 2] * 2,
                 f"rn50_mesh: launches per step {per_step}, want {want}")
    steps = reps[0]["steps"]
    for k, st in enumerate(steps):
        ok = (st["same_keys"] and st["lr"] > 0
              and st["params_moved"] == st["params"]
              and st["dloss"] <= 1e-5 and st["dlogu"] <= 1e-4
              and all(v <= TOL_MESH_MOMENT
                      for v in st["moment_rel_l2"].values())
              and all(v <= TOL_MESH_UPDATE[k]
                      for v in st["update_rel_l2"].values()))
        checks.check(ok, f"rn50_mesh: step {k} vs one device {st}")
    emit("rn50_mesh", mesh="data:1,fsdp:2", exit_codes=rcs,
         backend=reps[0].get("backend"), launches_per_step=per_step[0],
         launches_want=want, steps=steps,
         bounds=dict(loss=1e-5, log_u=1e-4,
                     moments_group_rel_l2=TOL_MESH_MOMENT,
                     update_group_rel_l2_per_step=TOL_MESH_UPDATE),
         grad_sensitivity_1e_7=reps[0].get("grad_sensitivity"),
         leaves=reps[0].get("leaves"),
         max_memory_allocated_per_rank=[rp.get("max_memory_allocated")
                                        for rp in reps],
         wall_seconds=wall)


def _rn50_serve_eval(checks, ckpt):
    """Both launchers on the step-3 checkpoint of the ResNet-50 launcher
    run (``_train_arch`` with ``ckpt``): serving of both towers (nothing
    dropped, within 1e-5 of the solo forward, cache hits bitwise; 0 K3
    per image batch, 12 per text batch), the eval pass (fused vs dense)
    and K1 on its embeddings against the plain version.  Returns the
    launch counts and K1's timings."""
    import numpy as np
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch.configs import get_arch
    from repro_torch.eval import extraction as EX
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gcl_loss as GL
    from repro_torch.launch import eval as EV
    from repro_torch.launch import serve_embed
    from repro_torch.models import backbones as BB
    from repro_torch.models import clip as C
    from repro_torch.models import precision as PR
    from repro_torch.serve import content_hash
    cfg = get_arch(RN50)
    tree, step, _ = CK.restore_subtree(ckpt, BB.param_shapes(cfg), "params")
    checks.check(step == 3, f"rn50_serve: checkpoint step {step}, want 3")
    model = BB.params_from_tree(cfg, tree, "cuda")
    del tree
    out = {}
    for tower, modality, key, per_batch in (
            ("resnet", "image", "images", 0),
            ("text", "text", "texts", cfg.n_layers)):
        record = []
        _zero_counters()
        t0 = time.monotonic()
        stats = serve_embed.main(
            ["--ckpt-dir", ckpt, "--arch", RN50, "--impl", "flash",
             "--device", "cuda", "--modality", modality, "--requests",
             str(SERVE_REQUESTS), "--classes", "32", "--per-class", "1",
             "--payload-pool", "24", "--offered-rate", "100"],
            record=record)
        wall = time.monotonic() - t0
        n_launch = FA.flash_attention.launches
        out[f"serve_{tower}"] = n_launch
        worst, computed = 0.0, {}
        for payload, res in record:
            if res.path == "compute":
                computed.setdefault(content_hash(payload), set()).add(
                    res.embedding.tobytes())
                solo = _solo_embedding(model, payload, key, "naive", PR.F32)
                worst = max(worst, float(np.abs(solo - res.embedding).max()))
        cache_exact = all(
            res.embedding.tobytes() in computed[content_hash(payload)]
            for payload, res in record if res.path == "cache")
        checks.check(stats["dropped"] == 0 and stats["completed"] > 0
                     and stats["served_cache"] > 0 and cache_exact
                     and worst <= TOL_EMBED["float32"],
                     f"rn50_serve {tower}: dropped {stats['dropped']}, "
                     f"hits {stats['served_cache']} exact {cache_exact}, "
                     f"vs solo {worst}")
        checks.check(n_launch == per_batch * stats["batches"],
                     f"rn50_serve {tower}: {n_launch} K3 launches for "
                     f"{stats['batches']} batches, want {per_batch} each")
        emit("rn50_serve", tower=tower, checkpoint_step=step,
             batches=stats["batches"], completed=stats["completed"],
             served_cache=stats["served_cache"], dropped=stats["dropped"],
             flash_launches=n_launch, launches_per_batch_want=per_batch,
             served_vs_solo_naive_max_abs=worst, tol=TOL_EMBED["float32"],
             cache_hits_bitwise=cache_exact, wall_seconds=wall)
    # K1 on the pass's embeddings (the launcher's extraction: the same
    # params, split and batches), against its plain version
    ds = EV.build_eval_dataset(argparse.Namespace(
        classes=EVAL_CLASSES, per_class=EVAL_PER_CLASS, flip_frac=0.0,
        seed=0), cfg)
    e1, e2 = (torch.from_numpy(e).to("cuda") for e in
              EX.extract_pair_embeddings(
                  lambda p, b: C.encode_pair(p, b, impl="flash"), model, ds,
                  batch_size=EVAL_BATCH, device="cuda"))
    del model
    torch.cuda.empty_cache()
    N = EVAL_CLASSES * EVAL_PER_CLASS
    metrics = {}
    for impl in ("fused", "dense"):
        _zero_counters()
        t0 = time.monotonic()
        metrics[impl] = EV.main(["--ckpt-dir", ckpt, "--arch", RN50,
                                 "--loss-impl", impl] + FAMILY_EVAL_ARGS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if impl == "fused":
            counts = dict(flash_attention=FA.flash_attention.launches,
                          gcl_pair_stats=GL.gcl_pair_stats.launches,
                          gcl_pair_stats_cuda=GL.gcl_pair_stats.cuda_launches)
            wall_fused = wall
    want = dict(flash_attention=cfg.n_layers * (-(-N // EVAL_BATCH) + 1),
                gcl_pair_stats=1, gcl_pair_stats_cuda=2)
    f, d = metrics["fused"], metrics["dense"]
    # K1's rtol and atol: at this init the O(1) log-sum-exp terms of the
    # loss cancel to ~3e-6, where a relative bound alone measures rounding
    rel = abs(f["eval_loss"] - d["eval_loss"]) / max(abs(d["eval_loss"]),
                                                     1.0)
    checks.check(counts == want, f"rn50_eval: launches {counts}, want {want}")
    checks.check(rel <= TOL_K1 and all(f[k] == d[k] for k in f
                                       if k != "eval_loss")
                 and all(math.isfinite(v) for v in f.values()),
                 f"rn50_eval: fused {f} vs dense {d}")
    emit("rn50_eval", N=N, batch=EVAL_BATCH, launches=counts,
         launches_want=want, metrics_fused=f, metrics_dense=d,
         eval_loss_err_vs_max_1=rel, rtol_atol=TOL_K1,
         wall_seconds_fused=wall_fused,
         wall_seconds_dense=wall)
    out["eval"] = counts
    out["eval_k1"] = _eval_k1(checks, "rn50_eval", e1, e2, counts,
                              against_f64=True)
    return out


def phase_clip_family(checks, beside=None, child=None):
    """The paper's other two CLIP settings at full width and depth, seeded
    random weights, v3, AdamW, global batch 256 on the card: the ResNet-50
    (train, serve, eval; on the mesh and ``beside()``, both untimed,
    beside its launcher's checkpoint write), ViT-B/16 (train).  ``child``:
    a held ``_LauncherProcess`` for the ResNet-50 launcher; the mesh's
    ranks start held with the phase.  Returns the launch counts of their
    runs and K1's timings at the ResNet-50's eval shape."""
    import torch
    mesh = _HeldGroup(2, 1500)

    def untimed():
        if beside is not None:
            beside()
        _rn50_mesh(checks, mesh)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_rn50_")
    try:
        out = {"rn50_train": _train_arch(checks, RN50, "rn50", ckpt=ckpt,
                                         beside_write=untimed, child=child)}
        checks.end_phase("clip_family")
        out.update(_rn50_serve_eval(checks, ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    checks.end_phase("clip_family")
    out["vitb16_train"] = _train_arch(checks, VITB16, "vitb16")
    checks.end_phase("clip_family")
    return out


# ---------------------------------------------------------------------------
# phase mesh: the (data, fsdp) mesh on the card
# ---------------------------------------------------------------------------

MESH_AXES = ("data", "fsdp")
MESH_ARGS = TRAIN_ARGS + ["--precision", "f32", "--steps", "3"]
# K1 / K2 at the per-rank shape of data:2,fsdp:2 at global batch 256: each
# rank's 64 rows against the 256 gathered columns, at its row offset
MESH_GCL_CASES = [(f"mesh_rank{r}", 64, 256, 512, 64 * r, "float32", 0.07,
                   False, True) for r in range(4)]
MESH_EVAL_N = EVAL_CLASSES * EVAL_PER_CLASS
# the step-level checks on 4 ranks run clip-vitb32-cc12m at full width
# with this many of each tower's 12 layers, a depth cut that keeps the
# whole run inside its time (PERF.md § 4); the launcher runs on the mesh
# keep the full depth
MESH_STEP_LAYERS = 6


def _mesh_step_cfg():
    """``ARCH`` at ``MESH_STEP_LAYERS`` layers in each tower."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    return cfg.replace(n_layers=MESH_STEP_LAYERS, clip=dataclasses.replace(
        cfg.clip, vision_layers=MESH_STEP_LAYERS))


def _counters():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gcl_loss as GL
    return dict(flash_attention=FA.flash_attention.launches,
                gcl_pair_stats=GL.gcl_pair_stats.launches,
                gcl_pair_grads=GL.gcl_pair_grads.launches,
                gcl_pair_stats_cuda=GL.gcl_pair_stats.cuda_launches,
                gcl_pair_grads_cuda=GL.gcl_pair_grads.cuda_launches)


def _zero_counters():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gcl_loss as GL
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_seq.clear()
    for fn in (GL.gcl_pair_stats, GL.gcl_pair_grads):
        fn.launches = fn.cuda_launches = 0


def _k3_layers(cfg):
    """Attention layers of one pass through both towers (the ResNet has
    none)."""
    return cfg.n_layers + (cfg.clip.vision_layers
                           if cfg.clip.vision_arch == "vit" else 0)


def _train_launches(cfg, steps, evals, eval_pairs, eval_batch, mb=1):
    """Launches of one rank's (or one device's) launcher run: K3 in both
    towers per step (per micro-step), K1 and K2 once per step; an eval
    pass runs K3 over its batches and the prompt head, K1 once."""
    n_layers = _k3_layers(cfg)
    flash = n_layers * steps * mb + evals * (
        n_layers * -(-eval_pairs // eval_batch) + cfg.n_layers)
    return dict(flash_attention=flash, gcl_pair_stats=steps + evals,
                gcl_pair_grads=steps,
                gcl_pair_stats_cuda=2 * (steps + evals),
                gcl_pair_grads_cuda=2 * steps)


def _flag(argv, name, default=0):
    return int(argv[argv.index(name) + 1]) if name in argv else default


def _step_gaps_ms(record, eval_every, ckpt_every):
    """Host-clock gaps between consecutive steps' records that hold a
    step alone: a gap after step s holds the eval when (s + 1) is a
    multiple of ``eval_every`` and the checkpoint when it is one of
    ``ckpt_every`` (0: never), and those gaps are left out."""
    return [(b["time"] - a["time"]) * 1e3 for a, b in zip(record, record[1:])
            if not any(n and (a["step"] + 1) % n == 0
                       for n in (eval_every, ckpt_every))]


def _state_digests(state):
    """{flat path: sha256 of the leaf's bytes} of a train state (a rank's
    shards, or a full tree of tensors or numpy arrays)."""
    import hashlib
    import numpy as np
    from repro_torch.checkpoint import flatten

    def raw(v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().contiguous().numpy()
        return np.ascontiguousarray(v).tobytes()
    return {k: hashlib.sha256(raw(v)).hexdigest()
            for k, v in flatten(state).items()}


def _restore_vs_rank_shards(tree, rank_digests, data, fsdp):
    """The leaves where the merged restore ``tree``, cut into rank r's
    shards of the (data, fsdp) mesh, differs in any bit from the shards
    rank r held at the end of its run (``rank_digests[r]``)."""
    import torch
    from repro_torch.core import shard_state as SS
    from repro_torch.launch import mesh as MS
    bad = []
    for r, want in enumerate(rank_digests):
        mesh = MS.Mesh(data, fsdp, r, torch.device("cpu"), None,
                       {"data": None, "fsdp": None})
        got = _state_digests(SS.shard_train_state(tree, mesh))
        bad += [f"rank{r}:{k}" for k in sorted(set(got) | set(want or {}))
                if got.get(k) != (want or {}).get(k)]
    return bad


def _mesh_worker_train(argv):
    """One rank of the launcher on the mesh: reports its launches, its
    peak memory, the host-clock time of its steps that ran no eval or
    checkpoint, and the digests of its final shards on one JSON line."""
    import torch
    from repro_torch.launch import train
    rank = int(argv[argv.index("--process-id") + 1])
    _zero_counters()
    record = []
    state = train.main(argv, record=record)
    print(json.dumps({"mesh_rank": rank, "launches": _counters(),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated(),
                      "losses": [r["loss"] for r in record],
                      "ms_step_gaps_without_eval": _step_gaps_ms(
                          record, _flag(argv, "--eval-every"),
                          _flag(argv, "--ckpt-every")),
                      "state_sha256": _state_digests(state)}), flush=True)


def _mesh_batches(cfg, rank, steps, full, n_shards=4):
    """The first ``steps`` (idx, batch) of the launcher's ``n_shards``
    loader at MESH_ARGS: this rank's rows, or (``full``) the whole global
    batch, on the card."""
    import numpy as np
    import torch
    from repro_torch.data import ContrastiveDataset, ShardedLoader
    ds = ContrastiveDataset(n=2048, image_size=cfg.clip.image_size,
                            context_length=cfg.clip.context_length,
                            vocab_size=cfg.vocab_size, n_classes=64)
    loader = ShardedLoader(ds, global_batch=256, n_shards=n_shards, seed=0,
                           owned_shards=None if full else (rank,))
    out = []
    for _, _, idx, batch in loader.steps(steps):
        idx = idx if full else loader._owned_rows(idx)
        out.append((torch.from_numpy(np.asarray(idx)).cuda(),
                    {k: torch.from_numpy(v).cuda() for k, v in batch.items()}))
    return out


def _mesh_worker_step(argv):
    """One rank of the step-level checks on the card (data:2,fsdp:2):
    step-1 gradients after the reduction and merge against the
    single-device step's on the same global batch; 3 steps against 3
    single-device steps; microbatch 2 against 1; the sharded eval forms.
    Rank 0 reports the comparisons; every rank its launches.  The arch
    at ``MESH_STEP_LAYERS`` layers per tower."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import bridge, flatten, unflatten
    from repro_torch.core import shard_state as SS
    from repro_torch.core import train_step as TS
    from repro_torch.data import ZeroShotEvalDataset
    from repro_torch.eval import engine as EN
    from repro_torch.eval import planted as PL
    from repro_torch.eval import retrieval as RT
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import multiprocess as MP
    rank = int(argv[argv.index("--process-id") + 1])
    dev = MP.initialize(argv[argv.index("--coordinator") + 1],
                        int(argv[argv.index("--num-processes") + 1]), rank,
                        "cuda")
    rep = {"mesh_rank": rank}
    try:
        mesh = MS.make_train_mesh(2, 2, device=dev)
        rep["backend"] = mesh.backend
        cfg = _mesh_step_cfg()
        tc1 = _train_config(cfg, "flash", "fused")
        tcm = dataclasses.replace(tc1, fsdp=True, mesh_axes=MESH_AXES)
        st1 = TS.init_train_state(torch.Generator().manual_seed(0), tc1,
                                  "cpu")
        tree = unflatten({k: v.clone() for k, v in flatten(
            bridge.state_to_tree(st1)).items()})
        local = _mesh_batches(cfg, rank, 3, full=False)
        step = TS.make_train_step(tcm)
        dims = step.param_dims
        gamma = tc1.fc.gamma_fn()(torch.zeros((), dtype=torch.int32))
        st = SS.shard_train_state(tree, mesh, dims)
        _, _, g_sh, _ = step.step_grads(st, local[0][1], local[0][0], gamma)
        g_full = SS.full_params(g_sh, dims)
        full = _mesh_batches(cfg, rank, 3, full=True) if rank == 0 else None
        if rank == 0:
            # the single-device step on the same global batch
            st1 = bridge.state_from_tree(
                {**st1, "params": st1["params"].cuda()}, tree)
            core = TS.make_loss_core(tc1.fc, "fused")
            _, _, g1, _ = TS.step_grads(tc1, core, st1, full[0][1],
                                        full[0][0], gamma)
            g1 = flatten(bridge.named_to_tree(st1["params"], g1))
            rel = {k: ((g_full[k] - g1[k]).norm() / g1[k].norm().clamp_min(
                1e-30)).item() for k in g1}
            worst = max(rel, key=rel.get)
            rep.update(grad_leaves=len(rel), grad_worst_leaf=worst,
                       grad_worst_rel_l2=rel[worst])
            del g1
        del g_sh
        # step-1 gradients through two micro-steps per rank
        step2 = TS.make_train_step(dataclasses.replace(tcm, microbatch=2))
        _, _, g2, _ = step2.step_grads(st, local[0][1], local[0][0], gamma)
        g2 = SS.full_params(g2, dims)
        rel = {k: ((g2[k] - g_full[k]).norm() / g_full[k].norm().clamp_min(
            1e-30)).item() for k in g_full}
        worst = max(rel, key=rel.get)
        rep.update(mb2_grad_worst_leaf=worst, mb2_grad_worst_rel_l2=rel[worst])
        del g2, st, g_full
        # three steps: sharded (microbatch 1, then 2) and single-device
        runs = {}
        for mb in (1, 2):
            s = SS.shard_train_state(tree, mesh, dims)
            fn = TS.make_train_step(dataclasses.replace(tcm, microbatch=mb))
            losses, taus, per_step = [], [], []
            for idx, batch in local:
                _zero_counters()
                s, m = fn(s, batch, idx)
                per_step.append(_counters())
                losses.append(float(m["loss"]))
                taus.append(float(m["tau"]))
            runs[mb] = (losses, taus, SS.full_params(s["params"], dims))
            rep[f"mb{mb}_launches_per_step"] = per_step
            del s
        if rank == 0:
            fn1 = TS.make_train_step(tc1, "cuda")
            losses, taus = [], []
            for idx, batch in full:
                st1, m = fn1(st1, batch, idx)
                losses.append(float(m["loss"]))
                taus.append(float(m["tau"]))
            rep["single_losses"], rep["single_taus"] = losses, taus
            rep["mesh_losses"], rep["mesh_taus"] = runs[1][:2]
            rep["traj_worst_rel"] = max(
                abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
                    runs[1][0] + runs[1][1], losses + taus))
            rep["mb2_traj_worst_rel"] = max(
                abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
                    runs[2][0] + runs[2][1], runs[1][0] + runs[1][1]))
            rep["mb2_dloss"] = max(abs(a - b) for a, b in zip(
                runs[1][0], runs[2][0]))
            rep["mb2_dparam"] = max(
                (runs[1][2][k] - runs[2][2][k]).abs().max().item()
                for k in runs[1][2])
            del st1
        del runs
        torch.cuda.empty_cache()
        # the sharded eval forms, exact
        q1, q2 = quantized_emb(MESH_EVAL_N, 512, 0), quantized_emb(
            MESH_EVAL_N, 512, 1)
        q2[10:13] = q2[3:6]                          # exact ties
        (s1, i1), (s2, i2) = RT.sharded_retrieval_topk(
            mesh, MESH_AXES, q1, q2, RETRIEVAL_K, chunk=RETRIEVAL_CHUNK)
        (d1, j1), (d2, j2) = RT.retrieval_topk(q1, q2, RETRIEVAL_K,
                                               chunk=RETRIEVAL_CHUNK)
        rep["sharded_topk_bitwise"] = bool(
            torch.equal(i1, j1) and torch.equal(i2, j2)
            and _bits_equal(s1, d1) and _bits_equal(s2, d2))
        ds = ZeroShotEvalDataset(n_classes=EVAL_CLASSES,
                                 n_per_class=EVAL_PER_CLASS, seed=0)
        got = EN.evaluate_planted(PL.planted_params(ds, dev), ds,
                                  batch_size=EVAL_BATCH, device=dev,
                                  mesh=mesh, axes=MESH_AXES)
        want = PL.known_answers(ds)
        rep["planted_exact"] = all(got[k] == v for k, v in want.items())
        rep["planted"] = got
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    finally:
        MS.set_mesh(None)
        MP.shutdown()
    print(json.dumps(rep), flush=True)


class _HeldGroup:
    """``nproc`` ranks of this script on the card started held (a
    thread waits for the group): ``start`` gives them a worker ``kind``
    and its ``args``, ``result`` waits for (harness results, one report
    dict per rank)."""

    def __init__(self, nproc=4, timeout=900):
        import threading
        self.hold, self.res = _hold_path(), None
        self.thread = threading.Thread(target=self._run,
                                       args=(nproc, timeout), daemon=True)
        self.thread.start()

    def _run(self, nproc, timeout):
        from repro_torch.launch import multiprocess as MP
        self.res = MP.run_train_multiprocess(
            ["--hold", self.hold], num_processes=nproc, timeout=timeout,
            module="chip_smoke",
            env_extra={"PYTHONPATH": os.pathsep.join([SRC, ROOT])})

    def start(self, kind, args):
        _release(self.hold, ["--mesh-worker", kind, *args])
        return self

    def result(self):
        self.thread.join()
        reports = []
        for r in self.res:
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith('{"mesh_rank"')]
            reports.append(json.loads(lines[-1]) if lines else None)
        return self.res, reports


def _spawn_mesh(kind, args, timeout, nproc=4):
    """``nproc`` ranks of this script's worker ``kind`` on the card;
    returns (harness results, one report dict per rank)."""
    return _HeldGroup(nproc, timeout).start(kind, args).result()


def phase_mesh(checks, train_rec, train_tree):
    """The (data, fsdp) mesh on the card; returns the kernels' per-rank
    launches of the data:2,fsdp:2 launcher run and the K1/K2 timings at
    the per-rank shape.  The 2x2 launcher's steps run alone; the 1x1
    launcher (held to phase train's run, not timed against anything)
    runs beside the step-level checks, which time nothing, and beside
    the check of the 2x2 checkpoint."""
    import concurrent.futures
    import numpy as np
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch.checkpoint import flatten
    from repro_torch.configs import get_arch

    cfg = get_arch(ARCH)
    # the phase's children start held: their imports run beside the K1 /
    # K2 cases and the 2x2 launcher's own start
    group4, child, group_step = (_HeldGroup(4, 1500), _LauncherProcess(),
                                 _HeldGroup(4, 1500))
    # K1 / K2 at the per-rank shape, each row offset
    gen = torch.Generator(device="cuda").manual_seed(3)
    timings = {}
    for case in MESH_GCL_CASES:
        _gcl_case(checks, gen, case, timings, phase="mesh_gcl")

    # data:2,fsdp:2: four ranks sharing the card (gloo), through the
    # multi-process launcher, with --eval-every and a sharded checkpoint
    d4 = tempfile.mkdtemp(prefix="chip_smoke_mesh4_")
    d1 = tempfile.mkdtemp(prefix="chip_smoke_mesh1_")
    try:
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        res4, reps4 = group4.start("train", MESH_ARGS + [
            "--mesh", "data:2,fsdp:2", "--eval-every", "2",
            "--eval-classes", "8", "--eval-per-class", "8",
            "--eval-batch", "64", "--ckpt-dir", d4, "--ckpt-every",
            "100"]).result()
        wall4 = time.monotonic() - t0
        rcs4 = [r.returncode for r in res4]
        for r in res4:
            if r.returncode:
                print(r.stderr[-3000:], file=sys.stderr, flush=True)
        lines = [[ln for ln in r.stdout.splitlines()
                  if ln.startswith(("step ", "eval "))] for r in res4]
        want4 = _train_launches(cfg, 3, 2, 64, 64)
        launches = [rp["launches"] if rp else None for rp in reps4]

        # data:1,fsdp:1: a one-rank group (NCCL) in a process of its own,
        # held to phase train's run, beside the check of the 2x2
        # checkpoint and the step-level checks
        t1 = time.monotonic()
        child.start(MESH_ARGS + ["--mesh", "data:1,fsdp:1", "--ckpt-dir",
                                 d1, "--ckpt-every", "100"])
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            try:
                verified = pool.submit(_mesh_ckpt_check, d4, train_tree,
                                       [(rp or {}).get("state_sha256")
                                        for rp in reps4])
                # step-level parity, microbatch 2, the sharded eval forms
                torch.cuda.empty_cache()
                t0 = time.monotonic()
                res, reps = group_step.start("step", []).result()
                wall = time.monotonic() - t0
            finally:
                rc1, rep1, _, err1 = child.finish(900)
            ok_ckpt, differ, finite = verified.result()
        wall1 = time.monotonic() - t1
        if rc1 or rep1 is None:
            print(err1, file=sys.stderr, flush=True)
        checks.check(rc1 == 0 and rep1 is not None,
                     f"mesh 1x1: launcher process exit code {rc1}")
        checks.end_phase("mesh")
        counts, record = rep1["launches"], rep1["record"]
        first = next(ln for ln in child.lines if ln)
        tree, step, _ = CK.restore(d1, CK.unflatten(
            {k: v for k, v in train_tree.items()}))
    finally:
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d4, ignore_errors=True)
    tree = flatten(tree)
    want = _train_launches(cfg, 3, 0, 0, 1)
    traj = max(abs(r[k] - w[k]) / max(abs(w[k]), 1e-30)
               for r, w in zip(record, train_rec)
               for k in ("loss", "tau", "loss_value", "u_mean"))
    lines_bitwise = all(r[k] == w[k] for r, w in zip(record, train_rec)
                        for k in w if k not in ("time",))
    state_bitwise = all(tree[k].tobytes() == train_tree[k].tobytes()
                        for k in train_tree)
    state_err = max(float(np.max(np.abs(
        tree[k][np.isfinite(train_tree[k])].astype(np.float64)
        - train_tree[k][np.isfinite(train_tree[k])]), initial=0.0))
        for k in train_tree if tree[k].dtype.kind == "f")
    checks.check(first.startswith("mesh data:1,fsdp:1 backend nccl world 1"),
                 f"mesh 1x1: first line {first!r}")
    checks.check(counts == want, f"mesh 1x1: launches {counts}, want {want}")
    checks.check(len(record) == 3 and traj <= TOL_TRAIN_TRAJ and step == 3,
                 f"mesh 1x1: trajectory rel {traj} vs the single-device run")
    emit("mesh_1x1", first_line=first, launches=counts, launches_want=want,
         losses=[r["loss"] for r in record], worst_rel_traj=traj,
         tol=TOL_TRAIN_TRAJ, log_lines_bitwise=lines_bitwise,
         final_state_bitwise=state_bitwise, final_state_max_abs_err=state_err,
         ms_step_gaps=_step_gaps_ms(record, 0, 100), wall_seconds=wall1)
    del tree

    rcs = [r.returncode for r in res]
    for r in res:
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr, flush=True)
    r0 = reps[0] or {}
    want1 = _train_launches(_mesh_step_cfg(), 1, 0, 0, 1)
    want2 = _train_launches(_mesh_step_cfg(), 1, 0, 0, 1, mb=2)
    per_step = [(rp or {}).get("mb1_launches_per_step") for rp in reps]
    per_step2 = [(rp or {}).get("mb2_launches_per_step") for rp in reps]
    checks.check(rcs == [0] * 4 and all(reps),
                 f"mesh step: exit codes {rcs}")
    checks.check(r0.get("grad_worst_rel_l2", 1.0) <= TOL_TRAIN_GRAD,
                 f"mesh step: step-1 grads, worst leaf "
                 f"{r0.get('grad_worst_leaf')} rel L2 "
                 f"{r0.get('grad_worst_rel_l2')}")
    checks.check(r0.get("traj_worst_rel", 1.0) <= TOL_TRAIN_TRAJ,
                 f"mesh step: loss/tau trajectory rel "
                 f"{r0.get('traj_worst_rel')}")
    checks.check(r0.get("mb2_grad_worst_rel_l2", 1.0) <= TOL_TRAIN_GRAD
                 and r0.get("mb2_traj_worst_rel", 1.0) <= TOL_TRAIN_TRAJ,
                 f"mesh step: microbatch 2 vs 1 step-1 grads rel L2 "
                 f"{r0.get('mb2_grad_worst_rel_l2')}, trajectory rel "
                 f"{r0.get('mb2_traj_worst_rel')}")
    checks.check(per_step == [[want1] * 3] * 4
                 and per_step2 == [[want2] * 3] * 4,
                 f"mesh step: launches per step {per_step} / {per_step2}, "
                 f"want {want1} / {want2}")
    checks.check(all((rp or {}).get("sharded_topk_bitwise")
                     and (rp or {}).get("planted_exact") for rp in reps),
                 "mesh step: the sharded eval is not exact")
    emit("mesh_step", exit_codes=rcs, backend=r0.get("backend"),
         layers_per_tower=MESH_STEP_LAYERS,
         grad_leaves=r0.get("grad_leaves"),
         grad_worst_leaf=r0.get("grad_worst_leaf"),
         grad_worst_rel_l2=r0.get("grad_worst_rel_l2"), tol=TOL_TRAIN_GRAD,
         mesh_losses=r0.get("mesh_losses"),
         single_losses=r0.get("single_losses"),
         mesh_taus=r0.get("mesh_taus"), single_taus=r0.get("single_taus"),
         traj_worst_rel=r0.get("traj_worst_rel"), traj_tol=TOL_TRAIN_TRAJ,
         mb2_grad_worst_leaf=r0.get("mb2_grad_worst_leaf"),
         mb2_grad_worst_rel_l2=r0.get("mb2_grad_worst_rel_l2"),
         mb2_traj_worst_rel=r0.get("mb2_traj_worst_rel"),
         mb2_dloss=r0.get("mb2_dloss"), mb2_dparam_after_3_steps=r0.get(
             "mb2_dparam"), launches_per_step_mb1=want1,
         launches_per_step_mb2=want2,
         sharded_topk_bitwise=[(rp or {}).get("sharded_topk_bitwise")
                               for rp in reps],
         planted=r0.get("planted"),
         max_memory_allocated_per_rank=[
             (rp or {}).get("max_memory_allocated") for rp in reps],
         wall_seconds=wall)

    checks.check(rcs4 == [0] * 4, f"mesh 2x2 launcher: exit codes {rcs4}")
    checks.check(all(ln == lines[0] for ln in lines)
                 and len([x for x in lines[0] if x.startswith("step ")]) == 3
                 and len([x for x in lines[0] if x.startswith("eval ")]) == 2,
                 f"mesh 2x2 launcher: rank lines differ {lines}")
    checks.check(launches == [want4] * 4,
                 f"mesh 2x2 launcher: launches {launches}, want {want4}")
    checks.check(ok_ckpt and finite and not differ,
                 "mesh 2x2 launcher: the sharded checkpoint does not verify "
                 f"or restore merged (leaves differing from the ranks' "
                 f"final shards: {differ[:8]})")
    emit("mesh_2x2_launcher", exit_codes=rcs4, step_lines=lines[0],
         launches_per_rank=launches, launches_want=want4,
         max_memory_allocated_per_rank=[
             rp["max_memory_allocated"] if rp else None for rp in reps4],
         ms_step_gaps_without_eval_per_rank=[
             rp["ms_step_gaps_without_eval"] if rp else None for rp in reps4],
         checkpoint_verified=ok_ckpt, restored_merged_finite=finite,
         restored_merged_equals_rank_shards_bitwise=not differ,
         wall_seconds=wall4)
    checks.end_phase("mesh")
    return {"launches_per_rank": launches[0], "gcl": timings}


def _mesh_ckpt_check(d4, train_tree, rank_digests):
    """The data:2,fsdp:2 launcher's checkpoint: the latest step is 3; its
    merged restore, cut into each rank's shards, equals bitwise the
    shards each rank held at the end (``rank_digests``); the merged
    state loads into a single-device state on the card, all finite.
    Returns (latest is 3, the leaves that differ, finite)."""
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch.checkpoint import bridge
    from repro_torch.configs import get_arch
    from repro_torch.core import train_step as TS
    ok_ckpt = CK.latest_step(d4) == 3
    tree, _, _ = CK.restore(d4, CK.unflatten(
        {k: v for k, v in train_tree.items()}))
    differ = _restore_vs_rank_shards(tree, rank_digests, 2, 2)
    st = TS.init_train_state(torch.Generator().manual_seed(1),
                             _train_config(get_arch(ARCH), "flash", "fused"),
                             "cuda")
    st = bridge.state_from_tree(st, tree)
    finite = all(bool(torch.isfinite(p).all())
                 for p in st["params"].parameters())
    return ok_ckpt, differ, finite


# ---------------------------------------------------------------------------
# phase resilience: chaos, rollback, async checkpoints, streaming, curricula
# ---------------------------------------------------------------------------

# the launcher at full width and depth: v3, f32, global batch 256, 1024
# samples (4 steps per epoch), the kernel path, seed 0
RES_ARGS = ["--arch", ARCH, "--version", "v3", "--optimizer", "adamw",
            "--global-batch", "256", "--n-samples", "1024", "--log-every",
            "1", "--device", "cuda", "--seed", "0", "--precision", "f32",
            "--impl", "flash", "--loss-impl", "fused", "--steps", "4"]
# ViT-B/32's 7 x 7 patch grid leaves one smaller image size, 32 (one
# patch); the text context 32 of 77
RES_CURRICULUM = ["--image-size-schedule", "0:32,2:224",
                  "--context-schedule", "0:32,2:77"]
# the mesh cases at the reduced size: data:2,fsdp:2 as 4 gloo ranks on
# the card (this script's --mesh-worker ranks: launches and final shards)
RES_MESH_ARGS = ["--arch", ARCH, "--reduced", "--global-batch", "16",
                 "--n-samples", "32", "--log-every", "1", "--mesh",
                 "data:2,fsdp:2", "--device", "cuda", "--impl", "flash",
                 "--loss-impl", "fused", "--seed", "0"]


def _res_run(argv, on_step=None, digests=True):
    """The launcher in this process on ``argv``, its output captured; the
    counts set to 0 just before and read just after.  ``on_step(record)``
    runs after each step's record; ``digests``: the sha256 of every leaf
    of the final state (~2 s at full width), for the bitwise checks."""
    import contextlib
    import io
    import torch
    from repro_torch.checkpoint import bridge
    from repro_torch.launch import train

    class Record(list):
        def append(self, item):
            super().append(item)
            if on_step is not None:
                on_step(item)

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    record, out = Record(), io.StringIO()
    sync()
    _zero_counters()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        st = train.main(argv, record=record)
    sync()
    wall = time.monotonic() - t0
    res = dict(launches=_counters(), by_seq=_by_seq(), record=list(record),
               out=out.getvalue(), wall=wall)
    if digests:
        res["digests"] = _state_digests(bridge.state_to_tree(st))
    del st
    torch.cuda.empty_cache()
    return res


def _res_worker(argv):
    """One full-width launcher run of phase resilience in a process of its
    own (spawned by it, never by hand): ``_res_run``'s result on one JSON
    line."""
    res = _res_run(argv)
    print(json.dumps({"res_worker": res}), flush=True)


def _spawn_logged(cmd, log_path, env):
    log = open(log_path, "w+")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=ROOT), log


def _ckpt_digests(directory, step):
    """sha256 per leaf of a checkpoint step, merged (digest-verified)."""
    from repro_torch.checkpoint import checkpoint as CKM
    return _state_digests(CKM._load_verified(directory, step)[0])


def _host_batch_seconds(loader, n):
    """Host seconds per batch of ``loader``'s first ``n`` batches, pulled
    one after another with no step in between."""
    t0 = time.monotonic()
    got = sum(1 for _ in loader.steps(n))
    return (time.monotonic() - t0) / got


def _res_mesh(tmp):
    """The mesh cases (reduced, data:2,fsdp:2, 4 ranks on the card): a
    clean run with checkpoints at 2 and 4, a ``kill@3`` run and a
    ``nan_batch@2`` run at once, then the kill's ``--resume``, whose
    ranks start held with the others (their imports done by their
    turn)."""
    from repro_torch import checkpoint as CK
    ref_d, kill_d = (os.path.join(tmp, n) for n in ("mesh_ref", "mesh_kill"))
    t0 = time.monotonic()
    groups = {}
    for name, args in (
            ("ref", ["--steps", "4", "--guard", "--ckpt-dir", ref_d,
                     "--ckpt-every", "2"]),
            ("kill", ["--steps", "4", "--ckpt-dir", kill_d, "--ckpt-every",
                      "2", "--chaos", "kill@3"]),
            ("nan", ["--steps", "3", "--guard", "--chaos", "nan_batch@2"])):
        groups[name] = _HeldGroup(4, 600).start("train", RES_MESH_ARGS + args)
    resume = _HeldGroup(4, 900)
    out = {"kill": groups["kill"].result()}
    out["kill_latest"] = CK.latest_step(kill_d)
    resume.start("train", RES_MESH_ARGS + [
        "--steps", "4", "--ckpt-dir", kill_d, "--ckpt-every", "2",
        "--resume"])
    out.update(ref=groups["ref"].result(), nan=groups["nan"].result(),
               resume=resume.result())
    out["ref_step2"] = CK.checkpoint._load_verified(ref_d, 2)[0]
    out["wall"] = time.monotonic() - t0
    return out


def phase_resilience(checks):
    """Chaos, rollback, async checkpoints, the streaming loader and the
    curricula through the port's launcher at full width, the mesh cases
    at the reduced size.  The cases that wait on 1.8 GB
    ``savez_compressed`` writes overlap: the ``kill@3`` subprocess runs
    beside the oracle, the async + rollback run (a worker process)
    starts after the oracle's last timed step and runs beside the
    resume, the NaN and curriculum runs and the mesh cases (from the
    oracle's step 3 too); the timed streaming runs come last, alone.  Returns the
    kernels' launches per full-width case."""
    import concurrent.futures
    import signal
    import threading
    from repro_torch import checkpoint as CK
    from repro_torch.configs import get_arch
    from repro_torch.data import (ContrastiveDataset, ShardedLoader,
                                  StreamingDataset, StreamingLoader,
                                  write_contrastive_shards)
    cfg = get_arch(ARCH)
    one = _train_launches(cfg, 1, 0, 0, 1)

    def steps(n):
        return {k: v * n for k, v in one.items()}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_res_")
    d0, d1, d2 = (os.path.join(tmp, n) for n in ("oracle", "async", "kill"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, ROOT])}
    procs, logs = {}, []
    mt = reads = None
    launches = {}
    t_phase = time.monotonic()
    try:
        # kill@3 of a launcher subprocess, beside the oracle
        procs["kill"], log = _spawn_logged(
            [sys.executable, "-m", "repro_torch.launch.train", *RES_ARGS,
             "--guard", "--ckpt-dir", d2, "--ckpt-every", "2", "--chaos",
             "kill@3"], os.path.join(tmp, "kill.log"), env)
        logs.append(log)

        mesh = {}

        def start_async(item):
            # after the oracle's last timed step: saves, rollback; the mesh
            # cases (reduced) run from here
            if item["step"] == 3 and "async" not in procs:
                mt.start()
                procs["async"], alog = _spawn_logged(
                    [sys.executable, "-m", "chip_smoke", "--res-worker",
                     *RES_ARGS, "--ckpt-async", "--ckpt-keep", "1",
                     "--rollback-after", "2", "--ckpt-dir", d1,
                     "--ckpt-every", "2", "--chaos",
                     "nan_batch@2,nan_batch@3"],
                    os.path.join(tmp, "async.log"), env)
                logs.append(alog)

        # the oracle: 4 steps, synchronous saves at 2 and 4
        mt = threading.Thread(target=lambda: mesh.update(_res_mesh(tmp)))
        o = _res_run(RES_ARGS + ["--guard", "--ckpt-dir", d0,
                                 "--ckpt-every", "2"], on_step=start_async)
        if mt.ident is None:          # an oracle that stopped early
            mt.start()
        oracle, rec = o["digests"], o["record"]
        launches["oracle"] = o["launches"]
        sync_gap = (rec[2]["time"] - rec[1]["time"]) * 1e3
        free = _step_gaps_ms(rec, 0, 2)
        checks.check(o["launches"] == steps(4) and len(rec) == 4
                     and CK.available_steps(d0) == [2, 4],
                     f"resilience oracle: launches {o['launches']}, steps "
                     f"{[r['step'] for r in rec]}, saved "
                     f"{CK.available_steps(d0)}")
        emit("resilience_oracle", launches=o["launches"],
             losses=[r["loss"] for r in rec],
             ms_step_gaps_without_save=free,
             ms_gap_with_sync_save=sync_gap, wall_seconds=o["wall"])

        # the reads that verify the oracle's step 2 and the killed run's
        # newest step, beside the runs below
        reads = concurrent.futures.ThreadPoolExecutor(2)
        want2_f = reads.submit(_ckpt_digests, d0, 2)

        # kill_resume: the subprocess died before step 3; resume here (its
        # first write, of step 4, comes after its steps 2 and 3)
        rc = procs["kill"].wait(timeout=900)
        klatest_f = reads.submit(CK.latest_step, d2)
        k = _res_run(RES_ARGS + ["--guard", "--ckpt-dir", d2, "--ckpt-every",
                                 "2", "--resume"])
        klatest = klatest_f.result()
        launches["kill_resume"] = k["launches"]
        logs[0].seek(0)
        checks.check(rc == -signal.SIGKILL and klatest == 2
                     and "resumed from step 2" in k["out"]
                     and k["digests"] == oracle
                     and k["launches"] == steps(2),
                     f"resilience kill_resume: rc {rc}, latest {klatest}, "
                     f"bitwise {k['digests'] == oracle}, launches "
                     f"{k['launches']}; subprocess: {logs[0].read()[-2000:]}")
        emit("resilience_kill_resume", returncode=rc, latest_step=klatest,
             bitwise_vs_oracle=k["digests"] == oracle,
             launches=k["launches"], wall_seconds=k["wall"])

        # nan_skip: the poisoned step 2 leaves the state of step 2
        n = _res_run(RES_ARGS + ["--guard", "--chaos", "nan_batch@2",
                                 "--steps", "3"])
        launches["nan_skip"] = n["launches"]
        want2 = want2_f.result()
        nskip = n["out"].count('"skipped": 1.0')
        checks.check(n["digests"] == want2 and nskip == 1
                     and n["out"].count('"skipped": 0.0') == 2
                     and n["launches"] == steps(3),
                     f"resilience nan_skip: bitwise {n['digests'] == want2}"
                     f", skipped lines {nskip}, launches {n['launches']}")
        emit("resilience_nan_skip", bitwise_vs_oracle_step2=n["digests"] ==
             want2, skipped_lines=nskip, launches=n["launches"],
             wall_seconds=n["wall"])

        # the curricula, kernel path vs plain path
        ck = _res_run(RES_ARGS + RES_CURRICULUM, digests=False)
        cp = _res_run(RES_ARGS + RES_CURRICULUM + ["--impl", "chunked",
                                                   "--loss-impl", "dense"],
                      digests=False)
        launches["curriculum"] = ck["launches"]
        traj = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(ck["record"], cp["record"])
                   for k in ("loss", "tau", "loss_value", "u_mean"))
        # two steps at each stage, one launch per layer of each tower
        vis, txt = 2 * cfg.clip.vision_layers, 2 * cfg.n_layers
        want_seq = {"2x2": vis, "32x32": txt, "50x50": vis, "77x77": txt}
        checks.check(ck["launches"] == steps(4) and ck["by_seq"] == want_seq
                     and all(v == 0 for v in cp["launches"].values())
                     and len(cp["record"]) == 4 and traj <= TOL_TRAIN_TRAJ,
                     f"resilience curriculum: launches {ck['launches']} by "
                     f"(Sq, Sk) {ck['by_seq']} (want {want_seq}), plain "
                     f"{cp['launches']}, trajectory rel {traj}")
        emit("resilience_curriculum", launches=ck["launches"],
             flash_launches_by_seq=ck["by_seq"],
             losses_kernel=[r["loss"] for r in ck["record"]],
             losses_plain=[r["loss"] for r in cp["record"]],
             worst_rel_traj=traj, tol=TOL_TRAIN_TRAJ,
             wall_seconds=[ck["wall"], cp["wall"]])

        # streaming, beside the mesh cases: shards of the same 1024
        # samples, 4 decode workers, 4 steps bitwise against the oracle
        shards = os.path.join(tmp, "shards")
        ds = ContrastiveDataset(n=1024, image_size=cfg.clip.image_size,
                                context_length=cfg.clip.context_length,
                                vocab_size=cfg.vocab_size, n_classes=64)
        t0 = time.monotonic()
        write_contrastive_shards(ds, shards)
        write_s = time.monotonic() - t0
        stream = RES_ARGS + ["--guard", "--data", f"streaming:{shards}",
                             "--decode-workers", "4"]
        s = _res_run(stream)
        launches["streaming"] = s["launches"]

        # the mesh cases
        mt.join()
        rcfg = cfg.reduced()
        res = {k: [r.returncode for r in mesh[k][0]]
               for k in ("ref", "kill", "resume", "nan")}
        reps = {k: mesh[k][1] for k in ("ref", "resume", "nan")}
        for k in ("ref", "resume", "nan"):
            for r in mesh[k][0]:
                if r.returncode:
                    print(r.stderr[-3000:], file=sys.stderr, flush=True)
        dig = {k: [(rp or {}).get("state_sha256") for rp in v]
               for k, v in reps.items()}
        nan_differ = _restore_vs_rank_shards(
            CK.unflatten(mesh["ref_step2"]), dig["nan"], 2, 2)
        mlaunch = {k: [(rp or {}).get("launches") for rp in v]
                   for k, v in reps.items()}
        mwant = {k: [_train_launches(rcfg, n, 0, 0, 1)] * 4
                 for k, n in (("ref", 4), ("resume", 2), ("nan", 3))}
        nan_lines = [r.stdout.count('"skipped": 1.0') for r in mesh["nan"][0]]
        checks.check(res["ref"] == res["resume"] == res["nan"] == [0] * 4
                     and res["kill"] == [-signal.SIGKILL] * 4
                     and mesh["kill_latest"] == 2
                     and all("resumed from step 2" in r.stdout
                             for r in mesh["resume"][0]),
                     f"resilience mesh: exit codes {res}, latest after the "
                     f"kill {mesh['kill_latest']}")
        checks.check(dig["resume"] == dig["ref"] and None not in dig["ref"]
                     and not nan_differ and nan_lines == [1] * 4,
                     f"resilience mesh: resume bitwise "
                     f"{dig['resume'] == dig['ref']}, nan_skip leaves "
                     f"differing {nan_differ[:8]}, skipped lines "
                     f"{nan_lines}")
        checks.check(mlaunch == mwant, f"resilience mesh: launches "
                     f"{mlaunch}, want {mwant}")
        emit("resilience_mesh", exit_codes=res,
             latest_after_kill=mesh["kill_latest"],
             resume_bitwise=dig["resume"] == dig["ref"],
             nan_skip_bitwise_vs_ref_step2=not nan_differ,
             launches_per_rank=mlaunch, wall_seconds=mesh["wall"])

        # async saves with retention and a rollback over two NaN steps
        arc = procs["async"].wait(timeout=900)
        logs[-1].seek(0)
        alines = [ln for ln in logs[-1].read().splitlines()
                  if ln.startswith('{"res_worker"')]
        a = json.loads(alines[-1])["res_worker"] if alines else {}
        arec = a.get("record", [])
        launches["async_rollback"] = a.get("launches")
        async_gap = ((arec[2]["time"] - arec[1]["time"]) * 1e3
                     if len(arec) > 2 else None)
        kept = CK.available_steps(d1)
        with open(os.path.join(d1, "latest")) as f:
            marker = f.read().strip()
        latest_ok = (marker == "4" and kept == [4]
                     and _ckpt_digests(d1, 4) == a.get("digests"))
        with open(os.path.join(d1, "heartbeat.json")) as f:
            hb = json.load(f)
        hb_ok = (hb.get("step") == 3 and hb.get("pid") == procs["async"].pid
                 and isinstance(hb.get("time"), float))
        rolled = a.get("out", "").count("rollback: 2 consecutive bad steps; "
                                        "restored verified step 2")
        checks.check(arc == 0 and a.get("digests") == oracle and rolled == 1
                     and [r["step"] for r in arec] == [0, 1, 2, 3, 2, 3]
                     and latest_ok and hb_ok
                     and a.get("launches") == steps(6),
                     f"resilience async_rollback: exit {arc}, bitwise "
                     f"{a.get('digests') == oracle}, rollback lines "
                     f"{rolled}, kept {kept}, latest restores {latest_ok}, "
                     f"heartbeat {hb}, launches {a.get('launches')}")
        emit("resilience_async_rollback", bitwise_vs_oracle=a.get(
             "digests") == oracle, rollback_lines=rolled, kept_steps=kept,
             latest_restores_bitwise=latest_ok, heartbeat=hb,
             launches=a.get("launches"), ms_gap_with_async_save=async_gap,
             ms_gap_with_sync_save_oracle=sync_gap,
             wall_seconds=a.get("wall"))

        # streaming, timed alone: the host seconds per batch of both
        # loaders, then 8 steps of each: the prefetch queue, filled during
        # the first step, hides the host for the first few steps, so the
        # steady state is the median of the gaps after the third
        sds = StreamingDataset(shards)
        host = {"in_memory": _host_batch_seconds(
                    ShardedLoader(ds, global_batch=256, seed=0), 4),
                "streaming_4_workers": _host_batch_seconds(
                    StreamingLoader(sds, global_batch=256, seed=0,
                                    workers=4, decode_ahead=4), 4)}
        sds.close()
        long_mem = _res_run(RES_ARGS + ["--guard", "--steps", "8"],
                            digests=False)
        long_str = _res_run(stream + ["--steps", "8"], digests=False)
        gaps = {k: _step_gaps_ms(r["record"], 0, 0) for k, r in
                (("in_memory", long_mem), ("streaming", long_str))}
        steady = {k: sorted(g[3:])[len(g[3:]) // 2] for k, g in gaps.items()}
        checks.check(s["digests"] == oracle and s["launches"] == steps(4)
                     and long_mem["launches"] == steps(8)
                     and long_str["launches"] == steps(8),
                     f"resilience streaming: bitwise "
                     f"{s['digests'] == oracle}, launches {s['launches']}")
        emit("resilience_streaming", bitwise_vs_oracle=s["digests"] ==
             oracle, launches=s["launches"], shard_write_seconds=write_s,
             host_seconds_per_batch=host,
             ms_step_gaps_4_steps_streaming=_step_gaps_ms(s["record"], 0, 0),
             ms_step_gaps_4_steps_in_memory_oracle=free,
             ms_step_gaps_8_steps=gaps, ms_per_step_steady_median=steady,
             wall_seconds=s["wall"])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        if mt is not None and mt.ident is not None:
            mt.join()           # its groups end, or the harness kills them
        if reads is not None:
            reads.shutdown()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("resilience", seconds=time.monotonic() - t_phase)
    checks.end_phase("resilience")
    return launches


# ---------------------------------------------------------------------------
# phases xlstm and xlstm_train: the xLSTM family served and trained
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-125m"
XLSTM_PARAMS = 193_280_584
# one mLSTM block, chunked vs sequential: max abs error, tests/test_xlstm.py
TOL_MLSTM = 2e-4
# the LM step's gradients are checked at 2 x this many tokens against the
# same step in f64 on the card: every leaf within TOL_XLSTM_F64 relative
# L2.  f32 rounding alone moves this model's gradients by 1e-4 to 1e-3
# (the division by max(|n . q|, exp(-m)) amplifies it; the JAX package's
# f32 gradients sit as far from f64 as the port's, tests/
# test_torch_xlstm.py), so the bound is that of the CPU tests
XLSTM_GRAD_SEQ = 512
TOL_XLSTM_F64 = 1e-3
XLSTM_LM_ARGS = ["--arch", XLSTM_ARCH, "--objective", "lm",
                 "--global-batch", "2", "--seq-len", str(XLSTM_GRAD_SEQ),
                 "--steps", "3", "--log-every", "1", "--device", "cuda",
                 "--seed", "0", "--precision", "f32"]
XLSTM_CTR_ARGS = ["--arch", XLSTM_ARCH, "--version", "v3",
                  "--global-batch", "64", "--seq-len", "256", "--steps",
                  "3", "--log-every", "1", "--device", "cuda", "--seed",
                  "0", "--precision", "f32"]
# an xLSTM step's kernels by what they compute (no K3 or K4 on its path)
XLSTM_CATEGORIES = (
    ("k1_k2_fcco", ("stats_partial", "stats_merge", "grads_weights",
                    "grads_product")),
    ("gemm", ("gemm", "gemv")),
)
# no hand-written kernel runs on the xLSTM's serving or LM path
XLSTM_NO_KERNELS = dict(flash_attention=0, gcl_pair_stats=0,
                        gcl_pair_grads=0, gcl_pair_stats_cuda=0,
                        gcl_pair_grads_cuda=0, ssd_chunk=0, ssd_chunk_cuda=0)
# what an xLSTM phase may leave of the card's memory, allocated or
# reserved, once its work is gone (a few of the allocator's small
# segments); a segment kept by a stray block is ~GB at these shapes
XLSTM_MEMORY_SLACK = 64 * 2 ** 20


def _xlstm_model(checks, name):
    """``xlstm-125m`` at full width and depth from seed 0 on the card,
    its parameter count JAX's."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    cfg = get_arch(XLSTM_ARCH)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    checks.check(n_params == XLSTM_PARAMS,
                 f"{name}: {n_params} parameters, want {XLSTM_PARAMS}")
    emit(f"{name}_params", arch=XLSTM_ARCH, n_layers=cfg.n_layers,
         pattern=cfg.xlstm_pattern, n_params=n_params,
         init_seconds=time.monotonic() - t0)
    return cfg, model


def _card_memory():
    """(allocated, reserved) bytes of this process's caching allocator
    once nothing unheld is kept, counted as PyTorch's own leak check
    counts them: garbage collected, the cuBLAS workspaces dropped, the
    cache emptied."""
    import gc

    import torch
    gc.collect()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _memory_returned(checks, name, before):
    """A phase's end: every byte its model, graphs and work took is back
    (``_card_memory`` against ``before``, its value at the phase's
    start, within ``XLSTM_MEMORY_SLACK``), so no segment is left that a
    later phase could not use."""
    after = _card_memory()
    checks.check(after[0] <= before[0] + XLSTM_MEMORY_SLACK
                 and after[1] <= before[1] + XLSTM_MEMORY_SLACK,
                 f"{name}: memory allocated / reserved {after} after the "
                 f"phase, {before} before it")
    emit(f"{name}_memory", allocated_before=before[0],
         allocated_after=after[0], reserved_before=before[1],
         reserved_after=after[1], slack=XLSTM_MEMORY_SLACK)


def _slstm_paths(checks, cfg, model, T):
    """One full-width sLSTM block at 2 x ``T``, its token loops run
    eagerly and as replayed CUDA graphs (``models.xlstm``: windows of
    ``WINDOW`` tokens, the block's ``window_graphs``): the output, and
    the gradients of a forward and backward, equal to the bit; under the
    profiler (device events only) the graphs' forward without grad and
    forward with backward, as a step runs them: wall ms, device-busy ms,
    kernels in all and per token; the graphs captured and replayed."""
    import torch
    from repro_torch.models import backbones as BB
    from repro_torch.models import xlstm as X
    blk = next(b for b in BB._xlstm_blocks(model)
               if isinstance(b, X.SLSTMBlock))
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, T, cfg.d_model), generator=gen, device="cuda")
    w = torch.randn((2, T, cfg.d_model), generator=gen, device="cuda")

    def fwd(graphs):
        with torch.no_grad():
            return X.apply_slstm_block(blk, cfg, x, graphs=graphs)

    def both(graphs):
        blk.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_(True)
        y = X.apply_slstm_block(blk, cfg, xx, graphs=graphs)
        (y * w).sum().backward()
        return [y.detach(), xx.grad] + [p.grad for p in blk.parameters()]
    out, res = {}, {}
    wg = blk.window_graphs
    n0 = wg.captured, wg.replayed
    try:
        for graphs in (False, True):
            res[graphs] = [fwd(graphs)] + both(graphs)   # warm-up: captures
        for what, fn in (("forward", fwd), ("forward_backward", both)):
            prof = _profile(lambda: fn(True), host_ops=False)
            out[what] = dict(kernels=prof["launches"],
                             kernels_per_token=prof["launches"] / T,
                             wall_ms=prof["wall_ms"],
                             device_busy_ms=prof["device_busy_ms"])
    finally:
        blk.zero_grad(set_to_none=True)
    same = all(torch.equal(a, b) for a, b in zip(res[False], res[True]))
    out.update(captured=wg.captured - n0[0], replayed=wg.replayed - n0[1])
    checks.check(same and out["replayed"] > 0,
                 f"xlstm_train: the sLSTM's graphs vs its eager windows at "
                 f"2 x {T}: the same bits {same}, graphs replayed "
                 f"{out['replayed']}")
    out["graphs_equal_eager_bitwise"] = same
    return out


def _xlstm_serve_checks(checks, cfg, model):
    """Phase xlstm's checks that time nothing: one mLSTM block chunked
    against sequential at 2 x 4096 (``TOL_MLSTM``), and the prefill
    against 256 decode steps at batch 2 (``TOL_PREFILL_DECODE``), no
    kernel of the port's launched."""
    import torch
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import backbones as BB
    from repro_torch.models import xlstm as X
    B, S, T = 2, 4096, 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    blk = next(iter(BB._xlstm_blocks(model)))
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    with torch.inference_mode():
        y_c = X.apply_mlstm_block(blk, cfg, x, chunked=True)
        y_s = X.apply_mlstm_block(blk, cfg, x, chunked=False)
        d = (y_c - y_s).abs().max().item()
    checks.check(math.isfinite(d) and d <= TOL_MLSTM,
                 f"xlstm: mLSTM block chunked vs sequential max abs {d}")
    emit("xlstm_mlstm_block", shape=[B, S, cfg.d_model],
         chunk=cfg.ssm.chunk, max_abs_err=d, tol=TOL_MLSTM)
    del x, y_c, y_s
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device="cuda")
    last = steps.make_prefill_step(cfg)(model, {"tokens": tokens})[:, 0]
    state = BB.prepare_decode_state(model, cfg, {}, B, T)
    serve_step = steps.make_serve_step(cfg, INPUT_SHAPES["decode_32k"])
    _zero_hybrid_counters()
    for t in range(T):
        lg, state = serve_step(model, state, tokens[:, t:t + 1], t)
    dec_counts = _hybrid_counters()
    d = (lg - last).abs().max().item()
    checks.check(math.isfinite(d) and d <= TOL_PREFILL_DECODE
                 and dec_counts == XLSTM_NO_KERNELS,
                 f"xlstm: prefill vs decode max abs {d}, decode launches "
                 f"{dec_counts}")
    emit("xlstm_prefill_vs_decode", batch=B, tokens=T, max_abs_err=d,
         tol=TOL_PREFILL_DECODE, launches=dec_counts)


def _xlstm_train_checks(checks, cfg, model, held):
    """Phase xlstm_train's checks that time nothing: each launcher in a
    child process (3 LM steps at 2 x ``XLSTM_GRAD_SEQ``, 3 contrastive
    steps at 64 x 256; ``held``: {"lm", "contrastive"}, held
    ``_LauncherProcess``es) beside the f64 gradient check, the sLSTM's
    eager windows against its graphs (bitwise; the kernels per token
    exact, its times beside the rest) and the contrastive steps here.
    Returns K1's and K2's launches."""
    import torch
    lm = held["lm"].start(XLSTM_LM_ARGS)
    ctr = held["contrastive"].start(XLSTM_CTR_ARGS)
    out = {}
    try:
        _xlstm_f64(checks, cfg, model, _hybrid_batches(cfg, "lm")[0][1])
        slstm = _slstm_paths(checks, cfg, model, XLSTM_GRAD_SEQ)
        n_s = cfg.xlstm_pattern[:cfg.n_layers].count("s")
        # each sLSTM block of a training step runs its forward and its
        # backward once (it is not recomputed): the forward_backward
        # reading
        per_tok = slstm["forward_backward"]["kernels_per_token"]
        emit("xlstm_slstm_launches", shape=[2, XLSTM_GRAD_SEQ],
             block=slstm, slstm_blocks=n_s, beside_the_launchers=True,
             kernels_per_token_per_block_in_a_step=per_tok,
             kernels_per_lm_step_at_4096=n_s * per_tok * 4096)
        out["contrastive"] = _xlstm_contrastive(checks, cfg, model)
        torch.cuda.empty_cache()
    finally:
        finished = lm.finish(900), ctr.finish(900)
    out["lm_launcher"] = _xlstm_launcher_checks(
        checks, "xlstm_train_lm", finished[0], lm.lines, False)
    out["contrastive_launcher"] = _xlstm_launcher_checks(
        checks, "xlstm_train_contrastive", finished[1], ctr.lines, True)
    return out


def phase_xlstm(checks):
    """``xlstm-125m`` served at full width and depth (f32, seed 0): its
    checks that time nothing (``_xlstm_serve_checks``), then the prefill
    at 2 x 4096 (no kernel on its path) timed and profiled, and the
    decode launcher at batch 4; every byte of the card's memory it took
    returned (``_memory_returned``)."""
    import contextlib
    import io

    import torch
    from repro_torch.launch import serve, steps
    t_phase = time.monotonic()
    before = _card_memory()
    cfg, model = _xlstm_model(checks, "xlstm")
    _xlstm_serve_checks(checks, cfg, model)
    B, S = 2, 4096
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    prefill = steps.make_prefill_step(cfg)
    prefill(model, {"tokens": tokens[:, :256]})          # warm-up
    torch.cuda.reset_peak_memory_stats()
    logits, ms_prefill, counts = _timed(
        lambda: prefill(model, {"tokens": tokens}))
    peak = torch.cuda.max_memory_allocated()
    checks.check(tuple(logits.shape) == (B, 1, cfg.padded_vocab)
                 and bool(torch.isfinite(logits).all())
                 and counts == XLSTM_NO_KERNELS,
                 f"xlstm prefill: logits {tuple(logits.shape)}, launches "
                 f"{counts}")
    prof = _profile(lambda: prefill(model, {"tokens": tokens}),
                    categories=XLSTM_CATEGORIES, host_ops=False)
    prof["idle_share_of_unprofiled_prefill"] = max(
        0.0, 1.0 - prof["device_busy_ms"] / ms_prefill)
    emit("xlstm_prefill", batch=B, seq=S, ms_per_prefill=ms_prefill,
         tokens_per_s=B * S / (ms_prefill / 1e3), launches=counts,
         max_memory_allocated=peak, profile=prof)
    del model, logits, tokens
    # the decode launcher on the card
    argv = ["--arch", XLSTM_ARCH, "--batch", "4", "--gen", "64"]
    _zero_hybrid_counters()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        toks = serve.main(argv)
    wall = time.monotonic() - t0
    serve_counts = _hybrid_counters()
    lines = buf.getvalue().splitlines()
    tps = float(lines[0].split(" at ")[1].split(" tok/s")[0])
    checks.check(tuple(toks.shape) == (4, 80) and toks.device.type == "cuda"
                 and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
                 and serve_counts == XLSTM_NO_KERNELS,
                 f"xlstm serve: tokens {tuple(toks.shape)} on {toks.device}, "
                 f"launches {serve_counts}")
    emit("xlstm_serve", argv=argv, lines=lines, decode_tokens_per_s=tps,
         wall_seconds=wall)
    del toks
    _memory_returned(checks, "xlstm", before)
    emit("xlstm", seconds=time.monotonic() - t_phase)
    checks.end_phase("xlstm")


def _xlstm_lm(checks, cfg, model):
    """The LM objective at 2 x 4096 from the seeded init: step 0 under
    the profiler (device events only: launches, the sLSTM's among them,
    and device ms by kind), step 1 timed alone with its peak memory; no
    kernel of the port's launched; the loss near ln(vocab) at the random
    init."""
    import torch
    from repro_torch.launch import steps as ST
    step = ST.make_lm_train_step(cfg, lr=HYBRID_LR, wd=0.1, total_steps=3,
                                 device="cuda")[0]
    batches = _hybrid_batches(cfg, "lm")
    state = _fresh_state(model, None)
    rec, ms, counts = [], [], []
    prof, peak = None, None
    for i, (_, b) in enumerate(batches[:2]):
        if i == 0:
            held = {}
            _zero_hybrid_counters()
            prof = _profile(lambda: held.update(out=step(state, b)),
                            categories=XLSTM_CATEGORIES, host_ops=False)
            (state, m), t, n = held.pop("out"), prof["wall_ms"], (
                _hybrid_counters())
        else:
            torch.cuda.reset_peak_memory_stats()
            (state, m), t, n = _timed(lambda: step(state, b))
            peak = torch.cuda.max_memory_allocated()
        rec.append({k: float(v) for k, v in m.items()})
        ms.append(t)
        counts.append(n)
    del state
    torch.cuda.empty_cache()
    ln_v = math.log(cfg.vocab_size)
    checks.check(counts == [XLSTM_NO_KERNELS] * 2
                 and all(math.isfinite(r["loss"])
                         and abs(r["loss"] - ln_v) < 1.5 for r in rec),
                 f"xlstm_train_lm: losses {rec} (ln V {ln_v}), launches "
                 f"{counts}")
    prof["idle_share_of_unprofiled_step"] = max(
        0.0, 1.0 - prof["device_busy_ms"] / ms[1])
    emit("xlstm_train_lm_device", arch=cfg.name, shape=[2, 4096],
         batch_on_device=True, ms_per_step=ms, ms_step0_profiled=ms[0],
         ms_step1_unprofiled=ms[1], max_memory_allocated=peak,
         launches=counts, losses=[r["loss"] for r in rec], ln_vocab=ln_v,
         profile=prof)


def _xlstm_f64(checks, cfg, model, batch):
    """The step-0 gradients at 2 x ``XLSTM_GRAD_SEQ`` against the same
    step in f64 on the card (an f64 copy of the model under an f64
    compute policy), every leaf within ``TOL_XLSTM_F64`` relative L2;
    beside it the f32 gradients at mLSTM chunk 32, the same arithmetic
    in another order: how far f32 rounding alone moves them."""
    import copy
    import dataclasses

    import torch
    from repro_torch.core import train_step as TS
    from repro_torch.models import backbones as BB
    from repro_torch.models import precision as PR
    b = {k: v[:, :XLSTM_GRAD_SEQ] for k, v in batch.items()}
    f64 = PR.Precision("f64", compute_dtype=torch.float64,
                       output_dtype=torch.float64)
    c32 = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=32))
    _fresh_state(model, None)
    t0 = time.monotonic()
    grads = {}
    for name, m, c, prec in (("f32", model, cfg, PR.F32),
                             ("f32_chunk32", model, c32, PR.F32),
                             ("f64", copy.deepcopy(model).double(), cfg,
                              f64)):
        with torch.enable_grad():
            loss, _ = BB.lm_loss(m, c, b, precision=prec)
            grads[name] = {k: g.double() for k, g in
                           TS.param_grads(loss, m).items()}
        del m
    rel = _grads_rel(grads["f32"], grads["f64"])
    rounding = _grads_rel(grads["f32"], grads["f32_chunk32"])
    rel32 = _grads_rel(grads["f32_chunk32"], grads["f64"])
    unreached = [k for k in rel if k.split(".")[0] in ("ctr_proj",
                                                       "pair_proj")]
    zero = all(not grads["f32"][k].any() for k in unreached)
    del grads
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)
    checks.check(all(math.isfinite(v) and v <= TOL_XLSTM_F64
                     for v in rel.values()) and zero,
                 f"xlstm_train_lm: step-0 grads f32 vs f64, worst leaf "
                 f"{worst} rel L2 {rel[worst]}, bound {TOL_XLSTM_F64}; "
                 f"unreached zero {zero}")
    emit("xlstm_train_lm_f64", shape=[2, XLSTM_GRAD_SEQ],
         grad_leaves=len(rel), grads_f32_vs_f64=_leaf_summary(rel),
         grads_f32_chunk32_vs_f64=_leaf_summary(rel32),
         grads_f32_vs_f32_chunk32=_leaf_summary(rounding),
         bound=TOL_XLSTM_F64, unreached_zero=zero,
         seconds=time.monotonic() - t0)


def _xlstm_contrastive(checks, cfg, model):
    """The contrastive objective (v3, 64 x 256) from the seeded init: 2
    steps on the K1/K2 path (one call of each per step, timed) and 2 on
    the dense loss, step 0's gradients of every leaf within
    ``TOL_TRAIN_GRAD`` relative L2 of each other, the loss, tau, loss
    value and u mean within ``TOL_TRAIN_TRAJ``.  Returns K1's and K2's
    launches on the kernel path."""
    import torch
    from repro_torch.core import train_step as TS
    tcs = {loss_impl: _hybrid_ctr_config(cfg, "flash", loss_impl)
           for loss_impl in ("fused", "dense")}
    fc_cfg = tcs["fused"].fc
    batches = _hybrid_batches(cfg, "contrastive")[:2]
    want = dict(XLSTM_NO_KERNELS, gcl_pair_stats=1, gcl_pair_grads=1,
                gcl_pair_stats_cuda=2, gcl_pair_grads_cuda=2)
    rec, ms, counts, grads0 = {}, {}, {}, {}
    for loss_impl, tc in tcs.items():
        step = TS.make_train_step(tc, "cuda")
        state = _fresh_state(model, None, fc_cfg)
        rec[loss_impl], ms[loss_impl], counts[loss_impl] = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for i, (idx, b) in enumerate(batches):
            with _CaptureGrads(
                    (lambda g, li=loss_impl: grads0.update(
                        {li: {k: v.detach().clone() for k, v in g.items()}}))
                    if i == 0 else (lambda g: None), contrastive=True):
                (state, m), t, n = _timed(lambda: step(state, b, idx))
            rec[loss_impl].append({k: float(v) for k, v in m.items()})
            ms[loss_impl].append(t)
            counts[loss_impl].append(n)
        peak = torch.cuda.max_memory_allocated()
        del state
    torch.cuda.empty_cache()
    rel = _grads_rel(grads0["fused"], grads0["dense"])
    del grads0
    worst = max(rel, key=rel.get)
    traj = _traj_rel(rec["fused"], rec["dense"])
    checks.check(counts["fused"] == [want] * 2
                 and counts["dense"] == [XLSTM_NO_KERNELS] * 2,
                 f"xlstm_train_contrastive: launches {counts}, want {want}")
    checks.check(all(math.isfinite(v) and v <= TOL_TRAIN_GRAD
                     for v in rel.values())
                 and math.isfinite(traj) and traj <= TOL_TRAIN_TRAJ,
                 f"xlstm_train_contrastive: step-0 grads K1/K2 vs dense, "
                 f"worst leaf {worst} rel L2 {rel[worst]}, bound "
                 f"{TOL_TRAIN_GRAD}; trajectory rel {traj}")
    emit("xlstm_train_contrastive_device", arch=cfg.name, shape=[64, 256],
         batch_on_device=True, beside_the_launcher_child=True, ms_per_step=ms, max_memory_allocated=peak,
         launches_per_step=counts, metrics=rec, trajectory_rel=traj,
         traj_bound=TOL_TRAIN_TRAJ, grad_leaves=len(rel),
         grads_fused_vs_dense=_leaf_summary(rel), grad_bound=TOL_TRAIN_GRAD)
    return {k: 2 * v for k, v in want.items()}


def _xlstm_launcher_checks(checks, name, finished, lines, contrastive):
    """A launcher child's 3 steps: exit 0, finite step lines, launches
    (one K1 and one K2 call a step for the contrastive loss, nothing
    else), f32 masters."""
    rc, rep, _, err = finished
    lines = [ln for ln in lines if ln]
    if rc or rep is None:
        print(err, file=sys.stderr, flush=True)
    if not checks.check(rc == 0 and rep is not None,
                        f"{name}: launcher process exit code {rc}"):
        checks.end_phase("xlstm_train")
    k12 = 3 if contrastive else 0
    want = dict(XLSTM_NO_KERNELS, gcl_pair_stats=k12, gcl_pair_grads=k12,
                gcl_pair_stats_cuda=2 * k12, gcl_pair_grads_cuda=2 * k12)
    got = dict(rep["launches"], **rep["k4"])
    rec = rep["record"]
    step_lines = [ln for ln in lines if ln.startswith("step ")]
    acc = [ln for ln in lines if ln.startswith("retrieval accuracy: ")]
    checks.check(got == want and len(rec) == 3 and len(step_lines) == 3
                 and all(math.isfinite(r["loss"]) for r in rec)
                 and rep["dtype_error"] is None
                 and bool(acc) == contrastive,
                 f"{name}: launches {got} (want {want}), lines "
                 f"{step_lines + acc}, dtypes {rep['dtype_error']}")
    emit(f"{name}_launcher", steps=3, lines=step_lines + acc,
         launches=got, losses=[r["loss"] for r in rec],
         ms_per_step_after_warmup=(rec[-1]["time"] - rec[0]["time"]) / 2
         * 1e3, max_memory_allocated=rep["max_memory_allocated"],
         wall_seconds=rep["wall_seconds"])
    return got


def phase_xlstm_train(checks, held=None):
    """``xlstm-125m`` trained at full width and depth (f32, seed 0): the LM
    step timed here (``_xlstm_lm``), then its checks that time nothing
    (``_xlstm_train_checks``: both launchers, the f64 gradients, the
    sLSTM's two paths, the contrastive steps); every byte of the card's
    memory it took returned (``_memory_returned``).  ``held``: the
    launchers' held ``_LauncherProcess``es ({"lm", "contrastive"}),
    started ahead of the phase; else they start here, held while the LM
    step is timed.  Returns K1's and K2's launches."""
    t_phase = time.monotonic()
    held = held or {"lm": _LauncherProcess(),
                    "contrastive": _LauncherProcess()}
    before = _card_memory()
    cfg, model = _xlstm_model(checks, "xlstm_train")
    _xlstm_lm(checks, cfg, model)
    out = _xlstm_train_checks(checks, cfg, model, held)
    del model
    _memory_returned(checks, "xlstm_train", before)
    emit("xlstm_train", seconds=time.monotonic() - t_phase)
    checks.end_phase("xlstm_train")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                 "GPU (no arguments: every phase)")
    ap.add_argument("--only", default=None,
                    help="a partial run: device, build, then these phases "
                         "(comma-separated: attn_grad, kernel, gcl, "
                         "dense, moe, vlm, "
                         "audio, train, "
                         "clip_family, mesh after train, hybrid_train, "
                         "dense_train, moe_train, vlm_train, audio_train, "
                         "xlstm, xlstm_train, "
                         "remat_forms, moe_depth, vlm_remat_forms, "
                         "resilience); no report and no last line")
    args = ap.parse_args(argv)
    checks = Checks()
    t_start = time.monotonic()
    import atexit
    atexit.register(_stop_held)

    def mark(phase):
        emit("timeline", after=phase,
             seconds_since_start=time.monotonic() - t_start)
    phase_device()
    if args.only:
        phase_build(checks)
        out = {}
        for name in args.only.split(","):
            if name == "mesh":       # held to phase train's run
                out["mesh"] = phase_mesh(checks, *out["train"][1:])
            else:
                out[name] = {
                    "attn_grad": phase_attn_grad,
                    "kernel": phase_kernel, "gcl": phase_gcl,
                    "train": phase_train, "clip_family": phase_clip_family,
                    "dense": phase_dense, "moe": phase_moe,
                    "vlm": phase_vlm, "audio": phase_audio,
                    "hybrid_train": phase_hybrid_train,
                    "dense_train": phase_dense_train,
                    "moe_train": phase_moe_train,
                    "vlm_train": phase_vlm_train,
                    "audio_train": phase_audio_train,
                    "xlstm": phase_xlstm,
                    "xlstm_train": phase_xlstm_train,
                    "remat_forms": phase_remat_forms,
                    "moe_depth": phase_moe_depth,
                    "vlm_remat_forms": phase_vlm_remat_forms,
                    "resilience": phase_resilience}[name](checks)
            mark(name)
        print(f"chip_smoke: partial run of {args.only} passed; no report",
              flush=True)
        return
    phase_build(checks)
    phase_attn_grad(checks)
    phase_ssd_grad(checks)
    mark("build, attn_grad, ssd_grad")
    timings = phase_kernel(checks)
    mark("kernel")
    gcl_timings = phase_gcl(checks)
    mark("gcl")
    ssd_timings = phase_ssd(checks)
    mark("ssd")
    hybrid_launches, ssd_cuda_launches = phase_hybrid(checks)
    mark("hybrid")
    dense = phase_dense(checks)
    mark("dense")
    moe = phase_moe(checks)
    mark("moe")
    vlm = phase_vlm(checks)
    mark("vlm")
    audio = phase_audio(checks)
    mark("audio")
    import torch
    # phase clip_family's ResNet-50 launcher, held: its imports run here
    rn50_child = _LauncherProcess()
    train_launches, train_rec, train_tree = phase_train(checks)
    torch.cuda.empty_cache()
    mark("train")
    import concurrent.futures
    # phases slice and eval's checkpoint (host compression, ~35 s) is
    # written on a thread beside the ResNet-50 launcher's write, where
    # nothing is timed
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        made = []
        family = phase_clip_family(checks, beside=lambda: made.append(
            pool.submit(make_clip_checkpoint)), child=rn50_child)
        ckpt, model = made[0].result()
    torch.cuda.empty_cache()
    mark("clip_family")
    try:
        launches = phase_slice(checks, ckpt, model)
        mark("slice")
        eval_launches, k1_eval = phase_eval(checks, ckpt, model)
        mark("eval")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    mesh_out = phase_mesh(checks, train_rec, train_tree)
    del train_tree
    torch.cuda.empty_cache()
    mark("mesh")
    # phase hybrid_train's LM launcher, held: its imports run here
    hybrid_child = _LauncherProcess()
    res_launches = phase_resilience(checks)
    mark("resilience")
    # phase dense_train's LM launcher, held: its imports run during phase
    # hybrid_train
    dense_child = _LauncherProcess()
    hybrid_train = phase_hybrid_train(checks, child=hybrid_child)
    mark("hybrid_train")
    dense_train = phase_dense_train(checks, child=dense_child)
    mark("dense_train")
    # phase xlstm_train's launchers, held: their imports run here
    xlstm_held = {"lm": _LauncherProcess(), "contrastive": _LauncherProcess()}
    moe_train = phase_moe_train(checks)
    mark("moe_train")
    vlm_train = phase_vlm_train(checks)
    mark("vlm_train")
    audio_train = phase_audio_train(checks)
    mark("audio_train")
    phase_xlstm(checks)
    mark("xlstm")
    # last: a failure here cannot hide an earlier phase's result
    xlstm_train = phase_xlstm_train(checks, held=xlstm_held)
    mark("xlstm_train")
    cross_train = {"vlm_train": vlm_train, "audio_train": audio_train}
    kernels = []
    for (case, dt_name), t in timings.items():
        # launches: the serving run of the tower, the training run (both
        # towers, 3 steps), one full-width zamba2 prefill or one eval pass
        # (both towers over 3072 pairs and the prompt head)
        if case == "hybrid":
            path, n_launch = "prefill", hybrid_launches["flash_attention"]
        elif case in ("qwen3", "qwen1p5"):
            # one full-width dense prefill (phase dense): every layer
            path, n_launch = "dense_prefill", dense[case]["4096x4096"]
        elif case == "qwen3_moe":
            # one qwen3-moe prefill at 8 layers (phase moe): every layer
            path, n_launch = "moe_prefill", moe[MOE_ARCH]["4096x4096"]
        elif case == "vlm_cross":
            # one llama-3.2-vision-11b prefill at 10 layers (phase vlm):
            # its 2 cross blocks (its 10 self-attentions: the qwen3_moe
            # case's shape, in vlm_prefill_launches)
            path, n_launch = "vlm_prefill", vlm["4096x1024"]
        elif case == "vlm_ctr_cross":
            # llama-3.2-vision-11b's 2 contrastive steps at 5 layers
            # (phase vlm_train): its cross block, forward and recompute
            path = "vlm_train"
            n_launch = vlm_train["contrastive"]["by_seq"]["256x1024"]
        elif case == "audio_ctr_enc":
            # seamless-m4t-large-v2's 2 contrastive steps (phase
            # audio_train): its 12 encoder layers, forward and recompute
            path = "audio_train"
            n_launch = audio_train["contrastive"]["by_seq"]["64x64"]
        elif case.startswith("audio_"):
            # one seamless-m4t-large-v2 prefill (phase audio)
            path = "audio_prefill"
            n_launch = audio[{"audio_cross": "4096x1024",
                              "audio_enc": "1024x1024",
                              "audio_self": "4096x4096"}[case]]
        elif case == "qwen3_moe_ctr":
            # qwen3-moe's 2 contrastive steps of phase moe_train
            path = "moe_train"
            n_launch = moe_train["contrastive"]["flash_attention"]
        elif case == "qwen3_moe_mesh":
            # one rank's step of qwen3-moe (1 layer) on data:1,fsdp:2
            path = "moe_train_mesh, per rank per step"
            n_launch = moe_train["mesh_per_rank_per_step"]["flash_attention"]
        elif case.startswith("hd128_"):
            path, n_launch = "none (edge case)", 0
        elif case == "qwen3_ctr":
            # qwen3-1.7b's 2 contrastive steps of phase dense_train
            path = "dense_train"
            n_launch = dense_train["contrastive"]["flash_attention"]
        elif case == "qwen3_mesh":
            # one rank's step of qwen3-1.7b (4 layers) on data:1,fsdp:2
            path = "dense_train_mesh, per rank per step"
            n_launch = dense_train["mesh_per_rank_per_step"][
                "flash_attention"]
        elif case == "hybrid_ctr":
            # the zamba2 contrastive launcher's 3 steps
            path = "hybrid_train"
            n_launch = hybrid_train["contrastive"]["flash_attention"]
        elif case == "vitb16_train":
            # clip-vitb16-laion's 3 steps: its image tower's launches
            path = "clip_family"
            n_launch = family["vitb16_train"]["by_seq"]["197x197"]
        elif case.endswith("_train"):
            path, n_launch = "train", train_launches["flash_attention"]
        elif case == "text_head":
            path, n_launch = "eval", eval_launches["flash_attention"]
        else:
            path, n_launch = "serve", launches[case]
        kernels.append({
            "name": f"flash_attention/{case}/{dt_name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "shape": t["shape"], "causal": t["causal"], "dtype": dt_name,
            "launches": n_launch, "launches_path": path,
            "max_abs_err": max(t["max_abs_err"], t["max_abs_err_mha"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # phase moe: K3's launches by (Sq, Sk) in one prefill of each
            # MoE LM (qwen3-moe 8 layers at 2 x 32 heads, llama4-scout 4
            # at 1 x 40: the qwen1p5 case's shape); decode launches none
            "moe_prefill_launches": moe,
            # phases vlm and audio: K3's launches by (Sq, Sk) in one 2 x
            # 4096 prefill of each cross-attention family; decode and
            # prepare_decode_state launch none
            "vlm_prefill_launches": vlm,
            "audio_prefill_launches": audio,
            # phases vlm_train and audio_train: K3's launches by (Sq, Sk)
            # in the 3 LM steps (2 x 4096) and the 2 contrastive steps (64
            # x 256) of each family's kernel path (every attention in its
            # forward and in its block's recompute)
            "cross_train_launches": {
                phase: {"lm": out["lm"],
                        "contrastive": out["contrastive"]["by_seq"]}
                for phase, out in cross_train.items()},
            # one rank's launches in the data:2,fsdp:2 launcher run (3
            # steps at 64 rows per rank, 2 evals)
            "mesh_launches_per_rank": mesh_out["launches_per_rank"][
                "flash_attention"],
            # each full-width run of phase resilience
            "resilience_launches": {c: n["flash_attention"]
                                    for c, n in res_launches.items()},
            # phase hybrid_train: each launcher's 3 zamba2 training steps
            # (8 layers: the shared block's 1 call, recomputed once)
            "hybrid_train_launches": {
                kind: n["flash_attention"] for kind, n in
                hybrid_train.items()},
            # phase dense_train: qwen3-1.7b's LM launcher (3 steps), its 2
            # contrastive steps here, one rank's step on data:1,fsdp:2
            "dense_train_launches": _dense_train_launches(
                dense_train, "flash_attention"),
            # phase moe_train: qwen3-moe's LM launcher (3 steps at 2 x 32
            # x 4096, the qwen3_moe case's shape), its 2 contrastive steps
            # here, one rank's step on data:1,fsdp:2
            "moe_train_launches": _dense_train_launches(
                moe_train, "flash_attention"),
            # phase clip_family: ResNet-50 3 steps (text tower only), its
            # serving runs and eval pass; ViT-B/16 3 steps
            "clip_family_launches": {
                "rn50_train": family["rn50_train"]["launches"][
                    "flash_attention"],
                "rn50_serve_image": family["serve_resnet"],
                "rn50_serve_text": family["serve_text"],
                "rn50_eval": family["eval"]["flash_attention"],
                "vitb16_train": family["vitb16_train"]["by_seq"]}})
    for name, kernel, line in (("gcl_pair_stats", "stats", 169),
                               ("gcl_pair_grads", "grads", 362)):
        t = gcl_timings["main", kernel]
        extra = {f"{case}_{k}": gcl_timings[case, kernel][k]
                 for case in ("main_bf16", "rect_paper", "rect_paper_bf16")
                 for k in ("ms", "kernel_only_ms", "plain_ms", "bound_ms",
                           "tc_floor_ms", "max_abs_err")}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gcl_loss.cu",
            "replaces": f"src/repro/kernels/gcl_loss.py:{line}",
            "shape": t["shape"], "dtype": t["dtype"],
            "launches": train_launches[name],
            "cuda_launches": train_launches[f"{name}_cuda"],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "kernel_only_ms": t["kernel_only_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "tc_floor_ms": t["tc_floor_ms"],
            "rect_paper_shape": gcl_timings["rect_paper", kernel]["shape"],
            "rect_paper_row_offset": gcl_timings["rect_paper", kernel][
                "row_offset"],
            **extra,
            **({f"eval_{k}": v for k, v in k1_eval.items()}
               if name == "gcl_pair_stats" else {}),
            "mesh_launches_per_rank": mesh_out["launches_per_rank"][name],
            "mesh_cuda_launches_per_rank": mesh_out["launches_per_rank"][
                f"{name}_cuda"],
            "resilience_launches": {c: n[name]
                                    for c, n in res_launches.items()},
            # the zamba2 contrastive launcher's 3 steps
            "hybrid_train_launches": hybrid_train["contrastive"][name],
            "dense_train_launches": _dense_train_launches(dense_train,
                                                          name),
            "moe_train_launches": _dense_train_launches(moe_train, name),
            # the 2 contrastive steps of phases vlm_train and audio_train
            "cross_train_launches": {
                phase: out["contrastive"][name]
                for phase, out in cross_train.items()},
            # phase xlstm_train: xlstm-125m's 2 contrastive steps here and
            # its contrastive launcher's 3 (64 x 64 x 512, the hybrid_ctr
            # case's shape); its LM steps launch none
            "xlstm_train_launches": {
                kind: xlstm_train[kind][name]
                for kind in ("contrastive", "contrastive_launcher",
                             "lm_launcher")},
            "hybrid_train_cuda_launches": hybrid_train["contrastive"][
                f"{name}_cuda"],
            "clip_family_launches": {
                "rn50_train": family["rn50_train"]["launches"][name],
                "vitb16_train": family["vitb16_train"]["launches"][name],
                **({"rn50_eval": family["eval"][name]}
                   if name == "gcl_pair_stats" else {})},
            # clip-rn50-cc3m's shape, 256 x 256 x 1024, and its ranks'
            # on data:1,fsdp:2, 128 x 256 x 1024 at row offsets 0 and 128;
            # the LM backbones' contrastive step, 64 x 64 x 512, and
            # qwen3-1.7b's ranks on data:1,fsdp:2, 32 x 64 x 512 at row
            # offsets 0 and 32 (launches: dense_train_launches)
            **{f"{case}_{k}": gcl_timings[case, kernel][k]
               for case in ("rn50", "rn50_rank0", "rn50_rank1",
                            "hybrid_ctr", "qwen3_mesh_rank0",
                            "qwen3_mesh_rank1")
               for k in ("shape", "row_offset", "ms", "kernel_only_ms",
                         "plain_ms", "bound_ms", "bound_by", "tc_floor_ms",
                         "max_abs_err")},
            # K1 on the ResNet-50's eval pass, 3072 x 3072 x 1024
            **({f"rn50_eval_{k}": v for k, v in family["eval_k1"].items()}
               if name == "gcl_pair_stats" else {}),
            **{f"{case[0]}_{k}": mesh_out["gcl"][case[0], kernel][k]
               for case in MESH_GCL_CASES
               for k in ("shape", "row_offset", "ms", "kernel_only_ms",
                         "plain_ms", "bound_ms", "tc_floor_ms",
                         "max_abs_err")},
            # no single PyTorch call computes the FCCO row statistics or
            # their closed-form gradients
            "library_ms": None})
    t = ssd_timings["prefill"]
    t_bf16 = ssd_timings["prefill_bf16"]
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk.py:58",
        "shape": t["shape"], "N": t["N"], "chunk": t["chunk"],
        "dtype": "float32", "bc_dtype": t["bc_dtype"],
        "launches": hybrid_launches["ssd_chunk"],
        "cuda_launches": ssd_cuda_launches,
        "cuda_launches_per_call": (ssd_cuda_launches
                                   / max(hybrid_launches["ssd_chunk"], 1)),
        # phase hybrid_train: each launcher's 3 training steps (16 calls
        # per step at 8 layers: each layer's forward and its recompute)
        "hybrid_train_launches": {kind: n["ssd_chunk"]
                                  for kind, n in hybrid_train.items()},
        "hybrid_train_cuda_launches": {kind: n["ssd_chunk_cuda"]
                                       for kind, n in hybrid_train.items()},
        "max_abs_err": max(t["max_abs_err"], t_bf16["max_abs_err"]),
        "ms": t["ms"], "ms_bf16_bc": t_bf16["ms"],
        "pass_ms": t["pass_ms"], "pass_ms_bf16_bc": t_bf16["pass_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "tc_floor_ms": t["tc_floor_ms"],
        # zamba2's contrastive step, 64 x 256
        **{f"hybrid_ctr_{k}": ssd_timings["hybrid_ctr"][k]
           for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "tc_floor_ms")},
        # no single PyTorch call computes the SSD scan
        "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--hold"]:
        # a child started ahead of its turn (by this script, never by
        # hand): its own arguments come once it is released
        sys.path.insert(0, SRC)
        args = _hold(args[1]) + args[2:]
    if args[:1] == ["--mesh-worker"]:
        # one rank of phase mesh (spawned by it, never by hand)
        sys.path.insert(0, SRC)
        {"train": _mesh_worker_train, "step": _mesh_worker_step,
         "family": _mesh_worker_family,
         "dense": lambda argv: _mesh_worker_lm(argv, DENSE_ARCH,
                                               DENSE_MESH_LAYERS,
                                               together=True),
         "moe": lambda argv: _mesh_worker_lm(argv, MOE_ARCH,
                                             MOE_MESH_LAYERS)
         }[args[1]](args[2:])
    elif args[:1] == ["--launcher-worker"]:
        # one launcher run of phase clip_family (spawned by it); it sets
        # no backend flag: the port's device policy alone decides them
        sys.path.insert(0, SRC)
        _launcher_worker(args[1:])
    elif args[:1] == ["--res-worker"]:
        # one full-width run of phase resilience (spawned by it)
        sys.path.insert(0, SRC)
        _res_worker(args[1:])
    else:
        main()
