#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing JSON lines (``{"phase": ...}``):

1. device  -- requires CUDA, prints the card's name and power limit
   (``nvidia-smi``), turns TF32 off for matmuls and convolutions;
2. build   -- builds the port's kernel from ``src/repro_torch/kernels/
   csrc/flash_attention.cu`` with nvcc for sm_90a;
3. kernel  -- holds the flash-attention kernel against its plain PyTorch
   version on the card at the serving shapes (f32 and bf16) and at edge
   cases, and times kernel, plain version and one library call
   (``scaled_dot_product_attention``, timed here only, never used by the
   port) with CUDA events;
4. slice   -- builds full-width ``clip-vitb32-cc12m`` params from a seeded
   generator, saves them in the checkpoint format, and runs
   ``repro_torch.launch.serve_embed.main`` with ``--impl flash`` for the
   image tower and the text tower; holds every response against the same
   payload's solo forward through the plain attention, every cache hit
   against the computed bytes, and the kernel's launch count against 12
   per computed batch;
5. report  -- the kernels JSON line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line.  Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
ARCH = "clip-vitb32-cc12m"
# H100 SXM data-sheet peaks (dense): HBM bytes/s; f32 outside the tensor
# cores and bf16 tensor-core FLOP/s.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# Tolerances.  Kernel vs plain version: those of tests/test_precision_flash.py.
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Tower embeddings (L2-normalised, 12 layers), flash path vs the plain
# attention and served bucket vs solo forward: the same bounds end to end.
TOL_EMBED = {"float32": 1e-5, "bfloat16": 1e-2}
SERVE_REQUESTS = 64


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, sort_keys=True), flush=True)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=card, tf32_matmul=False, tf32_cudnn=False)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    build.load("flash_attention")
    seconds = time.monotonic() - t0
    log = build.build_log("flash_attention")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit("build", kernel="flash_attention", seconds=seconds,
         library=str(build.lib_path("flash_attention")), ptxas=ptxas)


KERNEL_CASES = [
    # name, B, H, Sq, Sk, hd, causal, window, dtype; "serve" marks the
    # main path's shapes at bucket 8
    ("vit", 8, 12, 50, 50, 64, False, 0, "float32", True),
    ("vit", 8, 12, 50, 50, 64, False, 0, "bfloat16", True),
    ("text", 8, 8, 77, 77, 64, True, 0, "float32", True),
    ("text", 8, 8, 77, 77, 64, True, 0, "bfloat16", True),
    ("sq_ne_sk", 2, 4, 64, 300, 64, False, 0, "float32", False),
    ("sq_ne_sk_causal", 2, 4, 200, 70, 64, True, 0, "bfloat16", False),
    ("window", 2, 4, 130, 130, 64, True, 17, "float32", False),
    ("window_noncausal", 2, 4, 130, 130, 64, False, 40, "bfloat16", False),
    ("long_ragged", 1, 4, 1000, 1000, 64, True, 0, "float32", False),
    ("long_ragged", 1, 4, 1000, 1000, 64, False, 0, "bfloat16", False),
    ("hd32", 2, 4, 77, 77, 32, True, 0, "float32", False),
    ("hd32", 2, 4, 130, 130, 32, False, 0, "bfloat16", False),
]


def phase_kernel(checks):
    """Kernel vs plain version; returns {tower: timing dict} for the f32
    serving shapes (the main path runs the f32 policy)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(0)
    timings = {}
    for (name, B, H, Sq, Sk, hd, causal, window, dt_name,
         serve) in KERNEL_CASES:
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
        if serve:
            ms = device_ms(lambda: FA.flash_attention(
                q, k, v, causal=causal, window=window))
            plain_ms = device_ms(lambda: FA.flash_attention_ref(
                q, k, v, causal=causal, window=window))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            b_ms, b_by = bound(B, H, Sq, Sk, hd, causal, window, dt_name)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            if dt_name == "float32":
                timings[name] = dict(rec)
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


def phase_slice(checks):
    """Serve both towers at full width through the port's launcher.
    Returns {tower: flash launches in its serving run}."""
    import numpy as np
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch.checkpoint import bridge
    from repro_torch.configs import get_arch
    from repro_torch.data import ZeroShotEvalDataset
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve_embed
    from repro_torch.models import backbones as BB
    from repro_torch.models import clip as C
    from repro_torch.models import precision as PR
    from repro_torch.serve import content_hash

    cfg = get_arch(ARCH)
    t0 = time.monotonic()
    model = BB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n_params = sum(p.numel() for p in model.parameters())
    t_init = time.monotonic() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.monotonic()
        CK.save(ckpt, {"params": bridge.model_to_tree(model)}, 0,
                {"arch": ARCH, "seed": 0})
        t_save = time.monotonic() - t0
        npz_bytes = os.path.getsize(os.path.join(ckpt, "ckpt_00000000.npz"))
        emit("slice_params", arch=ARCH, n_params=n_params,
             init_seconds=t_init, save_seconds=t_save, npz_bytes=npz_bytes)
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
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    checks.end_phase("slice")
    return launches


def main():
    checks = Checks()
    phase_device()
    phase_build()
    timings = phase_kernel(checks)
    launches = phase_slice(checks)
    import torch
    kernels = []
    for tower in ("vit", "text"):
        t = timings[tower]
        kernels.append({
            "name": f"flash_attention/{tower}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "shape": t["shape"], "causal": t["causal"], "dtype": t["dtype"],
            "launches": launches[tower],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
