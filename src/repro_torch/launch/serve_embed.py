"""Online embedding serving launcher (port of ``repro.launch.serve_embed``).

Restores CLIP tower params from a checkpoint in the JAX package's format
and serves embedding requests through the serving stack (admission
control, continuous micro-batching, retry over the on-device finiteness
guard, circuit breaker, digest-verified cache, hot checkpoint reload),
then drives a self-generated open-loop load against it and prints one
``SERVE_STATS {json}`` line (submitted == completed + rejected; nothing
dropped silently).  It runs on the card unless ``--device cpu`` is given.

    # known-answer mode: planted closed-form image tower (exact on any
    # device; writes the reference checkpoint on first run)
    PYTHONPATH=src python -m repro_torch.launch.serve_embed --planted \\
        --ckpt-dir /tmp/planted --requests 64 --deadline-ms 200

    # real tower from a train checkpoint, with hot reload and chaos
    PYTHONPATH=src python -m repro_torch.launch.serve_embed \\
        --arch clip-vitb32-cc12m --ckpt-dir ckpts --modality image \\
        [--precision bf16] [--watch-ckpt 1.0] [--chaos compute_nan@2]

``--impl flash`` (the default) is the path through the hand-written
attention kernel; ``chunked`` and ``naive`` are the plain PyTorch
references (the JAX launcher defaults to ``chunked``).  ``--chaos`` takes
the serving faults of ``repro_torch.resilience.chaos`` (``compute_nan``,
``slow_batch``, ``cache_corrupt``, ``reload_bad_ckpt``).  SIGTERM mid-run
stops the load generator, drains every admitted request, writes the
final heartbeat and exits 0.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np

from repro_torch import checkpoint as CK
from repro_torch import device as D
from repro_torch.configs import get_arch
from repro_torch.eval import planted as PL
from repro_torch.launch.eval import build_eval_dataset
from repro_torch.models import backbones as BB
from repro_torch.models import clip as C
from repro_torch.models import precision as PR
from repro_torch.resilience import Heartbeat, StepWatchdog, parse_chaos
from repro_torch.serve import (
    CheckpointWatcher, EmbedServer, RetryPolicy, ServeConfig, ServeRejection,
)


def build_server(args, chaos=None, heartbeat=None, watchdog=None):
    """(server, watcher-or-None, dataset) per the CLI flags."""
    device = D.resolve(args.device)
    if args.planted:
        ds = build_eval_dataset(args)
        if CK.latest_step(args.ckpt_dir) is None:
            path = PL.make_planted_checkpoint(args.ckpt_dir, ds)
            print(f"wrote reference planted checkpoint: {path}")
        like = PL.planted_params(ds, "cpu")
        prefix = ""

        def materialize(t):
            return PL.params_from_tree(t, device)

        def encode(params, batch):
            return PL.encode_image(params, batch["images"])
    else:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        like = BB.param_shapes(cfg)
        prefix = "params"

        def materialize(t):
            return BB.params_from_tree(cfg, t, device=device)

        ds = build_eval_dataset(args, cfg)
        prec = PR.get_precision(args.precision or cfg.precision)
        tower = C.encode_image if args.modality == "image" else C.encode_text
        key = "images" if args.modality == "image" else "texts"

        def encode(params, batch):
            return tower(params, batch[key], impl=args.impl, precision=prec)
    tree, step, _meta = CK.restore_subtree(args.ckpt_dir, like, prefix,
                                           step=args.step)
    params = materialize(tree)
    print(f"restored params at step {step} from {args.ckpt_dir} "
          f"onto {device}")
    cfg_srv = ServeConfig(
        max_batch=args.max_batch, max_wait=args.max_wait_ms / 1000.0,
        queue_capacity=args.queue_capacity,
        default_deadline=(args.deadline_ms / 1000.0
                          if args.deadline_ms else None),
        retry=RetryPolicy(max_retries=args.max_retries),
        breaker_failures=args.breaker_failures,
        breaker_reset=args.breaker_reset,
        cache_capacity=args.cache_capacity, seed=args.seed)
    server = EmbedServer(encode, params, step, cfg_srv, chaos=chaos,
                         heartbeat=heartbeat, watchdog=watchdog,
                         device=device)
    watcher = None
    if args.watch_ckpt is not None:
        watcher = CheckpointWatcher(
            args.ckpt_dir, like, server.store, materialize=materialize,
            prefix=prefix, poll_interval=args.watch_ckpt,
            fault_hook=(chaos.on_reload if chaos is not None else None))
        watcher.start()
    return server, watcher, ds


def run_load(server, ds, args, stop_flag, record=None):
    """Open-loop offered load from the eval split; returns the client-side
    outcome counters (by typed rejection code).  ``record``: optional
    list that receives ``(payload, ServeResult)`` per completed request."""
    rng = np.random.default_rng(args.seed)
    out = {"completed": 0, "OVERLOADED": 0, "DEADLINE": 0, "UNAVAILABLE": 0,
           "offered": 0}
    pool = min(args.payload_pool, ds.n)
    key = "texts" if (not args.planted and args.modality == "text") \
        else "images"
    rows = np.asarray(getattr(ds, key)(np.arange(pool)))
    futures = []
    interval = 1.0 / args.offered_rate if args.offered_rate else 0.0
    next_t = time.monotonic()
    for _ in range(args.requests):
        if stop_flag["sig"] is not None:
            break
        if interval:
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            next_t += interval
        payload = {key: rows[int(rng.integers(pool))]}
        out["offered"] += 1
        try:
            futures.append((payload, server.submit(payload)))
        except ServeRejection as e:
            out[e.code] += 1
    for payload, fut in futures:
        try:
            res = fut.result(timeout=60.0)
            out["completed"] += 1
            if record is not None:
                record.append((payload, res))
        except ServeRejection as e:
            out[e.code] += 1
    return out


def main(argv=None, record=None):
    """CLI entry point; returns the stats dict.  ``record``: optional list
    that receives ``(payload, ServeResult)`` for every completed request
    (for callers that check the responses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--planted", action="store_true",
                    help="known-answer mode: planted closed-form image "
                         "tower (writes the reference checkpoint on "
                         "first run)")
    ap.add_argument("--arch", default="clip-vitb32-cc12m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--modality", default="image",
                    choices=["image", "text"])
    ap.add_argument("--impl", default="flash",
                    choices=["chunked", "flash", "naive"])
    ap.add_argument("--precision", default=None,
                    choices=sorted(PR.POLICIES))
    ap.add_argument("--device", default=D.DEFAULT,
                    help="torch device of the towers (default: the card)")
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--per-class", type=int, default=8)
    ap.add_argument("--flip-frac", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    # engine knobs
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--breaker-failures", type=int, default=3)
    ap.add_argument("--breaker-reset", type=float, default=1.0)
    ap.add_argument("--cache-capacity", type=int, default=1024)
    ap.add_argument("--watch-ckpt", type=float, default=None,
                    help="hot-reload poll interval in seconds")
    ap.add_argument("--chaos", default=None,
                    help="serving fault-injection spec "
                         "(repro_torch.resilience.chaos), e.g. "
                         "'compute_nan@2,reload_bad_ckpt@1'")
    # load generator
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--offered-rate", type=float, default=0.0,
                    help="requests/s (0 = as fast as possible)")
    ap.add_argument("--payload-pool", type=int, default=16,
                    help="distinct payloads to draw from (cache hits)")
    ap.add_argument("--watchdog-timeout", type=float, default=60.0)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    # SIGTERM: note it, stop offering; the drain below finishes every
    # admitted request before exit.
    stop_flag = {"sig": None}

    def on_term(signum, frame):
        stop_flag["sig"] = signum
        print(f"[serve] received signal {signum}; draining", flush=True)
    prev_handler = signal.signal(signal.SIGTERM, on_term)

    chaos = parse_chaos(args.chaos, seed=args.seed)
    heartbeat = Heartbeat(os.path.join(args.ckpt_dir,
                                       "serve_heartbeat.json"),
                          interval=1.0)
    watchdog = StepWatchdog(args.watchdog_timeout, label="served batch")
    try:
        server, watcher, ds = build_server(args, chaos=chaos,
                                           heartbeat=heartbeat,
                                           watchdog=watchdog)
        try:
            client = run_load(server, ds, args, stop_flag, record=record)
        finally:
            if watcher is not None:
                watcher.stop()
            server.close()
    finally:
        watchdog.close()
        heartbeat.close()
        signal.signal(signal.SIGTERM, prev_handler)
    stats = server.snapshot_stats()
    if watcher is not None:
        stats.update(watcher.stats)
    stats["client"] = client
    terminated = (client["completed"] + client["OVERLOADED"]
                  + client["DEADLINE"] + client["UNAVAILABLE"])
    stats["dropped"] = client["offered"] - terminated
    stats["sigterm"] = stop_flag["sig"] is not None
    print("SERVE_STATS " + json.dumps(stats, sort_keys=True))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(stats, f)
    if stats["dropped"]:
        raise SystemExit(f"{stats['dropped']} requests dropped silently")
    return stats


if __name__ == "__main__":
    main()
