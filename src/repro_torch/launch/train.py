"""Training launcher (port of ``repro.launch.train``): FastCLIP on the
synthetic contrastive pairs, or the LM objective of an LM backbone, with
checkpoints, resume and the non-finite step guard.  It runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch clip-vitb32-cc12m --version v3 --steps 200 \\
        [--objective contrastive|lm] [--reduced] [--ckpt-dir ckpts] \\
        [--resume] [--device cpu]

Objectives, as the JAX launcher picks them (``build_dataset``): a CLIP
arch always trains FastCLIP on ``ContrastiveDataset`` (``--objective
lm`` included); an LM backbone (the hybrid ``zamba2-1.2b``, a dense
LM: ``qwen3-1.7b``, ``yi-6b``, ``granite-3-8b``, ``qwen1.5-32b``, or an
MoE LM: ``qwen3-moe-30b-a3b``, ``llama4-scout-17b-a16e``) trains
FastCLIP on ``PairedEmbeddingDataset`` (``backbones.encode_pair``: the
mean-pooled backbone through ``ctr_proj`` against stub paired
embeddings through ``pair_proj``) by default, and ``--objective lm``
trains the next-token loss on ``LMDataset``
(``launch.steps.make_lm_train_step``: AdamW under a 500-step warm-up,
whatever ``--optimizer`` says; ``--version``, ``--loss-impl`` and the
guard do not apply to it).  ``--seq-len`` sets an LM backbone's
sequence length.  Under autograd an LM backbone recomputes in the
backward as JAX's does (``backbones.forward_hidden``: the dense and MoE
stacks under JAX's grouped recompute); the MoE LMs' step logs JAX's
``moe_lb`` and ``moe_z`` beside ``ce``.  Every contrastive run ends with
the ``retrieval accuracy:`` line; ``--eval-every`` evaluates CLIP archs
only.

The defaults reach the hand-written kernels: ``--impl flash`` (the
attention in both towers) and ``--loss-impl fused`` (K1 and K2, the FCCO
loss forward and backward); on CPU tensors both take their plain
versions.  ``--impl chunked|naive`` and ``--loss-impl dense`` are the
plain PyTorch paths.  The log lines are the JAX launcher's.

Checkpoints use the JAX package's format and train-state paths, so a
state saved by ``repro.launch.train --ckpt-dir`` resumes here and the
reverse.  ``--guard`` makes a step with a non-finite loss or gradient
norm a bitwise no-op (metrics ``skipped``/``nonfinite_rate``).  SIGTERM
or SIGINT: the loop finishes the step in flight, writes a final
synchronous checkpoint and returns.  ``--heartbeat-file`` /
``--hang-timeout``: liveness file and stack-dump watchdog.
``--eval-every N`` runs the zero-shot / retrieval eval engine
(``repro_torch.eval.ClipEvaluator``, the same ``--impl`` and
``--precision``, ``eval_loss`` through ``--loss-impl``) every N steps and
after the last, on a planted split seeded ``--seed + 1``, and prints one
``eval  {step} {json}`` line per eval, as the JAX launcher does.

``--mesh data:N[,fsdp:M]`` runs the contrastive step on the (data, fsdp)
mesh (``core.shard_state``): one process per rank, N*M ranks, the batch
and the FCCO u state sharded by sample ownership, params and moments
ZeRO-sharded over fsdp with reduce-scatter gradient reduction, sharded
and rank-tagged checkpoints in the JAX package's format (restorable at
any mesh shape, in either package), and ``--eval-every`` on the sharded
params.  ``--coordinator ADDR --num-processes P --process-id K`` join the
``torch.distributed`` group (ADDR ``file:///path`` or ``HOST:PORT``);
``python -m repro_torch.launch.multiprocess --nproc P -- <train args>``
spawns a whole group.  A ``--mesh`` run without them is a one-rank
group.  The backend follows ``launch.mesh.choose_backend``: NCCL when
every rank has a card of its own, gloo when ranks share a card or run
on the CPU; the run's first line names it, with the world size and this
rank's device.  Each rank assembles only its own rows of the global
batch; only rank 0 writes the heartbeat.  ``--microbatch N`` splits a
rank's rows into N micro-steps with their own weight gathers.
``--reduction allgather_ad`` is the DDP-style baseline loss.

Resilience, as the JAX launcher drives it:

  ``--rollback-after N``
      Implies ``--guard``.  A robust-EMA loss spike detector
      (``resilience.SpikeDetector``) counts consecutive bad steps
      (skipped, non-finite or spiking); at N the run restores the newest
      verified checkpoint, rebuilds the loader stream at its step (the
      index-only fast-forward) and prints a ``rollback:`` line, so the
      replay reproduces the uninterrupted run.  On a mesh every rank
      takes the same decision at the same step.
  ``--ckpt-async``
      The host snapshot is taken synchronously (owned copies; a sharded
      save's gathers on the calling thread), the npz and the atomic
      writes run on a worker thread (``checkpoint.AsyncCheckpointer``).
  ``--ckpt-keep K [--ckpt-keep-every N]``
      Retention: keep the newest K checkpoints (plus every N-th).
  ``--chaos SPEC``
      Deterministic fault injection (``resilience.chaos``): NaN-poison
      a batch, raise in the loader or a decode worker, SIGKILL or
      SIGTERM before a step, SIGKILL at a checkpoint write stage.
  ``--data streaming:DIR``
      Batches from a shard directory (``python -m
      repro_torch.data.streaming`` or the JAX package's writer), decoded
      and augmented on ``--decode-workers`` threads, ``--decode-ahead``
      batches ahead; the index plan is the in-memory loader's, and a
      stream written from the synthetic dataset trains bitwise like the
      in-memory run.  ``--n-samples`` follows the shard index;
      ``--prefetch`` defaults to 4 (2 otherwise).
  ``--image-size-schedule 0:16,300:32`` / ``--context-schedule 0:8``
      Step-keyed curricula on the host batch (exact block-mean image
      shrink, context prefix); the towers adapt their position tables.

The final checkpoint at ``--steps`` (and the one a preemption writes) is
skipped when the loop has just saved that step, which holds the same
state.  ``--local-devices`` is refused with exit code 2: it forces CPU
devices per process in JAX, and a rank here is one process with one
device.  ``--mesh`` with ``--objective lm`` on an LM backbone exits as
the JAX launcher does; with the contrastive objective an LM backbone
(hybrid, dense, MoE or ssm) trains on the mesh like a CLIP arch, its
towers recomputed in the backward as on one device.  An ``--arch`` of
the vlm or audio family exits 2: they train through the step functions
on batches that carry their stub inputs, which this launcher's
datasets, as JAX's launcher's, do not carry (ROADMAP F6).
"""
from __future__ import annotations

import argparse
import json
import signal
import time

import numpy as np
import torch

from repro_torch import checkpoint as CK
from repro_torch import device as D
from repro_torch import resilience as RS
from repro_torch.checkpoint import bridge
from repro_torch.configs import get_arch
from repro_torch.core import fastclip as FC
from repro_torch.core import shard_state as SS
from repro_torch.core import train_step as TS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import (
    ContrastiveDataset, DevicePrefetcher, LMDataset, PairedEmbeddingDataset,
    ShardedLoader, StreamingDataset, StreamingLoader, ZeroShotEvalDataset,
)
from repro_torch.data import curriculum as CU
from repro_torch.eval import ClipEvaluator
from repro_torch.launch import mesh as MS
from repro_torch.launch import multiprocess as MP
from repro_torch.launch import steps as ST
from repro_torch.models import backbones as BB
from repro_torch.models.precision import POLICIES
from repro_torch.optim import OPTIMIZERS, get_optimizer

def build_dataset(cfg, objective, n, seq_len, data="synthetic"):
    """The JAX launcher's dataset for (arch, objective): a shard directory
    for ``--data streaming:DIR``, else a CLIP arch's image-text pairs, an
    LM backbone's paired embeddings (contrastive) or token stream (lm)."""
    if data.startswith("streaming:"):
        try:
            return StreamingDataset(data.split(":", 1)[1])
        except (OSError, ValueError) as e:
            raise SystemExit(f"--data {data}: {e}")
    if cfg.family == "clip":
        return ContrastiveDataset(n=n, image_size=cfg.clip.image_size,
                                  context_length=cfg.clip.context_length,
                                  vocab_size=cfg.vocab_size, n_classes=64)
    if objective == "contrastive":
        return PairedEmbeddingDataset(n=n, seq_len=seq_len,
                                      vocab_size=cfg.vocab_size)
    return LMDataset(n=n, seq_len=seq_len, vocab_size=cfg.vocab_size)


def check_resume_metadata(meta, arch: str, version: str) -> None:
    """Refuse a checkpoint written by another run shape (arch or
    version); checkpoints without the keys pass."""
    for key, want in (("arch", arch), ("version", version)):
        got = meta.get(key)
        if got is not None and got != want:
            raise SystemExit(
                f"--resume: checkpoint metadata has {key}={got!r} but "
                f"this run was launched with --{key} {want}; restoring "
                "would mismatch the state layout.  Relaunch with "
                f"--{key} {got} or point --ckpt-dir at a fresh "
                "directory.")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="clip-vitb32-cc12m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--version", default="v3", choices=FC.VERSIONS)
    ap.add_argument("--objective", default="contrastive",
                    choices=["contrastive", "lm"],
                    help="an LM backbone's objective (a CLIP arch trains "
                         "contrastively either way)")
    ap.add_argument("--optimizer", default="adamw", choices=sorted(OPTIMIZERS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=32,
                    help="an LM backbone's sequence length")
    ap.add_argument("--n-samples", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--wd", type=float, default=0.1)
    ap.add_argument("--rho", type=float, default=6.5)
    ap.add_argument("--eps", type=float, default=1e-14)
    ap.add_argument("--gamma-min", type=float, default=0.2)
    ap.add_argument("--loss-impl", default="fused", choices=["dense", "fused"],
                    help="loss-layer math: the K1/K2 kernels (fused, the "
                         "default) or dense torch")
    ap.add_argument("--precision", default=None, choices=sorted(POLICIES),
                    help="tower precision policy (bf16 compute, f32 masters "
                         "and f32 loss layer); unset defers to the arch (f32)")
    ap.add_argument("--impl", default="flash",
                    choices=["chunked", "flash", "naive"],
                    help="attention: the flash kernel (default) or the plain "
                         "chunked / naive references")
    ap.add_argument("--reduction", default="fastclip",
                    choices=["fastclip", "allgather_ad"],
                    help="mesh loss reduction: the closed-form backward "
                         "(fastclip) or autograd through the feature gather "
                         "(the DDP-style baseline)")
    ap.add_argument("--mesh", default=None,
                    help="data:N[,fsdp:M]: the (data, fsdp) mesh of N*M "
                         "ranks, one process each; unset = one device")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="micro-steps per rank in the mesh step, each with "
                         "its own weight gather; 1 = unpipelined")
    ap.add_argument("--coordinator", default=None,
                    help="torch.distributed init method of the group: "
                         "file:///path or HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="ranks in the group (= data * fsdp)")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this process's rank in [0, --num-processes)")
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' (in-memory, default) or "
                         "'streaming:<dir>', a shard directory written by "
                         "python -m repro_torch.data.streaming")
    ap.add_argument("--decode-workers", type=int, default=4,
                    help="streaming decode worker threads")
    ap.add_argument("--decode-ahead", type=int, default=4,
                    help="streaming batches decoded ahead of the step loop")
    ap.add_argument("--image-size-schedule", default=None,
                    help="resolution curriculum 'STEP:SIZE[,...]' (sizes "
                         "must divide the native image size)")
    ap.add_argument("--context-schedule", default=None,
                    help="text-context curriculum 'STEP:LEN[,...]'")
    ap.add_argument("--prefetch", type=int, default=None,
                    help="host->device prefetch depth (0 disables; default "
                         "2, or 4 under --data streaming)")
    ap.add_argument("--device", default=D.DEFAULT,
                    help="torch device (default: the card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-async", action="store_true",
                    help="write checkpoints on a worker thread (synchronous "
                         "host snapshot, async npz and atomic writes)")
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="retention: keep only the newest K checkpoints "
                         "(0 keeps all)")
    ap.add_argument("--ckpt-keep-every", type=int, default=0,
                    help="with --ckpt-keep: also keep every N-th step")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--guard", action="store_true",
                    help="non-finite step guard: a bad step becomes a "
                         "bitwise no-op update")
    ap.add_argument("--rollback-after", type=int, default=0,
                    help="roll back to the last checkpoint after N "
                         "consecutive bad steps (0 disables; implies "
                         "--guard)")
    ap.add_argument("--chaos", default=None,
                    help="fault-injection spec (repro_torch.resilience."
                         "chaos), e.g. 'nan_batch@5,kill_save@mid_npz'")
    ap.add_argument("--heartbeat-file", default=None,
                    help="liveness file (default: <ckpt-dir>/heartbeat.json "
                         "when --ckpt-dir is set)")
    ap.add_argument("--hang-timeout", type=float, default=0.0,
                    help="dump all thread stacks when no step completes for "
                         "this many seconds (0 disables)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run the zero-shot/retrieval eval engine every N "
                         "steps (CLIP archs; 0 disables), through the same "
                         "--impl / --precision fast path as training")
    ap.add_argument("--eval-classes", type=int, default=8)
    ap.add_argument("--eval-per-class", type=int, default=8)
    ap.add_argument("--eval-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    # a flag of the JAX launcher with no meaning here (refused)
    ap.add_argument("--local-devices", type=int, default=None)
    args = ap.parse_args(argv)
    if args.local_devices is not None:
        ap.error("--local-devices has no meaning here: it forces CPU "
                 "devices per process in JAX, and every rank of "
                 "repro_torch is one process with one device (launch more "
                 "ranks: python -m repro_torch.launch.multiprocess)")
    if (args.num_processes > 1 or args.coordinator) and not args.mesh:
        ap.error("--num-processes > 1 / --coordinator require --mesh "
                 "data:N[,fsdp:M]: the multi-process trainer is the mesh "
                 "step")
    if args.microbatch != 1 and not args.mesh:
        ap.error("--microbatch needs --mesh: micro-steps belong to the "
                 "mesh step")
    try:
        cfg = get_arch(args.arch)
    except KeyError:
        ap.error(f"--arch {args.arch}: no such config (the "
                 f"{', '.join(BB.FAMILIES)} families are registered)")
    if cfg.family in BB.CROSS_FAMILIES:
        stub = "image_embeds" if cfg.family == "vlm" else "frames"
        ap.error(f"--arch {args.arch}: the {cfg.family} family trains "
                 "through the step functions (repro_torch.launch.steps."
                 "make_lm_train_step, core.train_step.make_train_step) on "
                 f"batches that carry {stub}, but this launcher cannot "
                 f"feed it: its datasets carry no {stub}, as JAX's "
                 "launcher's carry none (ROADMAP F6); it serves through "
                 "repro_torch.launch.serve")
    if args.mesh and cfg.family != "clip" and args.objective == "lm":
        raise SystemExit("--mesh drives the contrastive trainer; the LM "
                         "shapes run on the production mesh via "
                         "repro.launch.dryrun")
    if args.data != "synthetic" and not args.data.startswith("streaming:"):
        ap.error(f"--data {args.data!r}: want 'synthetic' or "
                 "'streaming:<shard-dir>'")
    try:
        image_sched = CU.parse_schedule(args.image_size_schedule)
        CU.parse_schedule(args.context_schedule)
        RS.parse_chaos(args.chaos, seed=args.seed)
    except ValueError as e:
        ap.error(str(e))
    if image_sched and cfg.clip is not None:
        native = (cfg.reduced() if args.reduced else cfg).clip.image_size
        bad = [v for _, v in image_sched if native % v]
        if bad:
            ap.error(f"--image-size-schedule: curriculum image sizes {bad} "
                     f"must divide the stored size ({native}x{native})")
    return args


def _to_device(item, device):
    """(epoch, step, idx, numpy batch) -> the same on ``device``; to the
    card through pinned host memory with non-blocking copies."""
    epoch, step, idx, batch = item
    if device.type == "cuda":
        def put(a):
            return torch.from_numpy(a).pin_memory().to(device,
                                                       non_blocking=True)
    else:
        def put(a):
            return torch.from_numpy(a).to(device)
    return (epoch, step, put(np.asarray(idx, np.int64)),
            {k: put(np.ascontiguousarray(v)) for k, v in batch.items()})


def main(argv=None, record=None):
    """CLI entry point; returns the final train state (on a mesh, this
    rank's shards).  ``record``: optional list that receives one dict per
    step (``step``, ``epoch``, the host clock ``time`` after the step's
    metrics were read, and every metric as a float)."""
    args = parse_args(argv)
    mesh = None
    if args.mesh:
        data_sz, fsdp_sz = MS.parse_mesh_arg(args.mesh)
        device = MP.initialize(args.coordinator, args.num_processes,
                               args.process_id, D.resolve(args.device))
        try:
            mesh = MS.make_train_mesh(data_sz, fsdp_sz, device=device)
        except ValueError as e:
            MP.shutdown()
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        print(f"mesh data:{data_sz},fsdp:{fsdp_sz} backend {mesh.backend} "
              f"world {mesh.world_size} rank {mesh.rank} device {device}",
              flush=True)
    else:
        device = D.resolve(args.device)
    try:
        return _train(args, device, mesh, record)
    finally:
        if mesh is not None:
            MS.set_mesh(None)
            MP.shutdown()


def _train(args, device, mesh, record):
    rank = mesh.rank if mesh is not None else 0
    world = mesh.world_size if mesh is not None else 1
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lm = args.objective == "lm" and cfg.family != "clip"
    streaming = args.data.startswith("streaming:")
    ds = build_dataset(cfg, args.objective, args.n_samples, args.seq_len,
                       args.data)
    if streaming:
        args.n_samples = ds.n    # FCCO u sizing follows the shard index
    if args.prefetch is None:
        args.prefetch = 4 if streaming else 2
    image_sched = CU.parse_schedule(args.image_size_schedule)
    context_sched = CU.parse_schedule(args.context_schedule)
    chaos = RS.parse_chaos(args.chaos, seed=args.seed)
    owned = (rank,) if mesh is not None else None
    if streaming:
        loader = StreamingLoader(
            ds, global_batch=args.global_batch, n_shards=world,
            seed=args.seed, owned_shards=owned,
            workers=args.decode_workers, decode_ahead=args.decode_ahead,
            fault_hook=chaos.on_decode if chaos is not None else None)
    else:
        loader = ShardedLoader(ds, global_batch=args.global_batch,
                               n_shards=world, seed=args.seed,
                               owned_shards=owned)
    fc = FC.FastCLIPConfig(
        version=args.version, n_samples=args.n_samples, rho=args.rho,
        eps=args.eps, gamma_min=args.gamma_min,
        tau_init=0.07 if args.version == "v3" else 0.03,
        lr_tau=2e-4 if args.version == "v3" else 1e-2,
        steps_per_epoch=loader.steps_per_epoch,
        gamma_decay_epochs=max(
            1, args.steps // (2 * loader.steps_per_epoch)))
    tc = TS.TrainStepConfig(
        arch=cfg, fc=fc, optimizer=get_optimizer(args.optimizer),
        lr_fn=lr_warmup_cosine(args.lr, min(500, args.steps // 10 + 1),
                               args.steps),
        wd=args.wd, loss_impl=args.loss_impl, impl=args.impl,
        precision=args.precision,
        guard=args.guard or args.rollback_after > 0,
        reduction=args.reduction,
        mesh_axes=MS.TRAIN_AXES if mesh is not None else None,
        fsdp=mesh is not None, microbatch=args.microbatch)
    gen = torch.Generator().manual_seed(args.seed)
    start = 0
    if lm:
        # JAX's LM step: AdamW, its own warm-up, no guard
        lm_step, opt = ST.make_lm_train_step(
            cfg, lr=args.lr, wd=args.wd, total_steps=args.steps,
            impl=args.impl, precision=args.precision, device=device)
        state = ST.init_lm_train_state(cfg, gen, opt, device)

        def step_fn(state, batch, idx):
            return lm_step(state, batch)
        p_dims = None
    elif mesh is None:
        state = TS.init_train_state(gen, tc, device)
        step_fn = TS.make_train_step(tc, device)
        p_dims = None
    else:
        try:
            step_fn = TS.make_train_step(tc)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        p_dims = step_fn.param_dims
        # every rank builds the same full state on the host and keeps its
        # shards (a resume restores the merged checkpoint first)
        tree = bridge.state_to_tree(TS.init_train_state(gen, tc, "cpu"))
        # the full shapes, for the merged restores of a rollback
        full_like = CK.unflatten({
            k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in CK.flatten(tree).items()})

    def restore(step=None):
        """(this run's state from a checkpoint, its step, its metadata),
        or None when no step loads and verifies.  ``step=None`` reads the
        newest step that does, once (``latest_step`` would read it a
        second time).  On a mesh every rank reads the merged checkpoint
        and keeps its shards."""
        like = bridge.state_to_tree(state) if mesh is None else full_like
        try:
            got, at, meta = CK.restore(args.ckpt_dir, like, step=step)
        except FileNotFoundError:
            return None
        if mesh is None:
            return bridge.state_from_tree(state, got), at, meta
        return SS.shard_train_state(got, mesh, p_dims), at, meta

    resumed = None
    steps_saved = CK.available_steps(args.ckpt_dir) if args.ckpt_dir else []
    if args.resume and steps_saved:
        # the run shape first: a v2 state does not fit a v3 run
        check_resume_metadata(CK.read_metadata(args.ckpt_dir,
                                               steps_saved[-1]),
                              args.arch, args.version)
        resumed = restore()
    if resumed is not None:
        state, start, ck_meta = resumed
        check_resume_metadata(ck_meta, args.arch, args.version)
        print(f"resumed from step {start}")
    elif mesh is not None:
        state = SS.shard_train_state(tree, mesh, p_dims)
    if mesh is not None:
        del tree

    evaluator = None
    if args.eval_every and cfg.family == "clip":
        eval_ds = ZeroShotEvalDataset(
            n_classes=args.eval_classes, n_per_class=args.eval_per_class,
            image_size=cfg.clip.image_size,
            context_length=cfg.clip.context_length,
            vocab_size=cfg.vocab_size, seed=args.seed + 1)
        evaluator = ClipEvaluator(
            cfg, eval_ds, impl=args.impl, precision=args.precision,
            batch_size=args.eval_batch,
            loss_impl=args.loss_impl or "dense", device=device,
            param_dims=p_dims, mesh=mesh)

    def run_eval(step):
        em = evaluator.evaluate(state["params"], cache_key=int(step))
        print(f"eval  {step:5d} " + json.dumps(
            {k: round(v, 5) for k, v in sorted(em.items())}), flush=True)

    def host_stream(from_step):
        # chaos, then the curricula, on the host batch before the H2D
        # copy; the step takes this rank's rows of the global index plan
        for epoch, step, idx, batch in loader.steps(args.steps,
                                                    start=from_step):
            if chaos is not None:
                chaos.on_loader(step)
                batch = chaos.poison_batch(step, batch)
            batch = CU.apply_curriculum(batch, step, image_sched,
                                        context_sched)
            if mesh is not None:
                idx = loader._owned_rows(idx)
            yield epoch, step, idx, batch

    def unprefetched(it):
        try:
            for item in it:
                yield _to_device(item, device)
        finally:
            it.close()

    def make_stream(from_step):
        it = host_stream(from_step)
        if args.prefetch > 0:
            return DevicePrefetcher(it, depth=args.prefetch,
                                    transform=lambda x: _to_device(x, device))
        return unprefetched(it)

    meta = {"arch": args.arch, "version": args.version}
    saver = (CK.AsyncCheckpointer(args.ckpt_dir, keep_last=args.ckpt_keep,
                                  keep_every=args.ckpt_keep_every,
                                  process_index=rank, process_count=world)
             if args.ckpt_dir and args.ckpt_async else None)
    saved = {"step": None}    # the step of the newest save of this run

    def save_ckpt(step_no, sync=False):
        saved["step"] = step_no
        if saver is not None and not sync:
            if mesh is not None:
                saver.save(state, step_no, metadata=meta, mesh=mesh,
                           param_dims=p_dims)
            else:
                saver.save(bridge.state_to_tree(state), step_no,
                           metadata=meta)
            return
        if saver is not None:
            saver.wait()
        if mesh is not None:
            CK.save_sharded(args.ckpt_dir, state, step_no, mesh, p_dims,
                            metadata=meta)
        else:
            CK.save(args.ckpt_dir, bridge.state_to_tree(state), step_no,
                    metadata=meta)
        if args.ckpt_keep > 0 and rank == 0:
            CK.prune_checkpoints(args.ckpt_dir, keep_last=args.ckpt_keep,
                                 keep_every=args.ckpt_keep_every)

    hb_path = args.heartbeat_file or (
        f"{args.ckpt_dir}/heartbeat.json" if args.ckpt_dir else None)
    # only rank 0 writes the heartbeat: ranks sharing a filesystem would
    # clobber each other's records
    hb = RS.Heartbeat(hb_path) if hb_path and rank == 0 else None
    wd = (RS.StepWatchdog(args.hang_timeout)
          if args.hang_timeout > 0 else None)
    detector = RS.SpikeDetector(rollback_after=args.rollback_after)
    received = {"sig": None}

    def on_signal(signum, frame):
        received["sig"] = signum    # honoured between steps: clean exit

    def any_rank(flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any rank (a
        collective on a mesh: every rank calls it at the same point)."""
        if mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=device)
        return bool(SS.staged_psum(t, mesh).item() > 0)

    def preempt_now():
        # every rank stops at the same step when any rank was signalled
        return any_rank(received["sig"] is not None)

    def rollback_due(m) -> bool:
        due = detector.update(float(m["loss"]),
                              float(m.get("skipped", 0.0)) >= 0.5)
        if args.rollback_after <= 0:
            return False
        # the loss and the skip flag are global, so every rank's detector
        # sees the same values; the decision still goes through an
        # all-reduce, as preempt_now's does: ranks that disagreed would
        # wait in the next collective for each other forever
        return any_rank(due)

    def rollback_restore():
        """(state, step) of the newest verified checkpoint, or None; on a
        mesh rank 0 picks the step, so that every rank restores the same
        one."""
        if saver is not None:
            saver.wait()
        if not args.ckpt_dir:
            return None
        if mesh is None:
            got = restore()
            return None if got is None else got[:2]
        rb = CK.latest_step(args.ckpt_dir) if rank == 0 else 0
        rb = int(SS.staged_psum(torch.tensor(
            [float(-1 if rb is None else rb)], device=device), mesh).item())
        return None if rb < 0 else restore(rb)[:2]

    prev_handlers = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[s] = signal.signal(s, on_signal)
        except ValueError:          # not the main thread (embedded call)
            pass
    if chaos is not None:
        CK.set_fault_hook(chaos.checkpoint_event)

    t0 = time.time()
    first = True
    done = start
    preempted = False
    stream = make_stream(start)
    try:
        running = True
        while running:
            running = False         # re-armed only by a rollback
            for epoch, step, idx, batch in stream:
                if preempt_now():
                    preempted = True
                    break
                if chaos is not None:
                    chaos.pre_step(step)
                state, m = step_fn(state, batch, idx)
                done = step + 1
                if first:
                    # params, moments and FCCO state stay f32 masters
                    TS.check_state_dtypes(state)
                    first = False
                if hb is not None:
                    hb.beat(step)
                if wd is not None:
                    wd.beat()
                if step % args.log_every == 0 or step == args.steps - 1:
                    # sorted keys: the JAX launcher's jitted metrics dict
                    msg = {k: round(float(m[k]), 5) for k in sorted(m)}
                    print(f"step {step:5d} epoch {epoch} {json.dumps(msg)}",
                          flush=True)
                if record is not None:
                    vals = {k: float(v) for k, v in m.items()}
                    record.append({"step": step, "epoch": epoch,
                                   "time": time.monotonic(), **vals})
                if rollback_due(m):
                    got = rollback_restore()
                    if got is None:
                        print(f"step {step:5d} {detector.consecutive_bad} "
                              "consecutive bad steps but no checkpoint to "
                              "roll back to; continuing", flush=True)
                        detector.reset()
                    else:
                        state, rb = got
                        detector.reset()
                        stream.close()
                        stream = make_stream(rb)
                        done = rb
                        saved["step"] = rb
                        print(f"rollback: {args.rollback_after} "
                              "consecutive bad steps; restored verified "
                              f"step {rb}, replaying the deterministic "
                              "stream from there", flush=True)
                        running = True
                        break
                if evaluator is not None and (step + 1) % args.eval_every == 0:
                    run_eval(step + 1)
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    save_ckpt(step + 1)
    finally:
        stream.close()
        if wd is not None:
            wd.close()
        if hb is not None:
            hb.close()
        if chaos is not None:
            CK.set_fault_hook(None)
        for s, h in prev_handlers.items():
            signal.signal(s, h)

    if preempted:
        # a final synchronous checkpoint, then a clean exit: the resumed
        # run replays from `done`
        if args.ckpt_dir and saved["step"] != done:
            save_ckpt(done, sync=True)
        if saver is not None:
            saver.close()
        print(f"preempted (signal {received['sig']}): saved synchronous "
              f"checkpoint at step {done}, exiting cleanly", flush=True)
        return state

    dt = time.time() - t0
    print(f"trained {args.steps - start} steps in {dt:.1f}s "
          f"({(args.steps - start) / max(dt, 1e-9):.2f} steps/s)")
    if not lm:
        eval_batch = {k: torch.from_numpy(v).to(device)
                      for k, v in ds.batch(np.arange(
                          min(128, args.n_samples))).items()}
        # on a mesh the metric runs on the gathered params, on every rank
        params = (state["params"] if mesh is None else BB.params_from_tree(
            cfg, CK.unflatten(SS.full_params(state["params"], p_dims)),
            device))
        acc = float(TS.retrieval_accuracy(params, cfg, eval_batch))
        del params
        print(f"retrieval accuracy: {acc:.4f}")
    if evaluator is not None and args.steps % args.eval_every != 0:
        run_eval(args.steps)   # final eval unless the loop just ran it
    if args.ckpt_dir and saved["step"] != args.steps:
        save_ckpt(args.steps, sync=True)
    if saver is not None:
        saver.close()
    return state


if __name__ == "__main__":
    main()
