"""Subprocess helper: the port's (data, fsdp) mesh batteries, one rank per
process over gloo on the CPU.  Each battery runs in every rank of a
4-rank group spawned by ``spawn`` (``repro_torch.launch.multiprocess``);
rank 0 writes OUT/<battery>.npz (arrays) and OUT/<battery>.json (checks),
which tests/test_torch_mesh*.py read.

Batteries:
  loss   the sharded loss ops (fcco dense/fused x mean/local x scalar /
         per-row taus, allgather_ad, mbcl) on the inputs of IN.npz, at
         data:2,fsdp:2: loss, gathered per-row aux, gathered gradients
  step   the port of tests/helpers/fsdp_check.py: 3 sharded steps at
         data:2,fsdp:2 against the replicated layout (bitwise) and the
         single-device step; microbatch 2 and 4 against 1; per-rank bytes
         of params + moments; the staged / flat reduction and
         scatter-then-gather / psum properties (hypothesis)
  ckpt   a JAX fsdp=4 checkpoint (IN dir) restored and sharded at
         data:1,fsdp:4, each rank's shards against the JAX state; the
         port's 4-rank save_sharded of it into OUT/port_ckpt
  eval   the K=4 battery of tests/helpers/eval_check.py: the sharded
         streaming top-k against the dense oracle, and the planted known
         answers through the sharded retrieval, exact
  cuda   (a card, 2 ranks sharing it over gloo) all-gather,
         reduce-scatter and all-reduce on CUDA tensors, and the backward
         of the differentiable gathers
  rn50   (2 ranks, data:1,fsdp:2) one ZeRO step of the narrow ResNet-50
         CLIP (``narrow_rn50``) against the single-device step
  lm     (2 ranks, data:1,fsdp:2) two contrastive (v3) ZeRO steps of
         each LM backbone of ``LM_ARCHS`` (``lm_cfg``) against the
         single-device steps, the gathers' backward counted, then the
         sharded checkpoint of the result in OUT/lm_ckpt_<arch>
  moe    the ``lm`` battery for the MoE LMs of ``MOE_ARCHS``
  xlstm  (2 ranks, data:1,fsdp:2) the ``lm`` battery for the xLSTM of
         ``XLSTM_ARCHS``

    PYTHONPATH=src:tests/helpers python -m torch_mesh_check <battery> \\
        OUT [IN] \\
        --coordinator file:///... --num-processes 4 --process-id K
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import bridge, flatten  # noqa: E402
from repro_torch.core import distributed as DI  # noqa: E402
from repro_torch.core import shard_state as SS  # noqa: E402
from repro_torch.launch import mesh as MS  # noqa: E402
from repro_torch.launch import multiprocess as MP  # noqa: E402

AXES = ("data", "fsdp")
EPS = 1e-14
N_SAMPLES, GLOBAL_BATCH = 64, 32


def spawn(battery, out, inp="", nproc=4, timeout=240.0):
    """Run ``battery`` in a group of ``nproc`` CPU ranks; returns the
    harness results (one per rank)."""
    return MP.run_train_multiprocess(
        [battery, str(out), str(inp)], num_processes=nproc, timeout=timeout,
        module="torch_mesh_check",
        env_extra={"PYTHONPATH": os.pathsep.join(
            [os.path.join(ROOT, "src"), os.path.dirname(
                os.path.abspath(__file__))]), "OMP_NUM_THREADS": "1"})


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

LOSS_CASES = [f"fcco-{impl}-{red}-{tau}" for impl in ("dense", "fused")
              for red in ("mean", "local") for tau in ("scalar", "rows")] + [
    f"{kind}-none-{red}-scalar" for kind in ("allgather_ad", "mbcl")
    for red in ("mean", "local")]


def loss_inputs(seed=0, B=32, d=16):
    """The loss cases' inputs, drawn with numpy from ``seed``."""
    rng = np.random.RandomState(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)
    lu = np.log(rng.uniform(size=(2, B)) + 0.1).astype(np.float32)
    lu[:, ::5] = -np.inf            # untouched rows: the init state
    return {"e1": unit(rng.randn(B, d)), "e2": unit(rng.randn(B, d)),
            "lu1": lu[0], "lu2": lu[1],
            "lw1": (rng.randn(B) * 0.5).astype(np.float32),
            "lw2": (rng.randn(B) * 0.5).astype(np.float32),
            "tau": np.float32(0.07),
            "tau_rows": (rng.uniform(size=B) * 0.05 + 0.03).astype(
                np.float32),
            "gamma": np.float32(0.5), "cases": np.asarray(LOSS_CASES)}


def battery_loss(mesh, out, inp):
    x = dict(np.load(inp))
    b = x["e1"].shape[0] // mesh.world_size
    lo = mesh.rank * b

    def rows(k):
        return torch.from_numpy(np.ascontiguousarray(x[k][lo:lo + b]))

    res = {}
    for case in LOSS_CASES:
        kind, impl, reduce, tau = case.split("-")
        e1 = rows("e1").requires_grad_(True)
        e2 = rows("e2").requires_grad_(True)
        t = rows("tau_rows") if tau == "rows" else float(x["tau"])
        if kind == "fcco":
            op = DI.make_fcco_loss_op(AXES, EPS, True, loss_impl=impl,
                                      reduce=reduce)
            loss, (lu1n, lu2n, stats, sat) = op(
                e1, e2, rows("lu1"), rows("lu2"), t, t, float(x["gamma"]))
            aux = (lu1n, lu2n, *stats, sat)
        elif kind == "allgather_ad":
            f = DI.make_allgather_ad_pair_loss(AXES, reduce=reduce)
            ones = torch.ones(b)
            loss, stats = f(e1, e2, rows("lw1"), rows("lw2"), t * ones,
                            t * ones)
            aux = tuple(stats)
        else:
            loss = DI.make_mbcl_loss(AXES, reduce=reduce)(e1, e2, t)
            aux = ()
        de1, de2 = torch.autograd.grad(loss, (e1, e2))
        losses = DI.gather_axes(loss.detach().reshape(1), AXES)
        res[f"{case}/loss"] = (losses[:1] if reduce == "mean"
                               else losses).numpy()
        for i, a in enumerate(aux):
            res[f"{case}/aux{i}"] = DI.gather_axes(a.detach(), AXES).numpy()
        res[f"{case}/de1"] = DI.gather_axes(de1, AXES).numpy()
        res[f"{case}/de2"] = DI.gather_axes(de2, AXES).numpy()
    return res, {}


# ---------------------------------------------------------------------------
# step (the fsdp_check battery)
# ---------------------------------------------------------------------------

def narrow_rn50(get_arch):
    """The reduced ``clip-rn50-cc3m`` with a narrow ResNet (stem width 16,
    32 px, embed 64; the stage depths stay), from either package's
    ``get_arch``."""
    cfg = get_arch("clip-rn50-cc3m").reduced()
    return cfg.replace(clip=dataclasses.replace(
        cfg.clip, vision_width=16, image_size=32, embed_dim=64))


def _setup(version="v3", cfg=None, n_shards=4, steps=3):
    from repro_torch.configs import get_arch
    from repro_torch.core import fastclip as FC
    from repro_torch.core.schedules import lr_warmup_cosine
    from repro_torch.data import ContrastiveDataset, ShardedLoader
    from repro_torch.optim import adamw
    cfg = cfg or get_arch("clip-vitb32-cc12m").reduced()
    fc = FC.FastCLIPConfig(version=version, n_samples=N_SAMPLES,
                           steps_per_epoch=2, gamma_decay_epochs=2)
    # guard=True runs the axis-aware global norm (the sharded squares
    # all-reduced over fsdp); a healthy step is never skipped
    kw = dict(arch=cfg, fc=fc, optimizer=adamw(),
              lr_fn=lr_warmup_cosine(1e-3, 2, 10), wd=0.1, impl="chunked",
              loss_impl="dense", guard=True)
    ds = ContrastiveDataset(n=N_SAMPLES, image_size=cfg.clip.image_size,
                            context_length=cfg.clip.context_length,
                            vocab_size=cfg.vocab_size, n_classes=8)
    loader = ShardedLoader(ds, global_batch=GLOBAL_BATCH, n_shards=n_shards)
    batches = [(torch.from_numpy(idx),
                {k: torch.from_numpy(v) for k, v in batch.items()})
               for _, _, idx, batch in loader.steps(steps)]
    return kw, batches


def _local(batches, mesh):
    L = GLOBAL_BATCH // mesh.world_size
    lo = mesh.rank * L
    return [(idx[lo:lo + L], {k: v[lo:lo + L] for k, v in b.items()})
            for idx, b in batches]


def _run3(step, state, batches):
    losses = []
    for idx, b in batches:
        state, m = step(state, b, idx)
        losses.append(float(m["loss"]))
    return state, losses, float(m["grad_norm"])


def _flat_np(tree):
    return {k: v.detach().numpy() for k, v in flatten(tree).items()}


def _bitwise(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


def _maxdiff(a, b, prefix):
    out = 0.0
    for k in a:
        if k.startswith(prefix):
            d = np.abs(a[k].astype(np.float64) - b[k])
            d[a[k] == b[k]] = 0.0       # incl. matching -inf log-u rows
            out = max(out, float(np.max(d)) if d.size else 0.0)
    return out


def battery_step(mesh, out, inp):
    from repro_torch import checkpoint as CK
    from repro_torch.core import train_step as TS
    checks, res = {}, {}
    for version in ("v3", "v2"):
        kw, batches = _setup(version)
        tc = TS.TrainStepConfig(**kw, mesh_axes=AXES, fsdp=True)
        st0 = TS.init_train_state(torch.Generator().manual_seed(1),
                                  TS.TrainStepConfig(**kw), "cpu")
        # cloned: the single-device step below updates st0's module in
        # place, and the tree's unstacked leaves are its parameters
        tree0 = CK.unflatten({k: v.clone() for k, v in flatten(
            bridge.state_to_tree(st0)).items()})
        local = _local(batches, mesh)
        step_sh = TS.make_train_step(tc)
        dims = step_sh.param_dims
        st_sh, loss_sh, gn_sh = _run3(
            step_sh, SS.shard_train_state(tree0, mesh), local)
        none = {k: None for k in dims}
        step_rep = TS.make_fsdp_train_step(tc, param_dims=none)
        st_rep, loss_rep, gn_rep = _run3(
            step_rep, SS.shard_train_state(tree0, mesh, none), local)
        full_sh = _flat_np(SS.gather_train_state(st_sh, mesh, dims))
        full_rep = _flat_np(SS.gather_train_state(st_rep, mesh, none))
        # the single-device step on the whole batch, in this process
        st_1, loss_1, gn_1 = _run3(TS.make_train_step(
            TS.TrainStepConfig(**kw), "cpu"), st0, batches)
        full_1 = _flat_np(bridge.state_to_tree(st_1))
        v = version
        checks[f"{v}/bit_loss"] = [np.float32(a).tobytes()
                                   == np.float32(b).tobytes()
                                   for a, b in zip(loss_sh, loss_rep)]
        for part in ("params", "opt", "fc/u1", "fc/u2", "fc/tau", "step"):
            a = {k: w for k, w in full_sh.items() if k.startswith(part)}
            b = {k: w for k, w in full_rep.items() if k.startswith(part)}
            checks[f"{v}/bit_{part}"] = _bitwise(a, b) and bool(a)
        checks[f"{v}/grad_norm"] = [gn_sh, gn_rep, gn_1]
        checks[f"{v}/dloss"] = max(abs(a - b) for a, b in
                                   zip(loss_sh, loss_1))
        checks[f"{v}/dparam"] = _maxdiff(full_sh, full_1, "params/")
        checks[f"{v}/dlogu"] = max(_maxdiff(full_sh, full_1, "fc/u1"),
                                   _maxdiff(full_sh, full_1, "fc/u2"))
        if v == "v3":
            # microbatch 2 and 4 against the unpipelined step
            for nmb in (2, 4):
                st_n, loss_n, _ = _run3(TS.make_train_step(
                    dataclasses.replace(tc, microbatch=nmb)),
                    SS.shard_train_state(tree0, mesh), local)
                full_n = _flat_np(SS.gather_train_state(st_n, mesh, dims))
                checks[f"mb{nmb}/dloss"] = max(abs(a - b) for a, b in
                                               zip(loss_sh, loss_n))
                checks[f"mb{nmb}/dparam"] = _maxdiff(full_sh, full_n,
                                                     "params/")
                checks[f"mb{nmb}/dlogu"] = max(
                    _maxdiff(full_sh, full_n, "fc/u1"),
                    _maxdiff(full_sh, full_n, "fc/u2"))
                checks[f"mb{nmb}/bit_step"] = _bitwise(
                    {k: w for k, w in full_sh.items() if k.endswith("step")},
                    {k: w for k, w in full_n.items() if k.endswith("step")})
            # live bytes of params + moments on this rank vs the whole
            st = SS.shard_train_state(tree0, mesh)
            heavy = {"params": st["params"], "m": st["opt"]["m"],
                     "v": st["opt"]["v"]}
            full = {"params": tree0["params"], "m": tree0["opt"]["m"],
                    "v": tree0["opt"]["v"]}
            checks["memory"] = [SS.per_device_bytes(heavy),
                                SS.per_device_bytes(full)]
    checks.update(_props(mesh))
    return res, checks


def battery_rn50(mesh, out, inp):
    from repro_torch import checkpoint as CK
    from repro_torch.configs import get_arch
    from repro_torch.core import train_step as TS
    from repro_torch.core.schedules import lr_warmup_cosine
    kw, batches = _setup("v3", narrow_rn50(get_arch), n_shards=2, steps=1)
    kw["lr_fn"] = lr_warmup_cosine(1e-3, 0, 10)    # the step moves params
    tc = TS.TrainStepConfig(**kw, mesh_axes=AXES, fsdp=True)
    st0 = TS.init_train_state(torch.Generator().manual_seed(1),
                              TS.TrainStepConfig(**kw), "cpu")
    tree0 = CK.unflatten({k: v.clone() for k, v in flatten(
        bridge.state_to_tree(st0)).items()})
    step_sh = TS.make_train_step(tc)
    dims = step_sh.param_dims
    st_sh, loss_sh, _ = _run3(step_sh, SS.shard_train_state(tree0, mesh),
                              _local(batches, mesh))
    full_sh = _flat_np(SS.gather_train_state(st_sh, mesh, dims))
    st_1, loss_1, _ = _run3(TS.make_train_step(TS.TrainStepConfig(**kw),
                                               "cpu"), st0, batches)
    full_1 = _flat_np(bridge.state_to_tree(st_1))
    start = _flat_np(tree0)
    checks = {
        "dloss": max(abs(a - b) for a, b in zip(loss_sh, loss_1)),
        "dparam": _maxdiff(full_sh, full_1, "params/"),
        "dlogu": max(_maxdiff(full_sh, full_1, "fc/u1"),
                     _maxdiff(full_sh, full_1, "fc/u2")),
        # the first moments: (1 - beta1) x the reduced gradients
        "moment_rel_l2": max(
            float(np.linalg.norm(full_sh[k] - full_1[k])
                  / max(np.linalg.norm(full_1[k]), 1e-30))
            for k in full_1 if k.startswith("opt/m/")),
        "same_keys": sorted(full_sh) == sorted(full_1),
        "params_unmoved": sorted(
            k for k in full_1 if k.startswith("params/")
            and np.array_equal(full_1[k], start[k])),
        "sharded_conv_leaves": sorted(
            k for k, d in dims.items() if d is not None
            and k.startswith("vision/stage"))}
    return {}, checks


# (arch, reduced depth): the dense stack at 12 layers runs JAX's grouped
# recompute (2 groups of 6); the hybrid at 3 layers one super-block, its
# shared block and a tail layer
LM_ARCHS = {"qwen3-1.7b": 12, "zamba2-1.2b": 3}
# the MoE LMs: qwen3-moe at 12 super-blocks (2 groups of 6), llama4-scout
# at 2 (a dense block and an MoE block each, recomputed one by one)
MOE_ARCHS = {"qwen3-moe-30b-a3b": 12, "llama4-scout-17b-a16e": 4}
# the xLSTM at 8 layers: two units of mmms, both block kinds
XLSTM_ARCHS = {"xlstm-125m": 8}
LM_SEQ, LM_BATCH, LM_SAMPLES = 16, 8, 16


def lm_cfg(get_arch, arch):
    """A reduced LM backbone of ``LM_ARCHS`` or ``MOE_ARCHS`` from either
    package's ``get_arch``."""
    depth = {**LM_ARCHS, **MOE_ARCHS, **XLSTM_ARCHS}[arch]
    return get_arch(arch).reduced().replace(n_layers=depth)


def _groups(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            out.setdefault(k[len(prefix):].split("/")[0], []).append(
                np.asarray(v, np.float64).ravel())
    return {g: np.concatenate(v) for g, v in out.items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def battery_lm(mesh, out, inp, archs=LM_ARCHS):
    from repro_torch import checkpoint as CK
    from repro_torch.configs import get_arch
    from repro_torch.core import fastclip as FC
    from repro_torch.core import train_step as TS
    from repro_torch.core.schedules import lr_warmup_cosine
    from repro_torch.data import PairedEmbeddingDataset, ShardedLoader
    from repro_torch.optim import adamw
    backward_calls = [0]
    orig = SS._GatherParam.backward

    def counted(ctx, g):
        backward_calls[0] += 1
        return orig(ctx, g)
    SS._GatherParam.backward = staticmethod(counted)
    res, checks = {}, {}
    for arch in archs:
        cfg = lm_cfg(get_arch, arch)
        fc = FC.FastCLIPConfig(version="v3", n_samples=LM_SAMPLES,
                               steps_per_epoch=LM_SAMPLES // LM_BATCH,
                               gamma_decay_epochs=1, loss_impl="fused")
        kw = dict(arch=cfg, fc=fc, optimizer=adamw(),
                  lr_fn=lr_warmup_cosine(1e-3, 0, 10), wd=0.1,
                  impl="flash")
        ds = PairedEmbeddingDataset(n=LM_SAMPLES, seq_len=LM_SEQ,
                                    vocab_size=cfg.vocab_size)
        batches = [(torch.from_numpy(idx),
                    {k: torch.from_numpy(v) for k, v in b.items()})
                   for _, _, idx, b in ShardedLoader(
                       ds, global_batch=LM_BATCH, n_shards=2).steps(2)]
        st0 = TS.init_train_state(torch.Generator().manual_seed(1),
                                  TS.TrainStepConfig(**kw), "cpu")
        tree0 = CK.unflatten({k: v.clone() for k, v in flatten(
            bridge.state_to_tree(st0)).items()})
        step_sh = TS.make_train_step(TS.TrainStepConfig(
            **kw, mesh_axes=AXES, fsdp=True))
        dims = step_sh.param_dims
        half = LM_BATCH // 2
        local = [(idx[mesh.rank * half:(mesh.rank + 1) * half],
                  {k: v[mesh.rank * half:(mesh.rank + 1) * half]
                   for k, v in b.items()}) for idx, b in batches]
        backward_calls[0] = 0
        st_sh, loss_sh, _ = _run3(step_sh, SS.shard_train_state(
            tree0, mesh), local)
        n_backward = backward_calls[0]
        full_sh = _flat_np(SS.gather_train_state(st_sh, mesh, dims))
        CK.save_sharded(os.path.join(out, f"lm_ckpt_{arch}"), st_sh, 2,
                        mesh, dims, metadata={"arch": arch, "version": "v3"})
        st_1, loss_1, _ = _run3(TS.make_train_step(
            TS.TrainStepConfig(**kw), "cpu"), st0, batches)
        full_1 = _flat_np(bridge.state_to_tree(st_1))
        start = _flat_np(tree0)
        moments = {f"{mom}/{g}": _rel_l2(a, _groups(full_1, f"opt/{mom}/")[g])
                   for mom in ("m", "v")
                   for g, a in _groups(full_sh, f"opt/{mom}/").items()}
        p0 = _groups(start, "params/")
        d_sh = {g: p0[g] - a for g, a in _groups(full_sh, "params/").items()}
        d_1 = {g: p0[g] - a for g, a in _groups(full_1, "params/").items()}
        sharded = [k for k, d in dims.items() if d is not None]
        checks[arch] = {
            "losses": [loss_sh, loss_1],
            "dloss": max(abs(a - b) for a, b in zip(loss_sh, loss_1)),
            "dlogu": max(_maxdiff(full_sh, full_1, "fc/u1"),
                         _maxdiff(full_sh, full_1, "fc/u2")),
            "moment_rel_l2": moments,
            "update_rel_l2": {g: _rel_l2(d_sh[g], d_1[g]) for g in d_1},
            "same_keys": sorted(full_sh) == sorted(full_1),
            "params_unmoved": sorted(g for g in d_1 if not np.any(d_1[g])),
            # the towers do not reach an untied lm_head: zero moments on
            # both sides, and AdamW's decay alone moves it
            "zero_moment_leaves": sorted(
                k[len("opt/m/"):] for k in full_sh
                if k.startswith("opt/m/") and not np.any(full_sh[k])),
            "sharded_leaves": sorted(sharded),
            "gather_backward_calls": n_backward,
            "dims": dims}
        res.update({f"{arch}/{k}": v for k, v in full_sh.items()})
    SS._GatherParam.backward = staticmethod(orig)
    return res, checks


def battery_moe(mesh, out, inp):
    return battery_lm(mesh, out, inp, MOE_ARCHS)


def battery_xlstm(mesh, out, inp):
    return battery_lm(mesh, out, inp, XLSTM_ARCHS)


def _props(mesh):
    """Exact (integer-valued) trees: reduce-scatter then all-gather over
    fsdp equals the all-reduce over fsdp, and the staged (fsdp, then
    data) all-reduce equals one flat all-reduce over the whole group,
    bit for bit.  Every rank draws the same examples (derandomised)."""
    try:
        from hypothesis import HealthCheck, given, settings
        from hypothesis import strategies as st
    except ImportError:
        return {"props": "no-hypothesis"}
    import torch.distributed as dist
    seen = []
    leaf = st.lists(st.integers(min_value=-1000, max_value=1000),
                    min_size=4, max_size=16)

    @settings(max_examples=25, deadline=None, derandomize=True,
              database=None, suppress_health_check=list(HealthCheck))
    @given(st.lists(leaf, min_size=1, max_size=4), st.integers(0, 3))
    def prop(rows, pad):
        for r in rows:
            # every rank its own summands, the same on every run
            x = torch.from_numpy(np.resize(np.asarray(r, np.float32),
                                           (4, len(r) + pad))) * (
                mesh.rank + 1)
            scat = SS.all_gather_dim(SS.reduce_scatter_dim(x, "fsdp", 0),
                                     "fsdp", 0)
            summed = SS.psum(x, ("fsdp",))
            assert scat.numpy().tobytes() == summed.numpy().tobytes()
            flat = x.clone()
            dist.all_reduce(flat)
            assert SS.staged_psum(x).numpy().tobytes() == \
                flat.numpy().tobytes()
        seen.append(len(rows))

    prop()
    return {"props": len(seen)}


# ---------------------------------------------------------------------------
# ckpt
# ---------------------------------------------------------------------------

def battery_ckpt(mesh, out, inp):
    from repro_torch import checkpoint as CK
    ref = dict(np.load(os.path.join(inp, "ref.npz")))
    like = CK.unflatten({k: v for k, v in ref.items()})
    tree, step, meta = CK.restore(inp, like)
    restored_bitwise = all(tree_v.tobytes() == ref[k].tobytes()
                           for k, tree_v in flatten(tree).items())
    params_like = {k[len("params/"):]: v for k, v in ref.items()
                   if k.startswith("params/")}
    dims = SS.param_fsdp_dims(params_like, mesh.fsdp)
    st = SS.shard_train_state(tree, mesh, dims)
    lays = SS.leaf_layouts(CK.unflatten(ref), mesh.fsdp, dims)
    ok = True
    for k, v in flatten(st).items():
        want = torch.from_numpy(ref[k])
        lay = lays[k]
        if lay is not None and lay[0] == "fsdp":
            n = want.shape[lay[1]] // mesh.fsdp
            want = want.narrow(lay[1], mesh.axis_index("fsdp") * n, n)
        elif lay is not None:
            n = want.shape[0] // mesh.world_size
            want = want[mesh.rank * n:(mesh.rank + 1) * n]
        ok &= v.numpy().tobytes() == want.contiguous().numpy().tobytes()
    ok = bool(SS.psum(torch.tensor([float(ok)]), AXES).item()
              == mesh.world_size)
    CK.save_sharded(os.path.join(out, "port_ckpt"), st, step, mesh, dims,
                    metadata=meta)
    return {}, {"restored_bitwise": restored_bitwise, "step": step,
                "shards_bitwise_all_ranks": ok,
                "sharded_leaves": sum(d is not None for d in dims.values())}


# ---------------------------------------------------------------------------
# eval (tests/helpers/eval_check.py at K = 4)
# ---------------------------------------------------------------------------

def quantized_emb(n, d, seed):
    """Entries in multiples of 1/64: every f32 dot is exact in any
    summation order."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy((np.round(rng.randn(n, d) * 16) / 64.0)
                            .astype(np.float32))


def battery_eval(mesh, out, inp):
    from repro_torch.data import ZeroShotEvalDataset
    from repro_torch.eval import engine as EN
    from repro_torch.eval import metrics as M
    from repro_torch.eval import planted as PL
    from repro_torch.eval import retrieval as RT
    checks = {}
    N, d, k = 64, 32, 10
    e1 = quantized_emb(N, d, 0)
    e2 = quantized_emb(N, d, 1)
    e2[4:8] = e2[0:4]               # exact ties on the column side
    (s1, i1), (s2, i2) = RT.sharded_retrieval_topk(mesh, AXES, e1, e2, k,
                                                   chunk=24)
    dense1 = M.lex_topk(e1 @ e2.T, k)
    dense2 = M.lex_topk(e2 @ e1.T, k)
    checks["topk_exact"] = all(
        torch.equal(ii, di) and ss.numpy().tobytes() == ds.numpy().tobytes()
        for (ss, ii), (ds, di) in (((s1, i1), dense1), ((s2, i2), dense2)))
    for C, m, flip in ((4, 4, 0.0), (5, 3, 0.0), (6, 4, 0.25)):
        ds = ZeroShotEvalDataset(n_classes=C, n_per_class=m,
                                 label_flip_frac=flip, seed=2)
        params = PL.planted_params(ds, device="cpu")
        got = EN.evaluate_planted(params, ds, chunk=8, device="cpu",
                                  mesh=mesh, axes=AXES)
        single = EN.evaluate_planted(params, ds, chunk=8, device="cpu")
        want = PL.known_answers(ds)
        checks[f"planted/{C}x{m}/{flip}"] = [got, single, want]
    return {}, checks


# ---------------------------------------------------------------------------
# cuda (two ranks sharing one card, gloo)
# ---------------------------------------------------------------------------

def battery_cuda(mesh, out, inp):
    """The three collectives on CUDA tensors and the backward of both
    differentiable gathers, against the values they must produce."""
    dev = mesh.device
    r, n = mesh.rank, mesh.world_size
    checks = {"device": str(dev), "backend": mesh.backend}

    def mine(k):
        g = torch.Generator().manual_seed(100 + k)
        return torch.randn((6, 4), generator=g).to(dev)
    xs = [mine(k) for k in range(n)]
    x = xs[r]
    got = SS.all_gather_dim(x, "fsdp", 1)
    checks["all_gather"] = got.is_cuda and torch.equal(got,
                                                       torch.cat(xs, 1))
    got = SS.reduce_scatter_dim(x, "fsdp", 0)
    total = sum(xs[1:], xs[0])
    checks["reduce_scatter"] = got.is_cuda and torch.allclose(
        got, total.chunk(n, 0)[r], rtol=0, atol=1e-6)
    got = SS.psum(x, AXES)
    checks["all_reduce"] = got.is_cuda and torch.allclose(
        got, total, rtol=0, atol=1e-6)
    # d/dx of sum(c_k * gather(x)) over ranks k: sum_k c_k's own block
    cs = [mine(10 + k).repeat(1, n) for k in range(n)]
    w = x.clone().requires_grad_(True)
    full = SS.gather_params({"w": w}, {"w": 1})["w"]
    (g,) = torch.autograd.grad((full * cs[r]).sum(), (w,))
    want = sum(c.chunk(n, 1)[r] for c in cs)
    checks["gather_params_backward"] = g.is_cuda and torch.allclose(
        g, want, rtol=0, atol=1e-6)
    cs = [mine(20 + k).repeat(n, 1) for k in range(n)]
    e = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        (DI._GatherAxes.apply(e, AXES) * cs[r]).sum(), (e,))
    want = sum(c.chunk(n, 0)[r] for c in cs)
    checks["gather_axes_backward"] = g.is_cuda and torch.allclose(
        g, want, rtol=0, atol=1e-6)
    ok = torch.tensor([float(all(v for k, v in checks.items()
                                 if k not in ("device", "backend")))],
                      device=dev)
    checks["all_ranks"] = SS.psum(ok, AXES).item() == n
    return {}, checks


BATTERIES = {"loss": battery_loss, "step": battery_step,
             "ckpt": battery_ckpt, "eval": battery_eval,
             "cuda": battery_cuda, "rn50": battery_rn50,
             "lm": battery_lm, "moe": battery_moe,
             "xlstm": battery_xlstm}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("battery", choices=sorted(BATTERIES))
    ap.add_argument("out")
    ap.add_argument("inp", nargs="?", default="")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dev = MP.initialize(args.coordinator, args.num_processes,
                        args.process_id,
                        "cuda" if args.battery == "cuda" else "cpu")
    try:
        shape = {"ckpt": (1, 4), "cuda": (1, args.num_processes),
                 "rn50": (1, 2), "lm": (1, 2),
                 "moe": (1, 2), "xlstm": (1, 2)}.get(args.battery, (2, 2))
        mesh = MS.make_train_mesh(*shape, device=dev)
        res, checks = BATTERIES[args.battery](mesh, args.out, args.inp)
        if mesh.rank == 0:
            np.savez(os.path.join(args.out, f"{args.battery}.npz"), **res)
            with open(os.path.join(args.out, f"{args.battery}.json"),
                      "w") as f:
                json.dump(checks, f)
    finally:
        MP.shutdown()


if __name__ == "__main__":
    main()
