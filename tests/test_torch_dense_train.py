"""Training the port's dense LMs on the CPU against the JAX package, and
the contrastive objective of an LM backbone on the (data, fsdp) mesh.
The models are reduced configs; one set of params (the JAX init, through
the bridge, with the qk-norm scales and the QKV biases drawn at random
so that both count) and the same numpy-seeded batches go through both
packages:

  * ``layers.default_remat_group`` equal to JAX's for 1..70 layers;
  * the grouped recompute of ``forward_hidden`` (reduced qwen3-1.7b at
    9, 10, 12 and 16 layers: groups of 3, 5, 6 and 8; at 8 layers: JAX's
    per-layer fall-back): gradients bitwise equal to those without it,
    the recomputed segments and the attention calls they add counted;
  * ``lm_loss`` and ``jax.grad`` of JAX's for reduced qwen3-1.7b (tied,
    qk-norm) and reduced qwen1.5-32b (untied head, QKV bias), the port at
    ``impl`` flash (the kernel wrapper's plain version here) and chunked,
    JAX at its default (chunked): the loss rtol 1e-5, every leaf's
    gradient within 1e-4 relative L2 (the bounds of
    tests/test_torch_lm.py); a leaf the objective does not reach has a
    zero gradient on both sides;
  * two steps of ``launch.steps.make_lm_train_step`` and two FastCLIP v3
    steps of ``core.train_step.make_train_step`` against JAX's: losses
    rtol 1e-5; per group of leaves, AdamW's moments (1e-4) and the update
    divided by lr (1e-3) by relative L2 (tests/test_torch_lm.py's bounds
    and reasons); leaves with a zero gradient keep zero moments and are
    still moved by the decoupled decay;
  * the launcher at ``--reduced --device cpu --guard`` for every dense
    arch under both objectives for 2 steps, ``--resume`` from step 1
    bitwise equal to the uninterrupted run, and its checkpoint read
    bitwise by JAX's ``restore``;
  * P6a': ``data:1,fsdp:2`` (2 gloo ranks, tests/helpers/
    torch_mesh_check.py's ``lm`` battery) for reduced qwen3-1.7b and
    zamba2-1.2b against the single-device steps at
    tests/helpers/fsdp_check.py's bounds (loss 1e-5, log-u 1e-4), the
    moments per group 1e-4 and the updates per group 1e-3 as above; each
    gather's backward once per reached leaf and step; the sharded
    checkpoint restored on one device bitwise; ``param_fsdp_dims``
    against JAX's at the full-width shapes.
"""
import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.core import fastclip as JFC
from repro.core import shard_state as JSS
from repro.core import train_step as JTS
from repro.launch import steps as JST
from repro.models import backbones as JBB
from repro.models import layers as JL
from repro.optim import adamw as j_adamw
from repro_torch import checkpoint as TCK
from repro_torch.checkpoint import bridge, flatten, unflatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import fastclip as TFC
from repro_torch.core import shard_state as SS
from repro_torch.core import train_step as TTS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import LMDataset as TLD
from repro_torch.data import PairedEmbeddingDataset as TPD
from repro_torch.data import ShardedLoader as TSL
from repro_torch.launch import steps as TST
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as TA
from repro_torch.models import backbones as TBB
from repro_torch.models import layers as TL
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_mesh_check as H  # noqa: E402

ARCHS = ["qwen3-1.7b", "yi-6b", "granite-3-8b", "qwen1.5-32b"]
B, S, N = 2, 32, 16
GB = 4                      # the contrastive steps' global batch
LR, TOTAL = 0.5, 10
# the bounds of tests/test_torch_lm.py (their reasons there)
LOSS_RTOL, GRAD_TOL, MOMENT_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (and in its
    subprocesses): the CPU matmuls' bits depend on the thread count, and
    the suite's workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(state):
    """Owned numpy copies (the model's parameters change in place)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in flatten(
        bridge.state_to_tree(state)).items()}


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _groups(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            out.setdefault(k[len(prefix):].split("/")[0], []).append(
                np.asarray(v, np.float64).ravel())
    return {g: np.concatenate(v) for g, v in out.items()}


def _perturb(params, seed):
    """Non-unit qk-norm scales and non-zero QKV biases (JAX's init sets
    ones and zeros, which would hide both)."""
    rng = np.random.default_rng(seed)

    def one(path, v):
        name = _path_str(path)
        if name.endswith(("q_norm/scale", "k_norm/scale")):
            return v * (1.0 + 0.5 * rng.standard_normal(v.shape,
                                                         dtype=np.float32))
        if name.endswith(("attn/bq", "attn/bk", "attn/bv")):
            return v + 0.1 * rng.standard_normal(v.shape, dtype=np.float32)
        return v
    return jax.tree_util.tree_map_with_path(one, params)


def _fc(mod, loss_impl="dense"):
    return mod.FastCLIPConfig(version="v3", n_samples=N,
                              steps_per_epoch=N // GB, gamma_decay_epochs=1,
                              loss_impl=loss_impl)


# ---------------------------------------------------------------------------
# The grouped recompute
# ---------------------------------------------------------------------------

def test_default_remat_group_equals_jax():
    got = [TL.default_remat_group(n) for n in range(1, 71)]
    assert got == [JL.default_remat_group(n) for n in range(1, 71)]
    assert TL.default_remat_group(28) == 4     # qwen3-1.7b: 7 groups
    assert TL.default_remat_group(64) == 8     # qwen1.5-32b


def _loss_grads(model, cfg, batch, impl="flash"):
    with torch.enable_grad():
        loss, _ = TBB.lm_loss(model, cfg, batch, impl=impl)
        return loss, TTS.param_grads(loss, model)


@pytest.mark.parametrize("n_layers,segments", [
    (9, 3),      # groups of 3
    (10, 2),     # groups of 5
    (12, 2),     # groups of 6
    (16, 2),     # groups of 8
    (8, 8),      # group 8 of 8 layers: JAX's per-layer fall-back
])
def test_grouped_recompute_is_bitwise_and_counted(n_layers, segments,
                                                  monkeypatch):
    """Each recomputed segment (a group, or a layer in the fall-back) is
    one checkpoint; every layer's attention runs once forward and once
    in its segment's recompute."""
    cfg = t_get_arch("qwen3-1.7b").reduced().replace(n_layers=n_layers)
    model = TBB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ds = TLD(n=N, seq_len=S, vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch([0, 1]).items()}
    calls, checkpoints = [0], [0]
    orig, orig_ckpt = TA.flash_mha, TBB.checkpoint

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    def counted_ckpt(*a, **k):
        checkpoints[0] += 1
        return orig_ckpt(*a, **k)
    monkeypatch.setattr(TA, "flash_mha", counted)
    monkeypatch.setattr(TBB, "checkpoint", counted_ckpt)
    loss, grads = _loss_grads(model, cfg, batch)
    assert (checkpoints[0], calls[0]) == (segments, 2 * n_layers)
    with monkeypatch.context() as m:      # the recompute, bypassed
        m.setattr(TBB, "checkpoint", lambda fn, *a, **k: fn(*a))
        calls[0] = 0
        loss0, grads0 = _loss_grads(model, cfg, batch)
        assert calls[0] == n_layers
    assert loss.item() == loss0.item()
    _bitwise({k: v.numpy() for k, v in grads.items()},
             {k: v.numpy() for k, v in grads0.items()})
    calls[0] = 0                        # no grad: nothing recomputed
    TST.make_prefill_step(cfg)(model, {"tokens": batch["tokens"]})
    assert calls[0] == n_layers


# ---------------------------------------------------------------------------
# The loss, the LM steps and the contrastive steps against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen3-1.7b", "qwen1.5-32b"])
def ref(request):
    """The JAX side, once per arch: the (perturbed) init, the LM loss and
    its gradients, two jitted LM steps and two jitted v3 steps."""
    arch = request.param
    jcfg, tcfg = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    params = _perturb(JBB.init_params(jax.random.PRNGKey(0), jcfg), 1)
    lm_batches = [TLD(n=N, seq_len=S, vocab_size=tcfg.vocab_size).batch(
        np.arange(B * i, B * (i + 1))) for i in range(2)]
    jb0 = {k: jnp.asarray(v) for k, v in lm_batches[0].items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JBB.lm_loss(p, jcfg, jb0), has_aux=True))(params)
    step_fn, opt = JST.make_lm_train_step(jcfg, lr=LR, wd=0.1,
                                          total_steps=TOTAL)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(step_fn)
    lm_states, lm_losses = [jax_flat(state)], []
    for b in lm_batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        lm_states.append(jax_flat(state))
        lm_losses.append(float(m["loss"]))
    kw = dict(n=N, seq_len=S, vocab_size=tcfg.vocab_size)
    ctr_data = [(idx, b) for _, _, idx, b in TSL(
        TPD(**kw), global_batch=GB, seed=3).steps(2)]
    cstep, jtc = JST.make_contrastive_train_step(
        jcfg, _fc(JFC), lr=LR, wd=0.1, total_steps=TOTAL)
    cstate = JTS.init_train_state(jax.random.PRNGKey(0), jtc)
    cstate = dict(cstate, params=params)
    jcstep = jax.jit(cstep)
    ctr_states, ctr_metrics = [jax_flat(cstate)], []
    for idx, b in ctr_data:
        cstate, m = jcstep(cstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(idx))
        ctr_states.append(jax_flat(cstate))
        ctr_metrics.append({k: float(v) for k, v in m.items()})
    return dict(arch=arch, tcfg=tcfg, params=jax_flat(params),
                loss=float(loss), grads=jax_flat(grads),
                lm_batches=lm_batches, lm_states=lm_states,
                lm_losses=lm_losses, ctr_data=ctr_data,
                ctr_states=ctr_states, ctr_metrics=ctr_metrics)


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_lm_loss_and_gradients_match_jax(ref, impl):
    tcfg = ref["tcfg"]
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
    assert hasattr(model, "lm_head") == (not tcfg.tie_embeddings)
    batch = {k: torch.from_numpy(v) for k, v in ref["lm_batches"][0].items()}
    loss, grads = _loss_grads(model, tcfg, batch, impl)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    grads = {k: v.numpy() for k, v in flatten(
        bridge.named_to_tree(model, grads)).items()}
    assert sorted(grads) == sorted(ref["grads"])
    unreached = sorted(k for k, w in ref["grads"].items() if not np.any(w))
    assert unreached == ["ctr_proj", "pair_proj"]
    for k, w in ref["grads"].items():
        if k in unreached:
            assert not np.any(grads[k]), k
            continue
        assert _rel_l2(grads[k], w) <= GRAD_TOL, (k, _rel_l2(grads[k], w))


def _check_step(before, after, want_before, want, lr, zero_grad):
    """AdamW's moments and the update / lr per group of leaves against
    JAX's; ``zero_grad``: the groups with a zero gradient (zero moments,
    moved by the decay alone)."""
    assert sorted(after) == sorted(want)
    for mom in ("m", "v"):
        g_got = _groups(after, f"opt/{mom}/")
        g_want = _groups(want, f"opt/{mom}/")
        for g in g_want:
            if g in zero_grad:
                assert not np.any(g_want[g]) and not np.any(g_got[g]), g
                continue
            assert _rel_l2(g_got[g], g_want[g]) <= MOMENT_TOL, (
                mom, g, _rel_l2(g_got[g], g_want[g]))
    if lr == 0:
        return
    p0, p1 = _groups(before, "params/"), _groups(after, "params/")
    q0, q1 = _groups(want_before, "params/"), _groups(want, "params/")
    for g in q1:
        if g in zero_grad:      # decoupled decay alone: p (1 - lr wd)
            assert np.any(p1[g] != p0[g]), g
            for a in (p1[g], q1[g]):
                np.testing.assert_allclose(a, q0[g] * (1 - lr * 0.1),
                                           rtol=1e-6, err_msg=g)
            continue
        u_got, u_want = (p0[g] - p1[g]) / lr, (q0[g] - q1[g]) / lr
        assert np.any(u_want), g            # the step moved the params
        assert _rel_l2(u_got, u_want) <= UPDATE_TOL, (
            g, _rel_l2(u_got, u_want))


def test_two_lm_steps_match_jax(ref):
    tcfg = ref["tcfg"]
    step, opt = TST.make_lm_train_step(tcfg, lr=LR, wd=0.1,
                                       total_steps=TOTAL, device="cpu")
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
    state = {"params": model,
             "opt": opt.init({k: p.detach()
                              for k, p in model.named_parameters()}),
             "step": torch.zeros((), dtype=torch.int32)}
    before = port_flat(state)
    _bitwise(before, ref["lm_states"][0])
    for i, b in enumerate(ref["lm_batches"]):
        state, m = step(state, b)
        np.testing.assert_allclose(m["loss"].item(), ref["lm_losses"][i],
                                   rtol=LOSS_RTOL)
        after = port_flat(state)
        _check_step(before, after, ref["lm_states"][i],
                    ref["lm_states"][i + 1], [0.0, LR / 500][i],
                    ("ctr_proj", "pair_proj"))
        before = after


def test_two_contrastive_steps_match_jax(ref):
    tcfg = ref["tcfg"]
    ttc = TTS.TrainStepConfig(arch=tcfg, fc=_fc(TFC, "fused"),
                              optimizer=adamw(),
                              lr_fn=lr_warmup_cosine(LR, 500, TOTAL), wd=0.1)
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), ttc, "cpu")
    state = bridge.state_from_tree(ts, unflatten(ref["ctr_states"][0]))
    step = TTS.make_train_step(ttc, "cpu")
    before = port_flat(state)
    _bitwise(before, ref["ctr_states"][0])
    zero = ("lm_head",) if not tcfg.tie_embeddings else ()
    for i, (idx, b) in enumerate(ref["ctr_data"]):
        state, m = step(state, b, idx)
        jm = ref["ctr_metrics"][i]
        for k in ("loss", "loss_value", "tau", "u_mean"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        after = port_flat(state)
        want = ref["ctr_states"][i + 1]
        for u in ("fc/u1", "fc/u2"):
            fin = np.isfinite(want[u])
            assert np.array_equal(fin, np.isfinite(after[u])), u
            np.testing.assert_allclose(after[u][fin], want[u][fin],
                                       rtol=1e-5, atol=1e-5, err_msg=u)
        _check_step(before, after, ref["ctr_states"][i], want,
                    [0.0, LR / 500][i], zero)
        before = after


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = ttrain.main(argv)
    return state, buf.getvalue()


def _jax_like(arch, objective):
    """Zeros in the structure of JAX's train state for the launcher's
    run at ``--reduced``."""
    jcfg = j_get_arch(arch).reduced()
    params = jax.eval_shape(lambda: JBB.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    if objective == "lm":
        tree = {"params": params, "opt": jax.eval_shape(
            j_adamw().init, params), "step": jnp.zeros((), jnp.int32)}
    else:
        fc = JFC.FastCLIPConfig(version="v3", n_samples=8)
        tc = JTS.TrainStepConfig(arch=jcfg, fc=fc, optimizer=j_adamw(),
                                 lr_fn=lambda s: 0.0)
        tree = jax.eval_shape(lambda: JTS.init_train_state(
            jax.random.PRNGKey(0), tc))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)


@pytest.mark.parametrize("objective", ["lm", "contrastive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_resumes_and_jax_reads_it(arch, objective,
                                                  tmp_path):
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
            "--log-every", "1", "--objective", objective, "--seq-len", "16",
            "--global-batch", "2", "--n-samples", "8", "--lr", "0.5",
            "--guard"]
    ck = str(tmp_path / "ck")
    state, out = _launch(args + ["--ckpt-dir", ck, "--ckpt-every", "1"])
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2
    keys = sorted(json.loads(lines[0][lines[0].index("{"):]))
    # the guard's metrics on the contrastive step (the LM step has none)
    assert keys == (["ce", "loss"] if objective == "lm" else
                    ["gamma", "grad_norm", "loss", "loss_value", "lr",
                     "nonfinite_rate", "sat_rate", "skipped", "tau",
                     "u_mean"])
    assert ("retrieval accuracy: " in out) == (objective == "contrastive")
    assert isinstance(state["params"], TBB.DenseLM)
    oracle = port_flat(state)
    # JAX's reader restores the step-2 checkpoint bitwise
    got, step, meta = JCK.restore(ck, _jax_like(arch, objective))
    assert step == 2 and meta["arch"] == arch
    _bitwise(jax_flat(got), oracle)
    # --resume from step 1 reruns step 1 bitwise
    for name in os.listdir(ck):
        if "00000002" in name:
            os.remove(os.path.join(ck, name))
    assert TCK.latest_step(ck) == 1
    state, out = _launch(args + ["--ckpt-dir", ck, "--resume"])
    assert "resumed from step 1" in out
    _bitwise(port_flat(state), oracle)


# ---------------------------------------------------------------------------
# P6a': the contrastive objective of an LM backbone on the mesh
# ---------------------------------------------------------------------------

def _lead_axes(path):
    """The leading layer axes of a stacked leaf: ``supers/mambas/...``
    (super-block, layer), ``blocks/...`` and ``tail/...`` (layer)."""
    return {"supers": 2, "blocks": 1, "tail": 1}.get(path.split("/")[0], 0)


@pytest.fixture(scope="module")
def lm_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_mesh")
    ranks = H.spawn("lm", out, nproc=2, timeout=240)
    assert [r.returncode for r in ranks] == [0] * 2, ranks[0].stderr[-3000:]
    with open(out / "lm.json") as f:
        checks = json.load(f)
    return out, checks, dict(np.load(out / "lm.npz"))


@pytest.mark.parametrize("arch", sorted(H.LM_ARCHS))
def test_lm_backbone_mesh_step_equals_single_device(lm_mesh, arch):
    c = lm_mesh[1][arch]
    assert c["same_keys"] and c["params_unmoved"] == []
    assert c["dloss"] < 1e-5
    assert c["dlogu"] < 1e-4
    assert max(c["moment_rel_l2"].values()) <= MOMENT_TOL, c[
        "moment_rel_l2"]
    assert max(c["update_rel_l2"].values()) <= UPDATE_TOL, c[
        "update_rel_l2"]
    untied = arch == "zamba2-1.2b"
    assert c["zero_moment_leaves"] == (["lm_head"] if untied else [])
    # the stacks' weight matrices shard a trailing dim, never a leading
    # layer axis (test_param_fsdp_dims_equal_jax_at_full_width)
    shapes = flatten(TBB.param_shapes(H.lm_cfg(t_get_arch, arch)))
    for path in c["sharded_leaves"]:
        n = _lead_axes(path)
        assert c["dims"][path] >= n or shapes[path].ndim - n < 2, path
    # each gather's backward once per step for every leaf the towers
    # reach, whatever the recompute (lm_head's never runs)
    reached = len(c["sharded_leaves"]) - untied
    assert c["gather_backward_calls"] == 2 * reached


@pytest.mark.parametrize("arch", sorted(H.LM_ARCHS))
def test_lm_backbone_sharded_checkpoint_restores_on_one_device(lm_mesh,
                                                               arch):
    """The fsdp-2 checkpoint, merged on one device (fsdp 1) into the
    single-device state, bitwise equal to the gathered mesh state."""
    out, _, res = lm_mesh
    cfg = H.lm_cfg(t_get_arch, arch)
    fc = _fc(TFC, "fused")
    tc = TTS.TrainStepConfig(arch=cfg, fc=dataclasses.replace(
        fc, n_samples=H.LM_SAMPLES), optimizer=adamw(),
        lr_fn=lr_warmup_cosine(1e-3, 0, 10))
    state = TTS.init_train_state(torch.Generator().manual_seed(5), tc, "cpu")
    got, step, meta = TCK.restore(str(out / f"lm_ckpt_{arch}"),
                                  bridge.state_to_tree(state))
    assert step == 2 and meta == {"arch": arch, "version": "v3"}
    state = bridge.state_from_tree(state, got)
    want = {k[len(arch) + 1:]: v for k, v in res.items()
            if k.startswith(arch + "/")}
    _bitwise(port_flat(state), want)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-1.7b"])
@pytest.mark.parametrize("size", [2, 4])
def test_param_fsdp_dims_equal_jax_at_full_width(arch, size):
    jshapes = jax.eval_shape(lambda: JBB.init_params(jax.random.PRNGKey(0),
                                                     j_get_arch(arch)))
    want = {_path_str(p): d for p, d in jax.tree_util.tree_flatten_with_path(
        JSS.param_fsdp_dims(jshapes, size),
        is_leaf=lambda d: d is None)[0]}
    got = SS.param_fsdp_dims(TBB.param_shapes(t_get_arch(arch)), size)
    assert got == want
    # a weight matrix of a stack shards a trailing dim, never a leading
    # layer axis (JAX's rule picks a layer axis only for a stack of
    # vectors, such as supers/mambas/conv_b: its -2)
    shapes = flatten(TBB.param_shapes(t_get_arch(arch)))
    for path, d in got.items():
        n = _lead_axes(path)
        assert d is None or d >= n or shapes[path].ndim - n < 2, (path, d)
