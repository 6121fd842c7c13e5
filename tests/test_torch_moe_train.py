"""Training the port's MoE LMs (``qwen3-moe-30b-a3b``: 128 experts top-8
in every layer; ``llama4-scout-17b-a16e``: 16 experts top-1 and a shared
expert every other layer) on the CPU against the JAX package, and their
contrastive objective on the (data, fsdp) mesh.  The models are reduced
configs; one set of params (the JAX init, through the bridge, with the
qk-norm scales drawn at random so that they count) and the same
numpy-seeded batches go through both packages:

  * the dispatch's backward (``models.moe.dispatch_backward``) bitwise
    equal to a numpy sum over the experts in ascending order, and within
    f32 rounding of autograd through the plain gather; one MoE layer's
    gradients against ``jax.grad`` of JAX's ``apply_moe`` (1e-4 relative
    L2 per leaf); the forward under grad bitwise the serving forward;
  * the grouped recompute of ``forward_hidden`` (reduced qwen3-moe at 12
    super-blocks: JAX's rule gives 2 groups of 6; reduced llama4-scout at
    2 super-blocks: the per-block fall-back): gradients bitwise equal to
    those without it, each recompute routing as its forward did, the
    recomputed segments and the attention calls they add counted;
  * ``lm_loss`` and ``jax.value_and_grad`` of JAX's, the port at ``impl``
    flash (the kernel wrapper's plain version here) and chunked: the
    loss rtol 1e-5, every leaf's gradient within 1e-4 relative L2 (the
    bounds of tests/test_torch_dense_train.py);
  * two LM steps and two FastCLIP v3 steps against JAX's: losses and the
    aux losses rtol 1e-5; per group of leaves, AdamW's moments (1e-4)
    and the update divided by lr (1e-3) by relative L2.  One leaf is
    held otherwise: llama4-scout's router under the contrastive
    objective, whose gradient is f32 rounding noise alone
    (``_router_noise_bound`` gives the arithmetic), within an absolute
    bound on both sides;
  * the launcher at ``--reduced --device cpu --guard`` for both archs
    under both objectives for 2 steps, ``--resume`` from step 1 bitwise
    equal to the uninterrupted run, its checkpoint read bitwise by JAX's
    ``restore``; ``--mesh`` with ``--objective lm`` exiting as JAX's
    launcher does;
  * ``data:1,fsdp:2`` (2 gloo ranks, tests/helpers/torch_mesh_check.py's
    ``moe`` battery) against the single-device steps at the bounds of
    tests/test_torch_dense_train.py, the sharded checkpoint restored on
    one device bitwise; ``param_fsdp_dims`` against JAX's at the
    full-width shapes, from shapes alone.
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
from repro.models import moe as JM
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
from repro_torch.models import moe as TM
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_mesh_check as H  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
B, S, N = 2, 32, 16
GB = 4                      # the contrastive steps' global batch
LR, TOTAL = 0.5, 10
BETA1, BETA2 = 0.9, 0.999   # adamw()'s
# the bounds of tests/test_torch_dense_train.py (their reasons in
# tests/test_torch_lm.py)
LOSS_RTOL, GRAD_TOL, MOMENT_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-4, 1e-3
ROUTER = "supers/moe/router"
# The router of a top-1 MoE under the contrastive objective (``encode``
# drops the aux losses in both packages): its gate is v / max(v, 1e-9)
# = 1 exactly, so the gate's gradient reaches the router probability v
# as g / v - g v / v^2, which is 0 but for rounding: four roundings of
# terms of size |g| / v (the quotient, and the product, square and
# quotient of the second term; their difference is exact) leave at most
# 4 * 2^-24 |g| / v.  The softmax backward scales that by p_v = v times
# at most 1, and the router's gradient sums it against the router's
# input h over the tokens: |d router[d, e]| <= 4 * 2^-24 * sum_t |h[t,
# d]| |g_t| (plus the matmul's relative rounding).  The bound doubles
# the 4 for the order in which JAX's compiler may take those products.
NOISE_ROUNDINGS = 8 * 2.0 ** -24


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


def _groups(flat, prefix, skip=()):
    """Leaves under ``prefix`` concatenated per top-level group, but
    those whose path (after the prefix) is in ``skip``."""
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix) and k[len(prefix):] not in skip:
            out.setdefault(k[len(prefix):].split("/")[0], []).append(
                np.asarray(v, np.float64).ravel())
    return {g: np.concatenate(v) for g, v in out.items()}


def _perturb(params, seed):
    """Non-unit qk-norm scales (JAX's init sets ones, which would hide
    them)."""
    rng = np.random.default_rng(seed)

    def one(path, v):
        if _path_str(path).endswith(("q_norm/scale", "k_norm/scale")):
            return v * (1.0 + 0.5 * rng.standard_normal(v.shape,
                                                         dtype=np.float32))
        return v
    return jax.tree_util.tree_map_with_path(one, params)


def _fc(mod, loss_impl="dense"):
    return mod.FastCLIPConfig(version="v3", n_samples=N,
                              steps_per_epoch=N // GB, gamma_decay_epochs=1,
                              loss_impl=loss_impl)


def _noise_leaves(cfg):
    """The leaves whose contrastive gradient is rounding noise alone."""
    return (ROUTER,) if cfg.moe.top_k == 1 else ()


# ---------------------------------------------------------------------------
# The MoE layer under autograd
# ---------------------------------------------------------------------------

def _dispatch_rows(cfg, B_, S_, seed):
    """The dispatch's (E, B * C) token rows of a real routing (random
    router probabilities) at ``cfg``'s capacity, as ``apply_moe`` builds
    them."""
    m = cfg.moe
    C = TM.moe_capacity(S_, m.n_experts, m.top_k, m.capacity_factor)
    logits = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B_, S_, m.n_experts), dtype=np.float32))
    r = TM.route(torch.softmax(logits, -1), m.top_k, C)
    rows = r.picks + S_ * torch.arange(B_)[:, None, None]
    return rows.transpose(0, 1).reshape(m.n_experts, B_ * C)


@pytest.mark.parametrize("arch,cap", [
    ("qwen3-moe-30b-a3b", None),      # fills: tokens picked at weight 0
    ("qwen3-moe-30b-a3b", 0.5),       # drops
    ("llama4-scout-17b-a16e", None),  # top-1 of 4, the tie rule's fills
])
def test_dispatch_backward_sums_in_ascending_expert_order(arch, cap):
    cfg = t_get_arch(arch).reduced()
    if cap is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cap))
    B_, S_, d = 2, 48, 24
    idx = _dispatch_rows(cfg, B_, S_, seed=2)
    E, n = idx.shape
    # the case this is for: rows gathered by more than one expert
    assert np.bincount(idx.reshape(-1).numpy()).max() >= 2
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((B_ * S_, d),
                                             dtype=np.float32))
    g = rng.standard_normal((E, n, d), dtype=np.float32)
    h.requires_grad_(True)
    out = TM._Dispatch.apply(h, idx)
    assert torch.equal(out, h.detach()[idx])
    got, = torch.autograd.grad(out, h, torch.from_numpy(g))
    want = np.zeros((B_ * S_, d), np.float32)
    for e in range(E):                 # ascending expert order, from 0
        want[idx[e].numpy()] += g[e]
    assert got.numpy().tobytes() == want.tobytes()
    # autograd of the plain gather sums the same terms in its own order
    hp = h.detach().clone().requires_grad_(True)
    plain, = torch.autograd.grad(hp[idx], hp, torch.from_numpy(g))
    scale = np.zeros((B_ * S_, d), np.float64)
    for e in range(E):
        scale[idx[e].numpy()] += np.abs(g[e])
    assert np.all(np.abs(got.numpy().astype(np.float64) - plain.numpy())
                  <= E * 2.0 ** -24 * scale)


def _moe_module(tcfg, params):
    mod = TM.MoE(tcfg)
    flat = {"norm.scale": params["norm"]["scale"]}
    for k, v in params.items():
        if k == "shared":
            flat.update({f"shared.{n}": w for n, w in v.items()})
        elif k != "norm":
            flat[k] = v
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in flat.items()})
    return mod


@pytest.mark.parametrize("arch,cap,S_", [
    ("qwen3-moe-30b-a3b", None, 16),
    ("qwen3-moe-30b-a3b", 0.1, 64),       # most routed tokens dropped
    ("llama4-scout-17b-a16e", None, 64),
])
def test_moe_layer_gradients_match_jax(arch, cap, S_, monkeypatch):
    """x and every parameter of one layer under ``sum(y * w) + lb + z``
    (the aux losses reach the router, whatever its top-k; with top-1
    the rest of the router's gradient is the gates' rounding noise)."""
    jcfg, tcfg = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    if cap is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=cap))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=cap))
    params = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S_, jcfg.d_model), dtype=np.float32)
    w = rng.standard_normal(x.shape, dtype=np.float32)

    def jloss(p, x):
        y, aux = JM.apply_moe(p, jcfg, x)
        return jnp.sum(y * w) + aux["moe_lb"] + aux["moe_z"]
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    mod = _moe_module(tcfg, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    names, ps = zip(*mod.named_parameters())
    with _gate_grads(monkeypatch, [mod.norm]) as (hs, gg):
        with torch.enable_grad():
            y, aux = TM.apply_moe(mod, tcfg, xt)
            aux_loss = aux["moe_lb"] + aux["moe_z"]
            loss = (y * torch.from_numpy(w)).sum() + aux_loss
            gs = torch.autograd.grad(loss, (xt, *ps), retain_graph=True)
            g_aux = torch.autograd.grad(aux_loss, mod.router)[0].numpy()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    want = {"x": np.asarray(jgx)}
    want.update({k.replace("/", "."): v for k, v in jax_flat(jgp).items()})
    got = dict(zip(("x",) + names, (g.numpy() for g in gs)))
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "router" and tcfg.moe.top_k == 1:
            # the aux losses' gradient, plus the gates' rounding noise
            # (NOISE_ROUNDINGS) on each side
            bound = _noise_bound(hs, gg)[0]
            assert np.all(np.abs(got[k] - g_aux) <= bound)
            assert np.all(np.abs(want[k] - g_aux) <= 1.01 * bound)
            continue
        assert _rel_l2(got[k], want[k]) <= GRAD_TOL, (k, _rel_l2(got[k],
                                                                 want[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_under_grad_is_the_serving_forward(arch):
    """The hidden states and aux losses under autograd (the recompute,
    the dispatch Function) are bitwise those of the no-grad forward."""
    cfg = t_get_arch(arch).reduced()
    model = TBB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.inference_mode():
        h0, a0 = TBB.forward_hidden(model, cfg, {"tokens": tokens})
    with torch.enable_grad():
        h1, a1 = TBB.forward_hidden(model, cfg, {"tokens": tokens})
    assert h1.requires_grad and torch.equal(h0, h1.detach())
    assert all(a0[k].item() == a1[k].item() for k in ("moe_lb", "moe_z"))


# ---------------------------------------------------------------------------
# The grouped recompute
# ---------------------------------------------------------------------------

def _loss_grads(model, cfg, batch, impl="flash"):
    with torch.enable_grad():
        loss, _ = TBB.lm_loss(model, cfg, batch, impl=impl)
        return loss, TTS.param_grads(loss, model)


def _routes_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch,n_layers,segments,order", [
    # 12 super-blocks: 2 groups of 6, recomputed last group first
    ("qwen3-moe-30b-a3b", 12, 2, list(range(6, 12)) + list(range(6))),
    # 2 super-blocks (a dense block and an MoE block each): JAX's
    # per-block fall-back
    ("llama4-scout-17b-a16e", 4, 2, [1, 0]),
])
def test_grouped_recompute_is_bitwise_and_routes_as_forward(
        arch, n_layers, segments, order, monkeypatch):
    cfg = t_get_arch(arch).reduced().replace(n_layers=n_layers)
    n_super = n_layers // cfg.moe.every
    blocks = n_super * cfg.moe.every       # attention blocks
    model = TBB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ds = TLD(n=N, seq_len=S, vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch([0, 1]).items()}
    calls, checkpoints, routes = [0], [0], []
    orig, orig_ckpt, orig_route = TA.flash_mha, TBB.checkpoint, TM.route

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    def counted_ckpt(*a, **k):
        checkpoints[0] += 1
        return orig_ckpt(*a, **k)

    def recorded(*a):
        routes.append(orig_route(*a))
        return routes[-1]
    monkeypatch.setattr(TA, "flash_mha", counted)
    monkeypatch.setattr(TBB, "checkpoint", counted_ckpt)
    monkeypatch.setattr(TM, "route", recorded)
    loss, grads = _loss_grads(model, cfg, batch)
    assert (checkpoints[0], calls[0]) == (segments, 2 * blocks)
    assert len(routes) == 2 * n_super
    for i, s in enumerate(order):      # each recompute routes as before
        assert _routes_equal(routes[n_super + i], routes[s]), (i, s)
    with monkeypatch.context() as m:      # the recompute, bypassed
        m.setattr(TBB, "checkpoint", lambda fn, *a, **k: fn(*a))
        calls[0] = 0
        loss0, grads0 = _loss_grads(model, cfg, batch)
        assert calls[0] == blocks
    assert loss.item() == loss0.item()
    _bitwise({k: v.numpy() for k, v in grads.items()},
             {k: v.numpy() for k, v in grads0.items()})
    calls[0] = 0                        # no grad: nothing recomputed
    TST.make_prefill_step(cfg)(model, {"tokens": batch["tokens"]})
    assert calls[0] == blocks


# ---------------------------------------------------------------------------
# The loss, the LM steps and the contrastive steps against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The JAX side, once per arch: the (perturbed) init, the LM loss and
    its gradients, two jitted LM steps and two jitted v3 steps."""
    arch = request.param
    jcfg, tcfg = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    params = _perturb(jax.jit(JBB.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg), 1)
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
    lm_states, lm_metrics = [jax_flat(state)], []
    for b in lm_batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        lm_states.append(jax_flat(state))
        lm_metrics.append({k: float(v) for k, v in m.items()})
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
                lm_metrics=lm_metrics, ctr_data=ctr_data,
                ctr_states=ctr_states, ctr_metrics=ctr_metrics)


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_lm_loss_and_gradients_match_jax(ref, impl):
    tcfg = ref["tcfg"]
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["lm_batches"][0].items()}
    loss, grads = _loss_grads(model, tcfg, batch, impl)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    grads = {k: v.numpy() for k, v in flatten(
        bridge.named_to_tree(model, grads)).items()}
    assert sorted(grads) == sorted(ref["grads"])
    unreached = sorted(k for k, w in ref["grads"].items() if not np.any(w))
    # the attention block's second norm is in the tree but unused (JAX's)
    assert unreached == ["ctr_proj", "pair_proj", "supers/attn_blk/n2/scale"]
    for k, w in ref["grads"].items():
        if k in unreached:
            assert not np.any(grads[k]), k
            continue
        assert _rel_l2(grads[k], w) <= GRAD_TOL, (k, _rel_l2(grads[k], w))


def _check_step(before, after, want_before, want, lr, zero_grad,
                noise=None):
    """AdamW's moments and the update / lr per group of leaves against
    JAX's; ``zero_grad``: the groups with a zero gradient (zero moments,
    moved by the decay alone).  ``noise``: {leaf: (m bound, v bound)}
    for the leaves whose gradient is rounding noise: their moments are
    held within those bounds on both sides, and their normalised AdamW
    step |m^ / (sqrt(v^) + eps)| to 1.01 (at most 1 at step 1, 1.002 at
    step 2 by Cauchy-Schwarz over the two gradients), outside their
    groups."""
    noise = noise or {}
    assert sorted(after) == sorted(want)
    for mom in ("m", "v"):
        g_got = _groups(after, f"opt/{mom}/", noise)
        g_want = _groups(want, f"opt/{mom}/", noise)
        for g in g_want:
            if g in zero_grad:
                assert not np.any(g_want[g]) and not np.any(g_got[g]), g
                continue
            assert _rel_l2(g_got[g], g_want[g]) <= MOMENT_TOL, (
                mom, g, _rel_l2(g_got[g], g_want[g]))
    for leaf, (m_bound, v_bound) in noise.items():
        for side in (after, want):
            assert np.all(np.abs(side[f"opt/m/{leaf}"]) <= m_bound), leaf
            assert np.all(side[f"opt/v/{leaf}"] <= v_bound), leaf
    if lr == 0:
        return
    p0, p1 = (_groups(before, "params/", noise),
              _groups(after, "params/", noise))
    q0, q1 = (_groups(want_before, "params/", noise),
              _groups(want, "params/", noise))
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
    for leaf in noise:
        k = f"params/{leaf}"
        for b0, b1 in ((before, after), (want_before, want)):
            p = b0[k].astype(np.float64)
            step = (p - b1[k]) / lr - 0.1 * p
            assert np.all(np.abs(step) <= 1.01), leaf


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
        jm = ref["lm_metrics"][i]
        assert sorted(m) == sorted(jm) == ["ce", "loss", "moe_lb", "moe_z"]
        for k in jm:
            np.testing.assert_allclose(m[k].item(), jm[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        after = port_flat(state)
        _check_step(before, after, ref["lm_states"][i],
                    ref["lm_states"][i + 1], [0.0, LR / 500][i],
                    ("ctr_proj", "pair_proj"))
        before = after


@contextlib.contextmanager
def _gate_grads(monkeypatch, norms):
    """Within the block, each MoE call's router input (the output of its
    ``norm``, one of ``norms``) and the gradient its gates receive are
    recorded: yields (inputs, gate gradients), in call order.  The
    recompute is bypassed, so that the hooks are on the graph the
    backward runs."""
    hs, gg, orig = [], [], TM.route

    def route(*a):
        r = orig(*a)
        i = len(gg)
        gg.append(None)
        r.gates.register_hook(lambda g, i=i: gg.__setitem__(i, g))
        return r
    hooks = [n.register_forward_hook(
        lambda mod, a, out: hs.append(out.detach().double()))
        for n in norms]
    try:
        with monkeypatch.context() as mp:
            mp.setattr(TM, "route", route)
            mp.setattr(TBB, "checkpoint", lambda fn, *a, **k: fn(*a))
            yield hs, gg
    finally:
        for h in hooks:
            h.remove()


def _noise_bound(hs, gg):
    """(calls, d, 1): NOISE_ROUNDINGS * sum_t |h[t, d]| |dL/dgate_t| for
    each top-1 MoE call's router input ``h`` and gate gradient."""
    return np.stack([NOISE_ROUNDINGS * torch.einsum(
        "btd,bt->d", h.abs(), g[..., 0].double().abs()).numpy()[:, None]
        for h, g in zip(hs, gg)])


def test_port_restores_jax_lm_train_state_bitwise(ref, tmp_path):
    """JAX's LM train state after its two steps, saved by JAX's writer,
    restored into the port's state through the bridge bit for bit (the
    reverse direction is the launcher test's)."""
    tcfg = ref["tcfg"]
    want = ref["lm_states"][2]
    JCK.save(str(tmp_path), unflatten(want), 2, metadata={"arch": "x"})
    _, opt = TST.make_lm_train_step(tcfg, device="cpu")
    state = TST.init_lm_train_state(tcfg, torch.Generator().manual_seed(9),
                                    opt, "cpu")
    got, step, _ = TCK.restore(str(tmp_path), bridge.state_to_tree(state))
    assert step == 2
    state = bridge.state_from_tree(state, got)
    assert isinstance(state["params"], TBB.MoELM)
    _bitwise(port_flat(state), want)


def _router_noise_bound(tc, state, batch, idx, monkeypatch):
    """``_noise_bound`` per super-block from the port's forward and
    backward of the contrastive step's loss on this state and batch."""
    model = state["params"]
    with _gate_grads(monkeypatch, [sup.moe.norm for sup in model.supers]
                     ) as (hs, gg):
        core = TTS.make_loss_core(tc.fc, tc.loss_impl or tc.fc.loss_impl)
        TTS.step_grads(tc, core, state, batch, idx,
                       tc.fc.gamma_fn()(state["step"]))
    return _noise_bound(hs, gg)


def test_two_contrastive_steps_match_jax(ref, monkeypatch):
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
    m_bound = v_bound = 0.0
    for i, (idx, b) in enumerate(ref["ctr_data"]):
        noise = {}
        if _noise_leaves(tcfg):
            # the moments' recursions over the per-step gradient bounds
            gb = _router_noise_bound(ttc, state, {
                k: torch.from_numpy(v) for k, v in b.items()},
                torch.from_numpy(idx), monkeypatch)
            assert gb.max() > 0
            m_bound = BETA1 * m_bound + (1 - BETA1) * gb
            v_bound = BETA2 * v_bound + (1 - BETA2) * gb ** 2
            noise = {ROUTER: (1.01 * m_bound, 1.01 * v_bound)}
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
                    [0.0, LR / 500][i], zero, noise)
        before = after


def test_contrastive_router_gradient(ref, monkeypatch):
    """Step 0's router gradient under the contrastive objective: top-8
    (qwen3-moe) within GRAD_TOL of JAX's, top-1 (llama4-scout) rounding
    noise on both sides within ``_router_noise_bound``, and not all 0
    (the noise is there to be bounded)."""
    tcfg = ref["tcfg"]
    ttc = TTS.TrainStepConfig(arch=tcfg, fc=_fc(TFC, "fused"),
                              optimizer=adamw(),
                              lr_fn=lr_warmup_cosine(LR, 500, TOTAL), wd=0.1)
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), ttc, "cpu")
    state = bridge.state_from_tree(ts, unflatten(ref["ctr_states"][0]))
    idx, b = ref["ctr_data"][0]
    tb, tidx = {k: torch.from_numpy(v) for k, v in b.items()}, \
        torch.from_numpy(idx)
    core = TTS.make_loss_core(ttc.fc, ttc.fc.loss_impl)
    grads = TTS.step_grads(ttc, core, state, tb, tidx,
                           ttc.fc.gamma_fn()(state["step"]))[2]
    got = flatten(bridge.named_to_tree(state["params"], grads))[
        ROUTER].numpy()
    # JAX's step 0 (lr 0): m = (1 - beta1) g
    want = ref["ctr_states"][1][f"opt/m/{ROUTER}"] / (1 - BETA1)
    if not _noise_leaves(tcfg):
        assert _rel_l2(got, want) <= GRAD_TOL
        return
    bound = _router_noise_bound(ttc, state, tb, tidx, monkeypatch)
    assert np.any(got) and np.any(want)
    assert np.all(np.abs(got) <= bound)
    assert np.all(np.abs(want) <= 1.01 * bound)


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
    # JAX's LM step logs the aux losses; the contrastive step the guard's
    assert keys == (["ce", "loss", "moe_lb", "moe_z"] if objective == "lm"
                    else ["gamma", "grad_norm", "loss", "loss_value", "lr",
                          "nonfinite_rate", "sat_rate", "skipped", "tau",
                          "u_mean"])
    assert ("retrieval accuracy: " in out) == (objective == "contrastive")
    assert isinstance(state["params"], TBB.MoELM)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_mesh_with_lm_objective_exits_as_jax(arch):
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--objective", "lm", "--mesh", "data:1,fsdp:1",
                     "--steps", "1"])
    assert e.value.code == ("--mesh drives the contrastive trainer; the "
                            "LM shapes run on the production mesh via "
                            "repro.launch.dryrun")


# ---------------------------------------------------------------------------
# The contrastive objective of the MoE LMs on the mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_mesh")
    ranks = H.spawn("moe", out, nproc=2, timeout=240)
    assert [r.returncode for r in ranks] == [0] * 2, ranks[0].stderr[-3000:]
    with open(out / "moe.json") as f:
        checks = json.load(f)
    return out, checks, dict(np.load(out / "moe.npz"))


@pytest.mark.parametrize("arch", sorted(H.MOE_ARCHS))
def test_moe_mesh_step_equals_single_device(moe_mesh, arch):
    c = moe_mesh[1][arch]
    assert c["same_keys"] and c["params_unmoved"] == []
    assert c["dloss"] < 1e-5
    assert c["dlogu"] < 1e-4
    assert max(c["moment_rel_l2"].values()) <= MOMENT_TOL, c[
        "moment_rel_l2"]
    assert max(c["update_rel_l2"].values()) <= UPDATE_TOL, c[
        "update_rel_l2"]
    # lm_head (untied) and the unused norm: zero gradients, zero moments
    assert c["zero_moment_leaves"] == ["lm_head", "supers/attn_blk/n2/scale"]
    # the expert stacks (n_super, E, in, out) shard a trailing dim
    for path in ("supers/moe/w_gate", "supers/moe/w_up",
                 "supers/moe/w_down"):
        assert c["dims"][path] in (2, 3), (path, c["dims"][path])
    # each gather's backward once per step for every sharded leaf the
    # towers reach (lm_head's never runs)
    assert c["gather_backward_calls"] == 2 * (len(c["sharded_leaves"]) - 1)


@pytest.mark.parametrize("arch", sorted(H.MOE_ARCHS))
def test_moe_sharded_checkpoint_restores_on_one_device(moe_mesh, arch):
    """The fsdp-2 checkpoint, merged on one device (fsdp 1) into the
    single-device state, bitwise equal to the gathered mesh state."""
    out, _, res = moe_mesh
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", [2, 4])
def test_param_fsdp_dims_equal_jax_at_full_width(arch, size):
    """From shapes alone (JAX's ``eval_shape``, the port's meta
    tensors): nothing of the 30-59 B parameters is allocated."""
    jshapes = jax.eval_shape(lambda: JBB.init_params(jax.random.PRNGKey(0),
                                                     j_get_arch(arch)))
    want = {_path_str(p): d for p, d in jax.tree_util.tree_flatten_with_path(
        JSS.param_fsdp_dims(jshapes, size),
        is_leaf=lambda d: d is None)[0]}
    shapes = TBB.param_shapes(t_get_arch(arch))
    assert all(v.device.type == "meta" for v in flatten(shapes).values())
    got = SS.param_fsdp_dims(shapes, size)
    assert got == want
    # e.g. supers/moe/w_gate (n_super, E, d, d_ff) shards its d (dim -2)
    assert got["supers/moe/w_gate"] == 2 and got["supers/moe/w_down"] == 2
