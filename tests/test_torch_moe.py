"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against
the JAX package's ``repro.models.moe``.  One set of params (JAX's
``init_moe``, loaded into the port's module bit for bit) and the same
numpy-seeded inputs go through both.  Every routing decision is held
equal to JAX's (the router's top-k per token, the top-C tokens per (row,
expert), in JAX's order), the output within 2e-5 (JAX's own bound for
its MoE against the dense oracle, ``tests/test_moe.py``) and the aux
losses within rtol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.models import moe as TM
from test_moe import moe_dense_oracle


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite's workers
    share the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# name: (arch, capacity factor or None for the config's, B, S)
CASES = {
    "qwen3_default": ("qwen3-moe-30b-a3b", None, 4, 16),
    "qwen3_cap64": ("qwen3-moe-30b-a3b", 64.0, 4, 16),
    "qwen3_cap0p1": ("qwen3-moe-30b-a3b", 0.1, 1, 64),
    "llama4": ("llama4-scout-17b-a16e", None, 4, 64),
}


def _cfgs(arch, cap=None):
    j, t = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    if cap is not None:
        j = j.replace(moe=dataclasses.replace(j.moe, capacity_factor=cap))
        t = t.replace(moe=dataclasses.replace(t.moe, capacity_factor=cap))
    return j, t


def _module(tcfg, params):
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


def _jax_route(params, cfg, x):
    """JAX's routing decisions, step by step as ``apply_moe`` makes
    them: (probs, gate values, gate ids, picked weights, picked
    tokens)."""
    m = cfg.moe
    C = JM.moe_capacity(x.shape[1], m.n_experts, m.top_k, m.capacity_factor)
    h = JL.rmsnorm(params["norm"], x)
    logits = jnp.einsum("bsd,de->bse", h, params["router"]).astype(
        jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gv, gi = jax.lax.top_k(probs, m.top_k)
    gv = gv / jnp.maximum(jnp.sum(gv, axis=-1, keepdims=True), 1e-9)
    sel = jnp.sum(jax.nn.one_hot(gi, m.n_experts, dtype=jnp.float32)
                  * gv[..., None], axis=2)
    pw, pt = jax.lax.top_k(sel.transpose(0, 2, 1), C)
    return tuple(np.asarray(a) for a in (probs, gv, gi, pw, pt))


def _run_both(case, router=None):
    arch, cap, B, S = CASES[case]
    jcfg, tcfg = _cfgs(arch, cap)
    params = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    if router is not None:
        params = dict(params, router=router(params["router"]))
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model), dtype=np.float32)
    jy, jaux = JM.apply_moe(params, jcfg, jnp.asarray(x))
    mod = _module(tcfg, params)
    routes = []
    with torch.inference_mode():
        orig = TM.route
        try:
            TM.route = lambda *a: routes.append(orig(*a)) or routes[-1]
            ty, taux = TM.apply_moe(mod, tcfg, torch.from_numpy(x))
        finally:
            TM.route = orig
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, x=x, mod=mod,
                jy=np.asarray(jy), jaux=jaux, ty=ty.numpy(), taux=taux,
                jroute=_jax_route(params, jcfg, jnp.asarray(x)),
                troute=routes[0])


@pytest.mark.parametrize("S,E,k,factor", [
    (4096, 128, 8, 1.25), (1, 128, 8, 1.25), (16, 4, 2, 1.0),
    (4096, 16, 1, 1.25), (1, 16, 1, 1.25), (16, 4, 2, 64.0),
    (64, 4, 2, 0.1), (64, 4, 1, 1.25), (7, 3, 2, 1.25), (100, 128, 8, 1.25),
])
def test_moe_capacity_matches_jax(S, E, k, factor):
    assert TM.moe_capacity(S, E, k, factor) == JM.moe_capacity(
        S, E, k, factor)
    if (S, E, k, factor) == (4096, 128, 8, 1.25):
        assert TM.moe_capacity(S, E, k, factor) == 320


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(case):
    """Output within 2e-5, aux losses within rtol 1e-5, and every
    routing decision equal to JAX's: experts and picks exactly, gates
    and pick weights within 1e-6.  The default capacity and 0.1 drop
    tokens, 64 drops none; llama4-scout (top-1, shared expert) drops by
    the tie rule alone (every selection weight is 1.0)."""
    r = _run_both(case)
    _, gv, gi, pw, pt = r["jroute"]
    t = r["troute"]
    np.testing.assert_array_equal(t.experts.numpy(), gi)
    np.testing.assert_array_equal(t.picks.numpy(), pt)
    np.testing.assert_allclose(t.gates.numpy(), gv, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.pick_w.numpy(), pw, atol=1e-6, rtol=0)
    np.testing.assert_allclose(r["ty"], r["jy"], atol=2e-5, rtol=0)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(r["taux"][k]), float(r["jaux"][k]),
                                   rtol=1e-5)
    kept = int((pw > 0).sum())
    routed = gi.size
    if case == "qwen3_cap64":
        assert kept == routed
    else:
        assert kept < routed, "the case is meant to drop tokens"
    if case == "llama4":
        assert np.all(gv == 1.0) and "shared" in dict(
            r["mod"].named_children())


def test_zero_router_picks_experts_0_to_k_minus_1():
    """A zero router: every probability is 1/E, so every token's top-k
    are experts 0..k-1 (JAX's tie rule), each expert keeps its first C
    tokens, and the port equals JAX's layer (output and aux)."""
    r = _run_both("qwen3_default", router=jnp.zeros_like)
    k = r["tcfg"].moe.top_k
    t = r["troute"]
    want = np.broadcast_to(np.arange(k), t.experts.shape)
    np.testing.assert_array_equal(t.experts.numpy(), want)
    np.testing.assert_array_equal(r["jroute"][2], want)
    C = t.picks.shape[-1]
    np.testing.assert_array_equal(t.picks.numpy(), r["jroute"][4])
    np.testing.assert_array_equal(
        t.picks[:, :k].numpy(), np.broadcast_to(np.arange(C), (
            t.picks.shape[0], k, C)))
    np.testing.assert_allclose(r["ty"], r["jy"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(r["taux"]["moe_lb"]),
                               float(r["jaux"]["moe_lb"]), rtol=1e-5)
    np.testing.assert_allclose(float(r["taux"]["moe_lb"]),
                               r["tcfg"].moe.aux_coef, rtol=1e-5)


def test_stable_rule_is_needed_where_torch_topk_breaks_ties_otherwise():
    """Rows of 1.0 and 0.0 (what top-1 routing gives the capacity top-k)
    at llama4-scout's prefill shape, (2, 16, 4096) with C = 320:
    ``models.moe.top_k`` picks JAX's tokens in every row;
    ``torch.topk`` picks another set in some row."""
    rng = np.random.default_rng(0)
    sel = (rng.random((2, 16, 4096)) < 0.25).astype(np.float32)
    C = 320
    jw, jt = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(sel), C))
    tw, tt = TM.top_k(torch.from_numpy(sel), C)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tw.numpy(), jw)
    _, ot = torch.topk(torch.from_numpy(sel), C, dim=-1)
    same = [set(ot[b, e].tolist()) == set(jt[b, e].tolist())
            for b in range(2) for e in range(16)]
    assert not all(same), "torch.topk matched JAX's ties here"


def test_matches_jax_dense_oracle_at_capacity_64():
    """JAX's no-capacity oracle (every expert on every token, combined by
    the renormalised gates; ``tests/test_moe.py``) holds for the port at
    capacity 64, at JAX's bound 2e-5."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", 64.0)
    params = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (2, 16, jcfg.d_model)) * 0.5)
    oracle = moe_dense_oracle(params, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        got, _ = TM.apply_moe(_module(tcfg, params), tcfg,
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("case", ["qwen3_default", "llama4"])
def test_two_runs_are_bitwise_equal(case):
    arch, cap, B, S = CASES[case]
    _, tcfg = _cfgs(arch, cap)
    mod = _module(tcfg, JM.init_moe(jax.random.PRNGKey(0),
                                    _cfgs(arch, cap)[0]))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, S, tcfg.d_model), dtype=np.float32))
    with torch.inference_mode():
        a, aa = TM.apply_moe(mod, tcfg, x)
        b, ab = TM.apply_moe(mod, tcfg, x)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    assert all(float(aa[k]) == float(ab[k]) for k in aa)


def test_decode_shape_computes_every_expert():
    """S = 1 (decode): capacity 1, every expert picks the one token, with
    weight 0 unless it was routed there; equal to JAX's layer."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b")
    params = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(4).standard_normal((4, 1, jcfg.d_model),
                                                 dtype=np.float32)
    mod = _module(tcfg, params)
    with torch.inference_mode():
        route = TM.route(torch.softmax(
            mod.norm(torch.from_numpy(x)) @ mod.router, -1),
            tcfg.moe.top_k, 1)
        got, _ = TM.apply_moe(mod, tcfg, torch.from_numpy(x))
    assert tuple(route.picks.shape) == (4, tcfg.moe.n_experts, 1)
    assert int(route.picks.max()) == 0
    assert int((route.pick_w > 0).sum()) == 4 * tcfg.moe.top_k
    want, _ = JM.apply_moe(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
