"""The port's loss math, schedules, FastCLIP versions, optimizers and
step guard (``repro_torch.core.losses``, ``schedules``, ``fastclip``,
``optim``, ``resilience.guard``) against the JAX package: the same
numpy-seeded inputs through both, f32, 1e-6 (one update of a random
tree; ``update_log_u`` exact at -inf)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastclip as JFC
from repro.core import losses as JLS
from repro.core import schedules as JSCH
from repro.optim import optimizers as JOPT
from repro.optim import base as JOB
from repro.resilience import guard as JRG
from repro_torch.core import fastclip as TFC
from repro_torch.core import losses as TLS
from repro_torch.core import schedules as TSCH
from repro_torch.optim import base as TOB
from repro_torch.optim import optimizers as TOPT
from repro_torch.resilience import guard as TRG


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL = dict(rtol=1e-6, atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


def _emb(rng, B, d):
    def norm(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
    return (norm(rng.standard_normal((B, d))),
            norm(rng.standard_normal((B, d))))


def test_constants_and_primitives():
    assert TLS.EXP_CLAMP == JLS.EXP_CLAMP and TLS.MASK_NEG == JLS.MASK_NEG
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((6, 9)) * 40).astype(np.float32)
    mask = rng.random((6, 9)) > 0.3
    mask[2] = False                       # a fully masked row
    close(TLS.guarded_exp(t(z)), JLS.guarded_exp(z))
    for fn in ("masked_shift", "lse_shift"):
        for a, b in zip(getattr(TLS, fn)(t(z), t(mask)),
                        getattr(JLS, fn)(z, mask)):
            close(a, b)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    close(TLS.l2_normalize(t(x)), JLS.l2_normalize(x))


@pytest.mark.parametrize("tau", [0.07, 0.01, "rows"])
@pytest.mark.parametrize("rect", [False, True])
def test_row_stats_and_log_g(tau, rect):
    rng = np.random.default_rng(1)
    e1a, e2a = _emb(rng, 24, 16)
    b, off = (8, 8) if rect else (24, 0)
    e1, e2 = e1a[off:off + b], e2a[off:off + b]
    tv = (0.01 + 0.06 * rng.random(b).astype(np.float32)
          if tau == "rows" else np.float32(tau))
    got = TLS.row_stats(t(e1), t(e2), t(e1a), t(e2a), t(tv), t(tv),
                        row_offset=off)
    want = JLS.row_stats(e1, e2, e1a, e2a, tv, tv, row_offset=off)
    for a, w in zip(got, want):
        close(a, w, rtol=1e-5, atol=1e-6)
    for a, w in zip(TLS.log_g(got), JLS.log_g(want)):
        close(a, w, rtol=1e-5, atol=1e-5)


def test_update_log_u_exact_at_neg_inf_and_gamma_edges():
    inf = np.float32(np.inf)
    lu = np.array([-inf, -inf, 0.3, -2.0, 5.0], np.float32)
    lg = np.array([-inf, 1.5, -inf, 0.7, 3.0], np.float32)
    for gamma in (0.0, 1.0, 0.37, 0.9):
        got = TLS.update_log_u(t(lu), t(lg), gamma).numpy()
        want = np.asarray(JLS.update_log_u(lu, lg, gamma))
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        close(got[fin], want[fin])
    # u == 0 (log -inf) updated with gamma: exactly log(gamma) + log g
    got = TLS.update_log_u(t(np.float32([-inf])), t(np.float32([2.0])), 0.5)
    close(got, np.log(np.float32(0.5)) + np.float32(2.0), rtol=0, atol=0)


def test_weights_values_and_saturation():
    rng = np.random.default_rng(2)
    lu1 = np.log(rng.random(10) + 0.05).astype(np.float32)
    lu2 = np.log(rng.random(10) + 0.05).astype(np.float32)
    tau = (0.01 + 0.06 * rng.random(10)).astype(np.float32)
    for sbt in (True, False):
        for a, b in zip(TLS.fcco_log_weights(t(lu1), t(lu2), t(tau), t(tau),
                                             1e-14, scale_by_tau=sbt),
                        JLS.fcco_log_weights(lu1, lu2, tau, tau, 1e-14,
                                             scale_by_tau=sbt)):
            close(a, b)
    u1, u2 = np.exp(lu1), np.exp(lu2)
    for a, b in zip(TLS.fcco_weights(t(u1), t(u2), t(tau), t(tau), 1e-6),
                    JLS.fcco_weights(u1, u2, tau, tau, 1e-6)):
        close(a, b)
    close(TLS.update_u(t(u1), t(u2), 0.3), JLS.update_u(u1, u2, 0.3))
    close(TLS.log_eps_u(t(lu1), 1e-6), JLS.log_eps_u(lu1, 1e-6))
    close(TLS.gcl_value(t(lu1), t(lu2), 0.05, 1e-14),
          JLS.gcl_value(lu1, lu2, 0.05, 1e-14))
    close(TLS.rgcl_g_value(t(lu1), t(lu2), 0.05, 1e-14, 6.5),
          JLS.rgcl_g_value(lu1, lu2, 0.05, 1e-14, 6.5))
    close(TLS.rgcl_value(t(lu1), t(lu2), t(tau), t(tau), 1e-14, 6.5),
          JLS.rgcl_value(lu1, lu2, tau, tau, 1e-14, 6.5))
    e1, e2 = _emb(rng, 10, 8)
    st_t = TLS.row_stats(t(e1), t(e2), t(e1), t(e2), t(tau), t(tau))
    st_j = JLS.row_stats(e1, e2, e1, e2, tau, tau)
    lw = (lu1 + 70.0).astype(np.float32)  # saturates some rows
    close(TLS.saturation_rate(st_t, t(lw), t(lw), t(tau), t(tau)),
          JLS.saturation_rate(st_j, lw, lw, tau, tau), rtol=0, atol=0)
    close(TLS.surrogate_loss(st_t, t(lu1), t(lu2), 10),
          JLS.surrogate_loss(st_j, lu1, lu2, 10), rtol=1e-5)
    close(TLS.mbcl_loss(t(e1), t(e2), 0.05), JLS.mbcl_loss(e1, e2, 0.05),
          rtol=1e-5)


@pytest.mark.parametrize("tau", [0.07, 0.01])
def test_fcco_reference_step_and_gradients(tau):
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((12, 8)).astype(np.float32)
    x2 = rng.standard_normal((12, 8)).astype(np.float32)
    lu = np.log(rng.random((2, 12)) + 0.1).astype(np.float32)
    a = t(x1).requires_grad_(True)
    b = t(x2).requires_grad_(True)
    loss, aux = TLS.fcco_reference_step(a, b, t(lu[0]), t(lu[1]), tau, tau,
                                        0.5, 1e-14)
    ga, gb = torch.autograd.grad(loss, (a, b))

    def f(p, q):
        return JLS.fcco_reference_step(p, q, lu[0], lu[1], tau, tau, 0.5,
                                       1e-14)

    (jl, jaux), (ja, jb) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(x1, x2)
    close(loss.detach(), jl, rtol=1e-5)
    for k in jaux:
        close(aux[k].detach(), jaux[k], rtol=1e-5, atol=1e-6)
    close(ga, ja, rtol=1e-4, atol=1e-6)
    close(gb, jb, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def test_schedules_match_jax():
    steps = np.arange(0, 140, 3, dtype=np.int32)
    pairs = [(TSCH.gamma_constant(0.6), JSCH.gamma_constant(0.6)),
             (TSCH.gamma_cosine(0.2, 7, 4), JSCH.gamma_cosine(0.2, 7, 4)),
             (TSCH.lr_warmup_cosine(1e-3, 11, 120, 1e-5),
              JSCH.lr_warmup_cosine(1e-3, 11, 120, 1e-5))]
    for tf, jf in pairs:
        for s in steps:
            got = tf(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            close(got, jf(jnp.asarray(s)))
        assert float(tf(5)) == pytest.approx(float(jf(5)), rel=1e-6)


# ---------------------------------------------------------------------------
# FastCLIP versions
# ---------------------------------------------------------------------------

def _state_np(tree):
    """A JAX tree with its leaves made concrete (still jax arrays)."""
    return jax.tree.map(jnp.asarray, tree)


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _cmp_tree(got, want, **kw):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _cmp_tree(got[k], want[k], **kw)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    if np.issubdtype(w.dtype, np.integer):
        assert np.array_equal(g, w)
    else:
        fin = np.isfinite(w)
        assert np.array_equal(fin, np.isfinite(g))
        close(g[fin], w[fin], **kw)


@pytest.mark.parametrize("version", JFC.VERSIONS)
def test_fastclip_version_math_matches_jax(version):
    """init_state, gamma schedule, objective, loss_value, tau_gradient and
    three tau updates of every version (v3 crosses its lr/3 threshold)."""
    n, B = 20, 8
    kw = dict(version=version, n_samples=n, rho=6.5, steps_per_epoch=3,
              gamma_decay_epochs=2, tau_init=0.031, lr_tau=2e-3)
    jfc, tfc = JFC.FastCLIPConfig(**kw), TFC.FastCLIPConfig(**kw)
    assert (tfc.uses_fcco, tfc.individual_tau, tfc.learnable_tau,
            tfc.scale_by_tau) == (jfc.uses_fcco, jfc.individual_tau,
                                  jfc.learnable_tau, jfc.scale_by_tau)
    js = _state_np(JFC.init_state(jfc))
    ts = TFC.init_state(tfc)
    _cmp_tree(ts, js)
    for s in (0, 4, 9):
        close(tfc.gamma_fn()(torch.tensor(s, dtype=torch.int32)),
              jfc.gamma_fn()(jnp.asarray(s, jnp.int32)))
    rng = np.random.default_rng(4)
    idx = rng.permutation(n)[:B]
    x1 = rng.standard_normal((B, 8)).astype(np.float32)
    x2 = rng.standard_normal((B, 8)).astype(np.float32)
    lu = np.log(rng.random((2, B)) + 0.1).astype(np.float32)
    jt1, jt2 = JFC.batch_taus(jfc, js, idx)
    tt1, tt2 = TFC.batch_taus(tfc, ts, torch.from_numpy(idx))
    close(tt1, jt1)
    jl, jaux = JFC.objective(jfc, x1, x2, lu[0], lu[1], jt1, jt2, 0.4)
    tl, taux = TFC.objective(tfc, t(x1), t(x2), t(lu[0]), t(lu[1]), tt1,
                             tt2, 0.4)
    close(tl, jl, rtol=1e-5)
    if version == "openclip":
        assert TFC.loss_value(tfc, taux, tt1, tt2, mbcl=tl) is tl
        g = np.float32(0.37)
        jg, tg = g, torch.tensor(g)
    else:
        close(TFC.loss_value(tfc, taux, tt1, tt2),
              JFC.loss_value(jfc, jaux, jt1, jt2), rtol=1e-6)
        jg = JFC.tau_gradient(jfc, jaux, jt1, jt2)
        tg = TFC.tau_gradient(tfc, taux, tt1, tt2)
        if jg is None:
            assert tg is None
        else:
            for a, b in zip(jax.tree.leaves(tg), jax.tree.leaves(jg)):
                close(a, b, rtol=1e-5, atol=1e-6)
            # a gradient that drives tau down across the v3 threshold
            if version == "v3":
                jg = np.float32(40.0)
                tg = torch.tensor(jg)
    for _ in range(3):
        kw_idx = {}
        if tfc.individual_tau:
            kw_idx = {"idx": idx}
            jg_in = tuple(np.asarray(x) for x in jg)
            tg_in = tuple(t(x) for x in jg_in)
        else:
            jg_in, tg_in = jg, tg
        js = _state_np(JFC.tau_update(jfc, js, jg_in, **kw_idx))
        ts = TFC.tau_update(tfc, ts, tg_in, **(
            {"idx": torch.from_numpy(idx)} if kw_idx else {}))
        _cmp_tree(ts, js)
    if tfc.uses_fcco:
        rows = np.log(rng.random((2, B)) + 0.3).astype(np.float32)
        _cmp_tree(TFC.scatter_u(ts, torch.from_numpy(idx), t(rows[0]),
                                t(rows[1])),
                  _state_np(JFC.scatter_u(js, idx, rows[0], rows[1])),
                  rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "zero": np.zeros((3, 4), np.float32)}


@pytest.mark.parametrize("name", sorted(JOPT.OPTIMIZERS))
def test_optimizers_match_jax(name):
    rng = np.random.default_rng(5)
    p = _tree(rng)
    jo, to = JOPT.get_optimizer(name), TOPT.get_optimizer(name)
    assert to.shard_safe == jo.shard_safe
    js, ts = jo.init(p), to.init(_to_t(p))
    jp, tp = p, _to_t(p)
    for step in range(3):
        g = _tree(rng)
        lr = np.float32(1e-2 * (step + 1))
        jp, js = jo.update(jp, g, js, lr=jnp.asarray(lr), wd=0.1)
        tp, ts = to.update(tp, _to_t(g), ts, lr=torch.tensor(lr), wd=0.1)
        _cmp_tree(tp, _state_np(jp))
        _cmp_tree(ts, _state_np(js))


def test_global_norm_and_clipping():
    rng = np.random.default_rng(6)
    g = _tree(rng)
    close(TOB.global_norm(_to_t(g)), JOB.global_norm(g))
    for max_norm in (0.5, 1e3):
        tg, tn = TOB.clip_by_global_norm(_to_t(g), max_norm)
        jg, jn = JOB.clip_by_global_norm(g, max_norm)
        close(tn, jn)
        _cmp_tree(tg, _state_np(jg))


# ---------------------------------------------------------------------------
# Step guard
# ---------------------------------------------------------------------------

def test_guard_select_is_bitwise_noop_and_rates():
    old = {"a": torch.randn(4, 3), "c": {"n": torch.tensor(3,
                                                         dtype=torch.int32)}}
    new = {"a": torch.full((4, 3), float("nan")),
           "c": {"n": torch.tensor(4, dtype=torch.int32)}}
    ok_f = TRG.step_ok(torch.tensor(float("nan")), torch.tensor(2.0))
    ok_t = TRG.step_ok(torch.tensor(1.0), torch.tensor(2.0))
    assert not bool(ok_f) and bool(ok_t)
    assert not bool(TRG.step_ok(torch.tensor(1.0), torch.tensor(np.inf)))
    kept = TRG.select_state(ok_f, old, new)
    assert kept["a"].numpy().tobytes() == old["a"].numpy().tobytes()
    assert int(kept["c"]["n"]) == 3
    assert int(TRG.select_state(ok_t, old, new)["c"]["n"]) == 4
    g = {"x": np.ones((10,), np.float32), "y": np.ones((5, 2), np.float32)}
    g["x"][3] = np.nan
    g["y"][0, 1] = np.inf
    close(TRG.grad_nonfinite_rate(_to_t(g)), JRG.grad_nonfinite_rate(g))
