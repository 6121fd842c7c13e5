"""The port's FCCO loss kernels and loss op on the CPU against the JAX
package: K1 (``gcl_pair_stats``) and K2 (``gcl_pair_grads``) — the port
runs its plain versions here — against the Pallas kernels in interpret
mode; ``fused_gcl_loss`` and ``make_fcco_loss_op`` (dense and fused)
against JAX's dense op and ``jax.grad``; the four golden fixtures; the
f64 oracle bitwise.  Tolerances from the reference's own tests: K1 f32
1e-5 (bf16 1e-2 in log domain), K2 rtol 1e-4 / atol 1e-5, goldens rtol
1e-5 / atol 1e-6."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import losses as JLS
from repro.kernels import gcl_loss as JGL
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.core import distributed as TD
from repro_torch.core import losses as TLS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gcl_loss as TGL
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


def t(x):
    return torch.from_numpy(np.array(x))


def _emb(seed, B, d):
    rng = np.random.default_rng(seed)

    def norm(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
    return (norm(rng.standard_normal((B, d))),
            norm(rng.standard_normal((B, d))))


def _taus(seed, B, kind):
    if kind == "rows":
        rng = np.random.default_rng(seed + 100)
        tv = (0.01 + 0.06 * rng.random((2, B))).astype(np.float32)
        tv[:, ::3] = 0.01
        return tv
    return np.full((2, B), kind, np.float32)


# name, B (columns), b (anchor rows), row_offset, d, tau
CASES = [
    ("ragged_40x48", 40, 40, 0, 48, 0.07),
    ("ragged_130x64", 130, 130, 0, 64, 0.05),
    ("rect_16_of_48", 48, 16, 16, 32, 0.07),
    ("wide_d_384", 24, 24, 0, 384, 0.06),
    ("tau_rows_min", 40, 40, 0, 32, "rows"),
]


def _case(case):
    _, B, b, off, d, tau = case
    e1a, e2a = _emb(B + d, B, d)
    ta = _taus(B, B, tau)
    sl = slice(off, off + b)
    return e1a, e2a, ta, sl, off, b < B


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gcl_pair_stats_matches_pallas_interpret(case):
    e1a, e2a, ta, sl, off, rect = _case(case)
    e1, e2, t1, t2 = e1a[sl], e2a[sl], ta[0, sl], ta[1, sl]
    kw_j = dict(e1_all=e1a, e2_all=e2a, row_offset=off) if rect else {}
    kw_t = ({"e1_all": t(e1a), "e2_all": t(e2a), "row_offset": off}
            if rect else {})
    want = JGL.gcl_pair_stats(e1, e2, t1, t2, interpret=True, d_block=128,
                              **kw_j)
    before = TGL.gcl_pair_stats.launches
    got = TGL.gcl_pair_stats(t(e1), t(e2), t(t1), t(t2), **kw_t)
    assert TGL.gcl_pair_stats.launches == before   # CPU: the plain version
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (len(t1),)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_gcl_pair_stats_bf16_log_domain():
    e1, e2 = _emb(7, 40, 48)
    tv = _taus(7, 40, 0.05)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (e1, e2)]
    want = JLS.RowStats(*JGL.gcl_pair_stats(*jb, tv[0], tv[1],
                                            interpret=True))
    tb = [t(x).to(torch.bfloat16) for x in (e1, e2)]
    got = TLS.RowStats(*TGL.gcl_pair_stats(*tb, t(tv[0]), t(tv[1])))
    for a, w in zip(TLS.log_g(got), JLS.log_g(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-2)


def _lwt(seed, B, ta, clamp_row=None):
    rng = np.random.default_rng(seed)
    lw = np.log(rng.random((2, B)) + 0.2).astype(np.float32)
    lwt = (lw - np.log(ta)).astype(np.float32)
    if clamp_row is not None:
        lwt[0, clamp_row] = 80.0      # the clamp at 60 fires here
    return lwt


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gcl_pair_grads_matches_pallas_interpret(case):
    e1a, e2a, ta, sl, off, rect = _case(case)
    lwta = _lwt(3, e1a.shape[0], ta, clamp_row=off)
    e1, e2 = e1a[sl], e2a[sl]
    args = (lwta[0, sl], lwta[1, sl], ta[0, sl], ta[1, sl])
    if rect:
        sda = np.sum(e1a * e2a, axis=-1)
        extra = dict(sd_all=sda, lwt1_all=lwta[0], lwt2_all=lwta[1],
                     tau1_all=ta[0], tau2_all=ta[1])
        kw_j = dict(e1_all=e1a, e2_all=e2a, row_offset=off, **extra)
        kw_t = {k: t(v) for k, v in kw_j.items() if k != "row_offset"}
        kw_t["row_offset"] = off
    else:
        kw_j, kw_t = {}, {}
    want = JGL.gcl_pair_grads(e1, e2, *args, interpret=True, **kw_j)
    before = TGL.gcl_pair_grads.launches
    got = TGL.gcl_pair_grads(t(e1), t(e2), *(t(a) for a in args), **kw_t)
    assert TGL.gcl_pair_grads.launches == before
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == e1.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_plain_oracles_match_jax_ref():
    e1, e2 = _emb(11, 24, 16)
    ta = _taus(11, 24, "rows")
    for a, w in zip(TREF.gcl_pair_stats_ref(t(e1), t(e2), t(ta[0]),
                                            t(ta[1])),
                    JREF.gcl_pair_stats_ref(e1, e2, ta[0], ta[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    lw = np.log(np.random.default_rng(1).random((2, 24)) + 0.3).astype(
        np.float32)
    ta = _taus(11, 24, 0.05)      # no overflow in the unclamped oracles
    got = TREF.gcl_pair_grads_ref(t(e1), t(e2), t(lw[0]), t(lw[1]),
                                  t(ta[0]), t(ta[1]))
    want = JREF.gcl_pair_grads_ref(e1, e2, lw[0], lw[1], ta[0], ta[1])
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    # the kernel path's plain version equals the square oracle
    for a, w in zip(TGL.gcl_pair_grads(t(e1), t(e2), t(lw[0] - np.log(ta[0])),
                                       t(lw[1] - np.log(ta[1])), t(ta[0]),
                                       t(ta[1])), got):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("tau", [0.07, 0.01])
def test_fused_gcl_loss_matches_jax(tau):
    e1, e2 = _emb(5, 32, 16)
    ta = _taus(5, 32, tau)
    lw = np.log(np.random.default_rng(2).random((2, 32)) + 0.3).astype(
        np.float32)

    def f(a, b):
        return JOPS.fused_gcl_loss(a, b, lw[0], lw[1], ta[0], ta[1], True)

    (jl, jst), jg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        e1, e2)
    a, b = t(e1).requires_grad_(True), t(e2).requires_grad_(True)
    loss, st = TOPS.fused_gcl_loss(a, b, t(lw[0]), t(lw[1]), t(ta[0]),
                                   t(ta[1]))
    tg = torch.autograd.grad(loss, (a, b))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for x, w in zip(st, jst):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    for x, w in zip(tg, jg):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def _op_case(seed, B, d, tau):
    e1, e2 = _emb(seed, B, d)
    rng = np.random.default_rng(seed)
    lu = np.log(rng.random((2, B)) + 0.1).astype(np.float32)
    lu[:, ::5] = -np.inf                  # never-seen rows (u = 0)
    tv = (_taus(seed, B, "rows")[0] if tau == "rows"
          else np.float32(tau))
    return e1, e2, lu, tv


@pytest.mark.parametrize("impl", ["dense", "fused"])
@pytest.mark.parametrize("tau", [0.07, 0.01, "rows"])
@pytest.mark.parametrize("scale_by_tau", [True, False])
def test_fcco_loss_op_matches_jax_dense(impl, tau, scale_by_tau):
    """Values, every aux output and the gradients of the port's op
    (dense or through K1/K2) vs ``jax.grad`` of JAX's dense op.  Values
    rtol 1e-5 / atol 1e-6 (the goldens'); gradients rtol 1e-4 and atol
    1e-5 (K2's) times the largest gradient entry, since the closed form
    cancels terms up to 1/tau larger than its result (v0 at tau 0.01)."""
    e1, e2, lu, tv = _op_case(9, 24, 16, tau)
    jop = JD.make_fcco_loss_op(None, 1e-14, scale_by_tau, loss_impl="dense")

    def f(a, b):
        return jop(a, b, lu[0], lu[1], tv, tv, 0.6)

    (jl, jaux), jg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        e1, e2)
    top = TD.make_fcco_loss_op(None, 1e-14, scale_by_tau, loss_impl=impl)
    a, b = t(e1).requires_grad_(True), t(e2).requires_grad_(True)
    loss, (lu1, lu2, stats, sat) = top(a, b, t(lu[0]), t(lu[1]), t(tv),
                                       t(tv), 0.6)
    tg = torch.autograd.grad(loss, (a, b))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jlu1, jlu2, jstats, jsat = jaux
    for x, w in zip((lu1, lu2, *stats, sat),
                    (jlu1, jlu2, *jstats, jsat)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    for x, w in zip(tg, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_fcco_loss_op_refuses_axes_and_bad_impl():
    """Mesh axes need a mesh to run on (the sharded op itself is tested
    in tests/test_torch_mesh.py); an unknown impl or reduce is refused."""
    from repro_torch.launch import mesh as MS
    MS.set_mesh(None)
    op = TD.make_fcco_loss_op(("data",), 1e-14)
    e = torch.ones((2, 4)) / 2.0
    lu = torch.zeros(2)
    with pytest.raises(RuntimeError, match="set_mesh"):
        op(e, e, lu, lu, 0.07, 0.07, 0.5)
    with pytest.raises(ValueError, match="loss_impl"):
        TD.make_fcco_loss_op(None, 1e-14, loss_impl="pallas")
    with pytest.raises(ValueError, match="reduce"):
        TD.make_fcco_loss_op(("data",), 1e-14, reduce="sum")


# ---------------------------------------------------------------------------
# Golden fixtures (tests/golden/) and the f64 oracle
# ---------------------------------------------------------------------------

def _regen():
    spec = importlib.util.spec_from_file_location(
        "golden_regen_torch", os.path.join(GOLDEN_DIR, "regen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REGEN = _regen()


def _golden_inputs(case):
    # the fixtures were drawn with the pre-0.5 threefry lowering
    with jax.threefry_partitionable(False):
        return [np.asarray(x) for x in REGEN.inputs(case)]


@pytest.mark.parametrize("impl", ["dense", "fused"])
@pytest.mark.parametrize("case", [c[0] for c in REGEN.CASES])
def test_loss_op_matches_golden_fixtures(case, impl):
    with open(os.path.join(GOLDEN_DIR, f"fcco_{case}.json")) as f:
        want = json.load(f)
    e1, e2, lu1, lu2, tau = _golden_inputs(case)
    sbt = dict((c[0], c[2]) for c in REGEN.CASES)[case]
    op = TD.make_fcco_loss_op(None, REGEN.EPS, sbt, loss_impl=impl)
    a, b = t(e1).requires_grad_(True), t(e2).requires_grad_(True)
    loss, (lu1n, lu2n, stats, sat) = op(a, b, t(lu1), t(lu2), t(tau),
                                        t(tau), REGEN.GAMMA)
    de1, de2 = torch.autograd.grad(loss, (a, b))
    g1, g2, dg1, dg2, m1, m2 = stats
    got = {"loss": loss, "lu1_new": lu1n, "lu2_new": lu2n, "de1": de1,
           "de2": de2, "g1": g1, "g2": g2, "dg1_dtau": dg1, "dg2_dtau": dg2,
           "m1": m1, "m2": m2, "sat": sat}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k].detach().numpy().ravel(), np.ravel(want[k]), rtol=1e-5,
            atol=1e-6, err_msg=f"{case}/{impl}/{k}")


@pytest.mark.parametrize("case", [c[0] for c in REGEN.CASES])
def test_fcco_step_f64_bitwise_equal_jax(case):
    e1, e2, lu1, lu2, tau = _golden_inputs(case)
    for sbt in (True, False):
        got = TREF.fcco_step_f64(e1, e2, lu1, lu2, tau, tau, REGEN.GAMMA,
                                 REGEN.EPS, scale_by_tau=sbt)
        want = JREF.fcco_step_f64(e1, e2, lu1, lu2, tau, tau, REGEN.GAMMA,
                                  REGEN.EPS, scale_by_tau=sbt)
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).tobytes() == np.asarray(
                want[k]).tobytes(), k


# ---------------------------------------------------------------------------
# The attention kernel's autograd Function, exercised on the CPU with the
# launch replaced by the plain version (the real launch needs the card)
# ---------------------------------------------------------------------------

def test_flash_function_recomputes_gradients(monkeypatch):
    """``_FlashMHA`` (the CUDA path of ``flash_mha``/``flash_attention``)
    returns the kernel's output with a graph: its backward is autograd of
    the chunked recompute, held to the naive attention's."""
    from repro_torch.models.attention import naive_attention

    def fake_launch(q, k, v, out, causal, window):
        out.copy_(FA.flash_attention_ref(q, k, v, causal=causal,
                                         window=window))
        FA.flash_attention.launches += 1

    monkeypatch.setattr(FA, "_launch", fake_launch)
    gen = torch.Generator().manual_seed(0)
    for causal, window in ((False, 0), (True, 0), (True, 5)):
        q, k, v = (torch.randn((2, 13, 3, 16), generator=gen,
                               requires_grad=True) for _ in range(3))
        ct = torch.randn((2, 13, 3, 16), generator=gen)
        before = FA.flash_attention.launches
        out = FA._FlashMHA.apply(q, k, v, causal, window)
        got = torch.autograd.grad(out, (q, k, v), ct)
        assert FA.flash_attention.launches == before + 1  # backward: none
        ref = naive_attention(q, k, v, causal=causal, window=window)
        want = torch.autograd.grad(ref, (q, k, v), ct)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "fused"])
def test_loss_op_exact_at_tau_min_against_f64_oracle(impl):
    """At tau = 0.01 raw exponents reach ~200 (f32 exp overflows at
    ~88.7); with a planted hardest negative (gap 1.0) the port's op stays
    finite and matches the f64 linear-domain oracle (loss rtol 1e-5,
    gradients rtol 1e-4 / atol 1e-6, as tests/test_fused_loss.py)."""
    B, d, tau, gamma, eps = 48, 24, 0.01, 0.5, 1e-14
    e1, e2 = _emb(21, B, d)
    e2[1] = e1[0]                  # s[0, 1] = 1: a hardest negative
    e2 = (e2 / np.linalg.norm(e2, axis=-1, keepdims=True)).astype(
        np.float32)
    rng = np.random.default_rng(21)
    lu = np.log(rng.random((2, B)) + 0.1).astype(np.float32)
    ref = TREF.fcco_step_f64(e1, e2, lu[0], lu[1], tau, tau, gamma, eps)
    op = TD.make_fcco_loss_op(None, eps, True, loss_impl=impl)
    a, b = t(e1).requires_grad_(True), t(e2).requires_grad_(True)
    loss, (lu1n, _, _, sat) = op(a, b, t(lu[0]), t(lu[1]), tau, tau, gamma)
    de1, de2 = torch.autograd.grad(loss, (a, b))
    assert float(sat.max()) == 0.0
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(lu1n.numpy(), ref["lu1_new"], atol=1e-4)
    for g, r in zip((de1, de2), (ref["de1"], ref["de2"])):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-6)
