"""The two passes of each FCCO loss kernel (K1, K2), on the CPU.

On the card ``repro_torch.kernels.gcl_loss`` cuts the (b, B) pair matrix
into column splits (``csrc/gcl_loss.cu``): K1 writes each split's row
statistics (m, g, dg) and merges the splits in order by the online-max
rule; K2 writes the pair weights (A + M, rounded to the feature dtype) and
per-split row sums of A, then multiplies the weights with the columns and
finishes.  Each pass has a plain PyTorch version on the kernel's scratch
layouts; here their composition, at split widths that give 1, 2, 3 and 7
splits and at the kernel's own 32, is held to the JAX package's Pallas
kernels in interpret mode and to the one-pass plain versions, with the
reference's tolerances (``tests/test_kernels.py``): K1 f32 1e-5, bf16
1e-2 in the log domain; K2 rtol 1e-4, atol 1e-5.

The kernels' similarities run on the tensor cores through split TF32
(``csrc/mma_tf32.cuh``): each f32 operand is ``hi + lo`` with ``hi`` its
top 19 bits and ``lo = x - hi``, which the tensor cores read truncated
too; a product is ``hi*hi + (hi*lo + lo*hi)``, the hi*hi products and the
small terms summed apart, and since the tensor cores truncate the sums
they accumulate, each 32-wide chunk's hi*hi sum is added to an f32 total
rounded to nearest.  ``tc_matmul`` does that arithmetic in torch; K2's
second product, in f32, runs on the f64 tensor cores (``f64_product``).
Both together are held within the tolerances at the training shape
(256 x 256 x 512, per-row taus down to 0.01), while a single TF32 product
misses them, and one accumulator over d = 3072 misses K1's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gcl_loss as JGL
from repro_torch.core.losses import MASK_NEG
from repro_torch.kernels import gcl_loss as TGL


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL_K1, TOL_K1_BF16_LOG = 1e-5, 1e-2
TOL_K2 = dict(rtol=1e-4, atol=1e-5)


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
    if kind == "rows":             # per-row taus down to tau_min = 0.01
        rng = np.random.default_rng(seed + 100)
        tv = (0.01 + 0.06 * rng.random((2, B))).astype(np.float32)
        tv[:, ::3] = 0.01
        return tv
    return np.full((2, B), kind, np.float32)


def _lwt(seed, e1a, e2a, ta, clamp_row):
    """lwt = log w - log tau as the loss op makes them: u tracks g, so
    lwt = -log(eps + u) ~ -(m + log g), here times a random factor in
    [0.2, 1.2) (``chip_smoke.py`` phase gcl does the same); the clamp at
    60 fires on ``clamp_row``."""
    g1, g2, _, _, m1, m2 = (x.numpy() for x in TGL.gcl_pair_stats_plain(
        t(e1a), t(e2a), t(ta[0]), t(ta[1])))
    rng = np.random.default_rng(seed)
    lwt = (np.stack([-(m1 + np.log(g1)), -(m2 + np.log(g2))])
           + np.log(rng.random((2, len(g1))) + 0.2)).astype(np.float32)
    lwt[0, clamp_row] = 80.0
    return lwt


# name, B (columns), b (anchor rows), row_offset, d, tau, split width.
# "masked_split": the last split holds only column 32, which is row 32's
# own; d = 37 as the unaligned rows on the card
CASES = [
    ("one_split", 40, 40, 0, 48, 0.07, 40),
    ("two_splits", 40, 40, 0, 48, 0.07, 20),
    ("three_ragged", 40, 40, 0, 48, 0.05, 14),
    ("seven_tau_rows", 40, 40, 0, 32, "rows", 6),
    ("rect_7", 48, 16, 16, 32, 0.07, 7),
    ("rect_kernel_split", 96, 32, 40, 24, "rows", TGL.SPLIT),
    ("masked_split", 33, 33, 0, 37, 0.07, TGL.SPLIT),
]


def _case(case):
    _, B, b, off, d, tau, split = case
    e1a, e2a = _emb(B + d, B, d)
    ta = _taus(B, B, tau)
    return e1a, e2a, ta, slice(off, off + b), off, b < B, split


def _stats_split(e1, e2, t1, t2, split, e1_all=None, e2_all=None,
                 row_offset=0):
    """K1 as the kernel composes it: partial pass, then merge."""
    e1a, e2a, sd, t1, t2, denom = TGL._stats_args(e1, e2, t1, t2, e1_all,
                                                  e2_all)
    part = TGL.stats_partial_plain(e1, e2, e1a, e2a, sd, t1, t2, row_offset,
                                   split)
    return TGL.stats_merge_plain(part, denom)


def _grads_split(e1, e2, lw1, lw2, t1, t2, split, row_offset=0, **kw):
    """K2 as the kernel composes it: weights pass, then product pass."""
    args, kappa = TGL._grads_args(
        e1, e2, lw1, lw2, t1, t2, kw.get("e1_all"), kw.get("e2_all"),
        kw.get("sd_all"), kw.get("lwt1_all"), kw.get("lwt2_all"),
        kw.get("tau1_all"), kw.get("tau2_all"))
    pw, r = TGL.grads_weights_plain(e1, e2, *args, row_offset, split)
    return TGL.grads_product_plain(pw, args[0], args[1], e1, e2, r, kappa)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stats_passes_match_pallas_interpret_and_plain(case):
    e1a, e2a, ta, sl, off, rect, split = case_data = _case(case)
    e1, e2, t1, t2 = e1a[sl], e2a[sl], ta[0, sl], ta[1, sl]
    kw_j = dict(e1_all=e1a, e2_all=e2a, row_offset=off) if rect else {}
    kw_t = ({"e1_all": t(e1a), "e2_all": t(e2a), "row_offset": off}
            if rect else {})
    want = JGL.gcl_pair_stats(e1, e2, t1, t2, interpret=True, **kw_j)
    got = _stats_split(t(e1), t(e2), t(t1), t(t2), split, **kw_t)
    plain = TGL.gcl_pair_stats_plain(t(e1), t(e2), t(t1), t(t2), **kw_t)
    assert case_data[-1] == split and got.shape == (6, len(t1))
    for a, w, p in zip(got, want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=TOL_K1,
                                   atol=TOL_K1)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=TOL_K1,
                                   atol=TOL_K1)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grads_passes_match_pallas_interpret_and_plain(case):
    e1a, e2a, ta, sl, off, rect, split = _case(case)
    lwta = _lwt(3, e1a, e2a, ta, clamp_row=off)
    e1, e2 = e1a[sl], e2a[sl]
    args = (lwta[0, sl], lwta[1, sl], ta[0, sl], ta[1, sl])
    if rect:
        sda = np.sum(e1a * e2a, axis=-1)
        kw_j = dict(e1_all=e1a, e2_all=e2a, row_offset=off, sd_all=sda,
                    lwt1_all=lwta[0], lwt2_all=lwta[1], tau1_all=ta[0],
                    tau2_all=ta[1])
        kw_t = {k: (v if k == "row_offset" else t(v))
                for k, v in kw_j.items()}
    else:
        kw_j, kw_t = {}, {}
    want = JGL.gcl_pair_grads(e1, e2, *args, interpret=True, **kw_j)
    targs = [t(a) for a in (e1, e2, *args)]
    got = _grads_split(*targs, split, **kw_t)
    plain = TGL.gcl_pair_grads_plain(*targs, **kw_t)
    for a, w, p in zip(got, want, plain):
        assert torch.isfinite(a).all() and a.shape == e1.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL_K2)
        np.testing.assert_allclose(a.numpy(), p.numpy(), **TOL_K2)


@pytest.mark.parametrize("split", [40, 14, 6, TGL.SPLIT])
def test_passes_with_bf16_inputs(split):
    e1, e2 = _emb(7, 40, 48)
    tv = _taus(7, 40, 0.05)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (e1, e2)]
    tb = [t(x).to(torch.bfloat16) for x in (e1, e2)]
    want = JGL.gcl_pair_stats(*jb, tv[0], tv[1], interpret=True)
    got = _stats_split(*tb, t(tv[0]), t(tv[1]), split)
    for i in (0, 1):       # log g = m + log(g), as tests/test_kernels.py
        lg = got[4 + i] + torch.log(got[i])
        lw = np.asarray(want[4 + i]) + np.log(np.asarray(want[i]))
        np.testing.assert_allclose(lg.numpy(), lw, atol=TOL_K1_BF16_LOG)
    lwt = _lwt(8, e1, e2, tv, clamp_row=5)
    want = JGL.gcl_pair_grads(*jb, lwt[0], lwt[1], tv[0], tv[1],
                              interpret=True)
    got = _grads_split(*tb, *(t(a) for a in (lwt[0], lwt[1], tv[0], tv[1])),
                       split)
    plain = TGL.gcl_pair_grads_plain(*tb, *(t(a) for a in (
        lwt[0], lwt[1], tv[0], tv[1])))
    for a, w, p in zip(got, want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(w, np.float32),
                                   **TOL_K2)
        np.testing.assert_allclose(a.numpy(), p.numpy(), **TOL_K2)


def test_all_masked_splits_merge_to_the_one_pass_result():
    """A split whose only column is the anchor's own leaves m = MASK_NEG,
    g = dg = 0, and merges with no NaN; a row with no unmasked column at
    all (B = 1) merges to m = MASK_NEG, g = dg = 0, as the one pass."""
    e1a, e2a = (t(x) for x in _emb(9, 33, 16))
    tv = t(_taus(9, 33, 0.05))
    e1, e2, sd, t1, t2, denom = (e1a, e2a, *TGL._stats_args(
        e1a, e2a, tv[0], tv[1], None, None)[2:])
    part = TGL.stats_partial_plain(e1, e2, e1, e2, sd, t1, t2, 0)
    assert part.shape == (2, 3, 2, 33)
    assert (part[:, 0, 1, 32] == MASK_NEG).all()
    assert (part[:, 1:, 1, 32] == 0).all()
    got = TGL.stats_merge_plain(part, denom)
    assert torch.isfinite(got).all()
    for a, w in zip(got, TGL.gcl_pair_stats_plain(e1, e2, tv[0], tv[1])):
        torch.testing.assert_close(a, w, rtol=TOL_K1, atol=TOL_K1)
    one = TGL.stats_merge_plain(TGL.stats_partial_plain(
        e1[:1], e2[:1], e1[:1], e2[:1], sd[:1], t1[:1], t2[:1], 0), 1.0)
    assert torch.equal(one, torch.tensor([[0.0], [0.0], [0.0], [0.0],
                                          [MASK_NEG], [MASK_NEG]]))


def test_pass_entry_points_take_the_plain_versions_on_the_cpu():
    e1a, e2a = (t(x) for x in _emb(10, 48, 24))
    tv = t(_taus(10, 48, "rows"))
    lw = t(_lwt(11, e1a.numpy(), e2a.numpy(), tv.numpy(), clamp_row=3))
    before = (TGL.gcl_pair_stats.launches, TGL.gcl_pair_stats.cuda_launches,
              TGL.gcl_pair_grads.launches, TGL.gcl_pair_grads.cuda_launches)
    e1a_, e2a_, sd, t1, t2, denom = TGL._stats_args(e1a, e2a, tv[0], tv[1],
                                                    None, None)
    part = TGL.stats_partial(e1a, e2a, e1a_, e2a_, sd, t1, t2, 0)
    stats = TGL.stats_merge(part, denom)
    args, kappa = TGL._grads_args(e1a, e2a, lw[0], lw[1], tv[0], tv[1],
                                  *([None] * 7))
    pw, r = TGL.grads_weights(e1a, e2a, *args, 0)
    out = TGL.grads_product(pw, args[0], args[1], e1a, e2a, r, kappa)
    assert (TGL.gcl_pair_stats.launches, TGL.gcl_pair_stats.cuda_launches,
            TGL.gcl_pair_grads.launches,
            TGL.gcl_pair_grads.cuda_launches) == before
    assert part.shape == (2, 3, 2, 48) and pw.shape == (2, 48, 64)
    assert r.shape == (2, 2, 48) and out.shape == (2, 48, 24)
    torch.testing.assert_close(stats, torch.stack(TGL.gcl_pair_stats(
        e1a, e2a, tv[0], tv[1])), rtol=TOL_K1, atol=TOL_K1)
    for a, w in zip(out, TGL.gcl_pair_grads(e1a, e2a, lw[0], lw[1], tv[0],
                                            tv[1])):
        torch.testing.assert_close(a, w, **TOL_K2)


# ---------------------------------------------------------------------------
# The kernels' split-TF32 arithmetic at the training shape
# ---------------------------------------------------------------------------

def trunc(x):
    """f32 truncated to TF32 (its top 19 bits), as the tensor cores read
    an f32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _rz(x):
    """f64 -> f32 rounded toward zero, as the tensor cores round the sums
    they accumulate."""
    f = x.float()
    over = f.double().abs() > x.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def tc_matmul(terms=3, flush=True):
    """a @ b as the kernels compute it on the tensor cores: 8-wide steps
    of exact products whose sum is truncated into the accumulator;
    ``terms`` 3: hi*hi, and the small terms lo*hi and hi*lo in a second
    accumulator, or 1: one TF32 product; ``flush``: each 32-wide chunk's
    hi*hi sum added to an f32 total rounded to nearest, else one
    accumulator over the whole contraction."""
    def mm(a, b):
        a, b = a.float(), b.float()
        pad = (-a.shape[1]) % 32              # the kernels zero-fill
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        ah, bh = trunc(a), trunc(b)
        al, bl = trunc(a - ah), trunc(b - bh)
        total = big = small = torch.zeros((a.shape[0], b.shape[1]))
        for k in range(0, a.shape[1], 8):
            sl = slice(k, k + 8)
            if terms == 3:
                small = _rz(small.double() + al[:, sl].double()
                            @ bh[sl].double())
                small = _rz(small.double() + ah[:, sl].double()
                            @ bl[sl].double())
            big = _rz(big.double() + ah[:, sl].double() @ bh[sl].double())
            if flush and (k + 8) % 32 == 0:
                total, big = total + big, torch.zeros_like(big)
        return total + big + small
    return mm


def _training_inputs():
    """256 x 512 f32 rows, per-row taus down to 0.01 (every third row),
    log-weights as the loss op makes them (lwt = -log u with u tracking g,
    times a random factor), one clamped row."""
    e1, e2 = (t(x) for x in _emb(12, 256, 512))
    tv = t(_taus(12, 256, "rows"))
    g1, g2, _, _, m1, m2 = TGL.gcl_pair_stats_plain(e1, e2, tv[0], tv[1])
    rng = np.random.default_rng(13)
    lw = torch.stack([-(m1 + torch.log(g1)), -(m2 + torch.log(g2))]) \
        + t(np.log(rng.random((2, 256)) + 0.2).astype(np.float32))
    lw[0, 7] = 80.0
    return e1, e2, tv, lw


def f64_product(a, b):
    """K2's second product as the kernel computes it for f32 inputs: exact
    products summed in f64 (the f64 tensor cores), rounded once."""
    return (a.double() @ b.double()).float()


def _tc_results(monkeypatch, inputs, **kw):
    e1, e2, tv, lw = inputs
    want = (TGL.gcl_pair_stats_plain(e1, e2, tv[0], tv[1]),
            TGL.gcl_pair_grads_plain(e1, e2, lw[0], lw[1], tv[0], tv[1]))
    monkeypatch.setattr(TGL, "_matmul", tc_matmul(**kw))
    monkeypatch.setattr(TGL, "_product", f64_product)
    got = (_stats_split(e1, e2, tv[0], tv[1], TGL.SPLIT),
           _grads_split(e1, e2, lw[0], lw[1], tv[0], tv[1], TGL.SPLIT))
    return got, want


def _misses(got, want):
    """(K1 misses, K2 misses): outputs outside the tolerances."""
    k1 = [i for i, (a, w) in enumerate(zip(got[0], want[0]))
          if not torch.allclose(a, w, rtol=TOL_K1, atol=TOL_K1)]
    k2 = [i for i, (a, w) in enumerate(zip(got[1], want[1]))
          if not torch.allclose(a, w, **TOL_K2)]
    return k1, k2


def test_split_tf32_within_tolerances_at_training_shape(monkeypatch):
    got, want = _tc_results(monkeypatch, _training_inputs())
    assert _misses(got, want) == ([], [])


def test_single_tf32_misses_the_tolerances(monkeypatch):
    """One TF32 product per f32 product (10 mantissa bits) is not enough:
    at tau = 0.01 a similarity error of ~1e-4 moves z by ~1e-2."""
    got, want = _tc_results(monkeypatch, _training_inputs(), terms=1)
    k1, k2 = _misses(got, want)
    assert k1 and k2


def _wide_inputs():
    """48 rows of d = 3072 (``tests/test_torch_cuda.py``'s wide case)."""
    e1, e2 = (t(x) for x in _emb(14, 48, 3072))
    tv = torch.full((2, 48), 0.06)
    g1, g2, _, _, m1, m2 = TGL.gcl_pair_stats_plain(e1, e2, tv[0], tv[1])
    lw = torch.stack([-(m1 + torch.log(g1)), -(m2 + torch.log(g2))])
    return e1, e2, tv, lw


@pytest.mark.parametrize("flush", [True, False])
def test_truncated_sums_need_a_flush_per_chunk_at_wide_d(monkeypatch,
                                                         flush):
    """At d = 3072 (384 8-wide steps) the tensor cores' truncated sums
    drift past K1's tolerance in one accumulator; added chunk by chunk
    to a total rounded to nearest, as the kernels do, they stay within."""
    got, want = _tc_results(monkeypatch, _wide_inputs(), flush=flush)
    k1, k2 = _misses(got, want)
    assert (k1 == []) == flush and k2 == []


def _collinear_inputs(spread, n=256, d=1024, seed=15):
    """Unit rows at ``spread`` around one direction: at 0.005 their
    cosines are ~1, as a random-init ResNet-50's embeddings are."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(d)

    def rows():
        x = c + spread * rng.standard_normal((n, d))
        return t((x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32))
    return rows(), rows(), torch.full((n,), 0.07)


def _stats_f64(monkeypatch, e1, e2, tv):
    """K1's statistics in f64, similarities included."""
    e1, e2, tv = e1.double(), e2.double(), tv.double()
    with monkeypatch.context() as m:
        m.setattr(TGL, "_matmul", lambda a, b: a @ b)
        out = TGL._stats_plain(e1, e2, e1, e2, (e1 * e2).sum(-1), tv, tv, 0)
    return [x / (e1.shape[0] - 1) for x in out[:4]] + list(out[4:])


def _tol_ratio(got, ref):
    return ((got.double() - ref).abs() / (TOL_K1 + TOL_K1 * ref.abs())
            ).max().item()


@pytest.mark.parametrize("spread", [0.005, 1.0])
def test_split_tf32_against_f64_on_near_collinear_rows(monkeypatch,
                                                       spread):
    """On rows near one direction the f32 rounding of the similarities
    moves dg (divided by tau^2) past TOL_K1 in the plain version itself,
    so ``chip_smoke.py`` holds K1 on the ResNet-50's eval embeddings to
    an f64 evaluation: within TOL_K1 of it, or no farther than 2^3 times
    the plain version (the split carries 21 bits of each f32 operand, an
    f32 product 24).  The kernels' arithmetic, emulated, meets that; its
    truncating split puts dg ~4x farther than the plain version."""
    e1, e2, tv = _collinear_inputs(spread)
    exact = _stats_f64(monkeypatch, e1, e2, tv)
    plain = TGL.gcl_pair_stats_plain(e1, e2, tv, tv)
    monkeypatch.setattr(TGL, "_matmul", tc_matmul())
    kern = _stats_split(e1, e2, tv, tv, TGL.SPLIT)
    ratio = {n: (_tol_ratio(k, x), _tol_ratio(p, x)) for n, k, p, x in zip(
        ("g1", "g2", "dg1", "dg2", "m1", "m2"), kern, plain, exact)}
    print(f"spread {spread}: TOL_K1 ratio against f64 (kernel, plain)",
          {n: (round(a, 3), round(b, 3)) for n, (a, b) in ratio.items()})
    assert all(rk <= max(1.0, 8.0 * rp) for rk, rp in ratio.values())
    if spread < 0.01:
        assert ratio["dg1"][1] > 1.0 and ratio["dg2"][1] > 1.0
