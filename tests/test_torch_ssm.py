"""The port's SSD scans and Mamba2 block (``repro_torch.models.ssm``,
``repro_torch.kernels.ssd_chunk``) on the CPU against the JAX package.
Inputs are made with numpy from a seed and go through both packages.
Tolerances: the scans and the block 1e-5 against JAX (the same algorithm
in f32), the plain K4 against the Pallas kernel in interpret mode 1e-5
and against the sequential oracle 2e-4 (``tests/test_kernels.py``), the
port's decode against its forward 1e-4 (``tests/test_ssm.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.kernels.ssd_chunk import ssd_chunked_pallas
from repro.models import ssm as JS
from repro_torch.checkpoint import bridge
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import ssd_chunk as K4
from repro_torch.models import ssm as TS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(B=2, T=48, H=3, P=8, N=4, seed=0, dt_scale=1.0):
    """test_ssm.py's shapes and distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), dtype=np.float32)
    log_a = (-np.logaddexp(0.0, rng.standard_normal((B, T, H)))
             * dt_scale).astype(np.float32)
    Bm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    return x, log_a, Bm, Cm


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("T,chunk", [(48, 16), (48, 48), (50, 16), (7, 16)])
def test_ssd_scans_match_jax(T, chunk):
    inp = _inputs(T=T)
    jin = [jnp.asarray(a) for a in inp]
    for jfn, tfn in ((JS.ssd_sequential, TS.ssd_sequential),
                     (lambda *a: JS.ssd_chunked(*a, chunk=chunk),
                      lambda *a: TS.ssd_chunked(*a, chunk=chunk))):
        jy, jS = jfn(*jin)
        ty, tS = tfn(*_t(inp))
        assert ty.shape == (2, T, 3, 8) and tS.shape == (2, 3, 4, 8)
        _close(ty, jy, 1e-5)
        _close(tS, jS, 1e-5)


def test_ssd_decode_step_matches_jax_and_continues_sequence():
    inp = _inputs(T=20)
    x, la, Bm, Cm = _t(inp)
    y_all, _ = TS.ssd_sequential(x, la, Bm, Cm)
    _, S = TS.ssd_sequential(x[:, :15], la[:, :15], Bm[:, :15], Cm[:, :15])
    jS = jnp.asarray(S.numpy())
    for t in range(15, 20):
        S, y = TS.ssd_decode_step(S, x[:, t], la[:, t], Bm[:, t], Cm[:, t])
        jS, jy = JS.ssd_decode_step(jS, *(jnp.asarray(a[:, t]) for a in inp))
        _close(y, jy, 1e-5)
        _close(S, jS, 1e-5)
        _close(y, y_all[:, t], 1e-4)


@pytest.mark.parametrize("T,chunk", [(64, 16), (128, 32), (60, 16)])
def test_ssd_chunk_plain_matches_pallas_and_oracle(T, chunk):
    """tests/test_kernels.py's cases: B 2, H 3, P 8, N 4."""
    inp = _inputs(T=T, seed=7)
    want = ssd_chunked_pallas(*(jnp.asarray(a) for a in inp), chunk=chunk,
                              interpret=True)
    got = K4.ssd_chunk_plain(*_t(inp), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (2, T, 3, 8)
    _close(got, want, 1e-5)
    _close(got, TREF.ssd_chunk_ref(*_t(inp)), 2e-4)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = K4.ssd_chunk.launches
    assert torch.equal(K4.ssd_chunk(*_t(inp), chunk=chunk), got)
    assert K4.ssd_chunk.launches == before


def test_ssd_chunk_plain_large_decay_is_exact():
    """dt up to ~10 puts F ~ -600 over a 64-row chunk: the ratio form
    exp(F_i) / exp(F_j) would give 0/0; the difference form matches the
    sequential recurrence."""
    x, la, Bm, Cm = _t(_inputs(T=200, seed=3, dt_scale=10.0))
    assert la.min().item() < -20.0 and la.sum(1).min().item() < -600.0
    y = K4.ssd_chunk_plain(x, la, Bm, Cm, chunk=64)
    assert torch.isfinite(y).all()
    _close(y, TREF.ssd_chunk_ref(x, la, Bm, Cm), 2e-4)


def test_ssd_chunk_plain_computes_in_f64_for_f64_inputs():
    """The f64 yardstick of the card checks: f64 in, f64 math and out,
    within f32 rounding of the f32 scan."""
    inp = _t(_inputs(T=50, seed=6))
    y64 = K4.ssd_chunk_plain(*(a.double() for a in inp), chunk=16)
    assert y64.dtype == torch.float64
    _close(K4.ssd_chunk_plain(*inp, chunk=16), y64, 1e-5)


def test_ssd_chunk_bf16_bc_plain_matches_f32_of_rounded():
    """bf16 B/C: the math is f32 on the bf16 values."""
    x, la, Bm, Cm = _t(_inputs(T=40, seed=4))
    Bb, Cb = Bm.bfloat16(), Cm.bfloat16()
    got = K4.ssd_chunk_plain(x, la, Bb, Cb, chunk=16)
    assert got.dtype == torch.float32
    assert torch.equal(got, K4.ssd_chunk_plain(x, la, Bb.float(), Cb.float(),
                                               chunk=16))


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = j_get_arch("zamba2-1.2b").reduced()
    tcfg = t_get_arch("zamba2-1.2b").reduced()
    jp = JS.init_mamba2(jax.random.PRNGKey(0), jcfg)
    flat = {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    m = TS.Mamba2(tcfg)
    bridge.load_tree(m, flat)
    x = (np.random.default_rng(5).standard_normal((2, 40, tcfg.d_model))
         * 0.3).astype(np.float32)
    return jcfg, tcfg, jp, m, x


@pytest.mark.parametrize("impl,chunked", [("flash", True), ("chunked", True),
                                          ("naive", False)])
def test_mamba2_block_matches_jax(block, impl, chunked):
    jcfg, tcfg, jp, m, x = block
    want = JS.apply_mamba2(jp, jcfg, jnp.asarray(x), chunked=True)
    with torch.inference_mode():
        got = TS.apply_mamba2(m, tcfg, torch.from_numpy(x), impl=impl,
                              chunked=chunked)
    _close(got, want, 1e-5)


def test_mamba2_decode_matches_jax_and_forward(block):
    jcfg, tcfg, jp, m, x = block
    T = 12
    jcache = JS.init_mamba2_cache(jcfg, 2)
    cache = TS.init_mamba2_cache(tcfg, 2)
    outs = []
    with torch.inference_mode():
        for t in range(T):
            o, cache = TS.decode_mamba2(m, tcfg, cache,
                                        torch.from_numpy(x[:, t:t + 1]))
            jo, jcache = JS.decode_mamba2(jp, jcfg, jcache,
                                          jnp.asarray(x[:, t:t + 1]))
            _close(o, jo, 1e-5)
            outs.append(o)
        _close(cache["S"], jcache["S"], 1e-5)
        _close(cache["conv"], jcache["conv"], 1e-5)
        fwd = TS.apply_mamba2(m, tcfg, torch.from_numpy(x[:, :T]),
                              chunked=False)
    _close(torch.cat(outs, dim=1), fwd, 1e-4)


def test_mamba2_rejects_unknown_impl(block):
    _, tcfg, _, m, x = block
    with pytest.raises(ValueError, match="unknown impl"):
        TS.apply_mamba2(m, tcfg, torch.from_numpy(x), impl="pallas")
