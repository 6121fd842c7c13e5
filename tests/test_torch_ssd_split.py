"""The four passes of the SSD chunk-scan kernel K4, on the CPU.

On the card ``repro_torch.kernels.ssd_chunk`` runs the scan as four
passes (``csrc/ssd_chunk.cu``): C B^T once per chunk, each chunk's cumsum
and local state, the state pass across chunks, and the outputs.  Each
pass has a plain PyTorch version on the kernel's scratch layouts; here
their composition is held to the JAX package at ``tests/test_kernels.py``'s
shapes: 1e-5 against the Pallas kernel in interpret mode and against
``repro.models.ssm.ssd_chunked`` (y and the final state), 2e-4 against the
sequential oracle (the reference's tolerance).

The products of passes 1, 2 and 4 run on the tensor cores through split
TF32 (``csrc/mma_tf32.cuh``): each f32 operand is ``hi + lo`` with ``hi``
its top 19 bits (TF32) and ``lo = x - hi``, which the tensor cores read
truncated to TF32 too; each product is ``hi*hi + (hi*lo + lo*hi)``, with
the hi*hi products and the small terms summed apart over all of a
chunk's 64-row tiles and added at the end.  ``split_ssd`` does that
arithmetic in torch (truncation by bit operations; the kernel's exp2 by
the SFU is taken as exact) and is held within ``TOL_SSD`` (5e-5 x max(1,
|y|), the kernel's tolerance in ``chip_smoke.py``) of the plain scan at
the zamba2-1.2b widths (P = N = 64, 256-row chunks, |F| up to ~35), while
a single TF32 product misses it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_chunked_pallas
from repro.models import ssm as JS
from repro_torch.kernels import ssd_chunk as K4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL = 1e-5
TOL_ORACLE = 2e-4
TOL_SSD = 5e-5
TILE = 64      # the kernel's row tile


def trunc(x):
    """f32 truncated to TF32 (its top 19 bits), as the tensor cores read
    an f32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _parts(eq, a, b, terms):
    """einsum of f32 operands on the tensor cores: (hi*hi, small terms),
    or a single TF32 product (terms == 1)."""
    ah, bh = trunc(a), trunc(b)
    big = torch.einsum(eq, ah, bh)
    if terms == 1:
        return big, torch.zeros_like(big)
    small = (torch.einsum(eq, trunc(a - ah), bh)
             + torch.einsum(eq, ah, trunc(b - bh)))
    return big, small


def split_ssd(x, log_a, Bm, Cm, chunk, terms=3):
    """The kernel's arithmetic, pass by pass -> y (B, T, H, P)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    Lc = min(chunk, T)
    xc = K4._padded(x, Lc).reshape(B, -1, Lc, H, P)
    nc = xc.shape[1]
    b = K4._padded(Bm, Lc).float().reshape(B, nc, Lc, N)
    c = K4._padded(Cm, Lc).float().reshape(B, nc, Lc, N)
    # 1. G = tril(C B^T)
    G = torch.tril(sum(_parts("bkin,bkjn->bkij", c, b, terms)))
    # 2. the cumsum (the kernel's warp scan rounds it otherwise) and the
    #    local states over the chunk's 64-row tiles
    cum, _ = K4.ssd_chunk_state_plain(x, log_a, Bm, Lc)
    Fc = cum.reshape(B, H, nc, Lc).permute(0, 2, 3, 1)          # (B, nc, Lc, H)
    w = torch.exp(Fc[:, :, -1:] - Fc)
    tiles = [_parts("bkjhn,bkjhp->bhknp",
                    b[:, :, k0:k0 + TILE, None, :]
                    * w[:, :, k0:k0 + TILE, :, None],
                    xc[:, :, k0:k0 + TILE], terms)
             for k0 in range(0, Lc, TILE)]
    S = sum(t[0] for t in tiles) + sum(t[1] for t in tiles)
    # 3. the state pass, f32 on the CUDA cores
    S_in = K4.ssd_state_pass_plain(cum, S, Lc)
    # 4. the inter-chunk part (A = C exp(F_i), V = S_in), then the key tiles
    idx = torch.arange(Lc)
    tril = (idx[:, None] >= idx[None, :])[:, :, None]
    M = torch.where(tril, G[..., None] * torch.exp(
        Fc[:, :, :, None, :] - Fc[:, :, None, :, :]), 0.0)
    tiles = [_parts("bkinh,bhknp->bkihp",
                    c[:, :, :, :, None] * torch.exp(Fc)[:, :, :, None, :],
                    S_in, terms)]
    tiles += [_parts("bkijh,bkjhp->bkihp", M[:, :, :, k0:k0 + TILE],
                     xc[:, :, k0:k0 + TILE], terms)
              for k0 in range(0, Lc, TILE)]
    y = sum(t[0] for t in tiles) + sum(t[1] for t in tiles)
    return y.reshape(B, nc * Lc, H, P)[:, :T]


def compose_plain(x, log_a, Bm, Cm, chunk):
    """The four plain passes -> (y, final state)."""
    Lc = min(chunk, x.shape[1])
    G = K4.ssd_chunk_cb_plain(Bm, Cm, Lc)
    cum, S = K4.ssd_chunk_state_plain(x, log_a, Bm, Lc)
    S_in = K4.ssd_state_pass_plain(cum, S, Lc)
    y = K4.ssd_chunk_scan_plain(x, Cm, G, cum, S_in, Lc)
    FL = cum[:, :, -1]
    return y, torch.exp(FL)[..., None, None] * S_in[:, :, -1] + S[:, :, -1]


def _inputs(B=2, T=60, H=3, P=8, N=4, seed=0):
    """tests/test_kernels.py's shapes and distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), dtype=np.float32)
    log_a = (-np.logaddexp(0.0, rng.standard_normal((B, T, H)))).astype(
        np.float32)
    Bm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    return x, log_a, Bm, Cm


def _model_inputs(B, T, H, P, N, dt_bias, seed):
    """Shaped as ``models.ssm._ssm_inputs`` makes them (dt = softplus(z +
    bias), x scaled by dt, log_a = -dt), as ``chip_smoke.py`` phase ssd."""
    rng = np.random.default_rng(seed)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, T, H), dtype=np.float32)) + dt_bias)
    x = torch.from_numpy(rng.standard_normal((B, T, H, P),
                                             dtype=np.float32)) * dt[..., None]
    bc = torch.from_numpy(rng.standard_normal((B, T, 2 * N),
                                              dtype=np.float32)) * 0.5
    return x, -dt, bc[..., :N], bc[..., N:]


def _err(a, b):
    return (a - b).abs().max().item()


SHAPES = [(T, chunk) for T in (60, 64, 128) for chunk in (16, 32)]


@pytest.mark.parametrize("T,chunk", SHAPES)
def test_passes_match_pallas_interpret(T, chunk):
    inp = _inputs(T=T, seed=T + chunk)
    want = ssd_chunked_pallas(*(jnp.asarray(a) for a in inp), chunk=chunk,
                              interpret=True)
    y, _ = compose_plain(*(torch.from_numpy(a) for a in inp), chunk)
    assert _err(y, torch.from_numpy(np.array(want))) <= TOL


@pytest.mark.parametrize("T,chunk", SHAPES)
def test_passes_match_jax_chunked_and_final_state(T, chunk):
    inp = _inputs(T=T, seed=T + chunk)
    jy, jS = JS.ssd_chunked(*(jnp.asarray(a) for a in inp), chunk=chunk)
    y, S = compose_plain(*(torch.from_numpy(a) for a in inp), chunk)
    assert _err(y, torch.from_numpy(np.array(jy))) <= TOL
    assert _err(S, torch.from_numpy(np.array(jS))) <= TOL


@pytest.mark.parametrize("T,chunk", SHAPES)
def test_passes_match_sequential_oracle(T, chunk):
    inp = _inputs(T=T, seed=T + chunk)
    jy, jS = JS.ssd_sequential(*(jnp.asarray(a) for a in inp))
    y, S = compose_plain(*(torch.from_numpy(a) for a in inp), chunk)
    assert _err(y, torch.from_numpy(np.array(jy))) <= TOL_ORACLE
    assert _err(S, torch.from_numpy(np.array(jS))) <= TOL_ORACLE


def test_passes_with_bf16_bc_match_the_chunk_loop():
    x, la, Bm, Cm = (torch.from_numpy(a) for a in _inputs(T=64, seed=5))
    Bb, Cb = Bm.bfloat16(), Cm.bfloat16()
    y, _ = compose_plain(x, la, Bb, Cb, 16)
    assert y.dtype == torch.float32
    assert _err(y, K4.ssd_chunk_plain(x, la, Bb, Cb, chunk=16)) <= TOL


def test_pass_entry_points_take_the_plain_versions_on_the_cpu():
    x, la, Bm, Cm = (torch.from_numpy(a) for a in _inputs(T=60, seed=6))
    Lc = 16
    before = (K4.ssd_chunk.launches, K4.ssd_chunk.cuda_launches)
    G = K4.ssd_chunk_cb(Bm, Cm, Lc)
    cum, S = K4.ssd_chunk_state(x, la, Bm, Lc)
    S_in = K4.ssd_state_pass(cum, S, Lc)
    y = K4.ssd_chunk_scan(x, Cm, G, cum, S_in, Lc)
    assert (K4.ssd_chunk.launches, K4.ssd_chunk.cuda_launches) == before
    assert G.shape == (2, 4, Lc, Lc) and cum.shape == (2, 3, 4 * Lc)
    assert S.shape == S_in.shape == (2, 3, 4, 4, 8)
    assert torch.equal(y, compose_plain(x, la, Bm, Cm, Lc)[0])


# name, T, dt bias: one 256-row chunk of state handed on (T 512), a ragged
# T, and a large decay (dt ~ 8..10, |F| ~ 2500 over a chunk)
SPLIT_CASES = [("two_chunks", 512, -2.0), ("ragged", 300, -2.0),
               ("large_decay", 512, 8.0)]


@pytest.mark.parametrize("name,T,dt_bias", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_tf32_scan_within_tol(name, T, dt_bias):
    x, la, Bm, Cm = _model_inputs(1, T, 2, 64, 64, dt_bias, seed=T)
    ref = K4.ssd_chunk_plain(x, la, Bm, Cm, chunk=256)
    scale = max(1.0, ref.abs().max().item())
    assert _err(split_ssd(x, la, Bm, Cm, 256), ref) <= TOL_SSD * scale


def test_single_tf32_misses_tol():
    x, la, Bm, Cm = _model_inputs(1, 512, 2, 64, 64, -2.0, seed=512)
    assert -la.reshape(2, 256, 2).sum(1).min().item() > 20   # |F| reaches ~35
    ref = K4.ssd_chunk_plain(x, la, Bm, Cm, chunk=256)
    scale = max(1.0, ref.abs().max().item())
    single = _err(split_ssd(x, la, Bm, Cm, 256, terms=1), ref)
    assert single > 5 * TOL_SSD * scale, single


def _refusal(case):
    x, la, Bm, Cm = (torch.from_numpy(a) for a in _inputs(T=64, seed=7))
    Lc = 16
    if case == "chunk":
        Lc = 512
    elif case == "wide_p":
        x = torch.zeros((2, 64, 3, 128))
    elif case == "wide_n":
        Bm = Cm = torch.zeros((2, 64, 80))
    elif case == "x_dtype":
        x = x.double()
    elif case == "bc_dtypes":
        Cm = Cm.bfloat16()
    elif case == "log_a_shape":
        la = la[:, :32]
    elif case == "bc_shape":
        Bm = Bm[:, :32]
    elif case == "x_stride":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    return x, la, Bm, Cm, Lc


@pytest.mark.parametrize("case,error", [
    ("chunk", ValueError), ("wide_p", ValueError), ("wide_n", ValueError),
    ("x_dtype", TypeError), ("bc_dtypes", TypeError),
    ("log_a_shape", ValueError), ("bc_shape", ValueError),
    ("x_stride", ValueError)])
def test_check_inputs_refuses_what_the_kernels_do_not_take(case, error):
    """The checks run on any device, before any launch."""
    x, la, Bm, Cm, Lc = _refusal(case)
    with pytest.raises(error):
        K4.check_inputs(x, la, Bm, Cm, Lc)


def test_check_inputs_takes_the_model_layout():
    x, la, Bm, Cm = (torch.from_numpy(a) for a in _inputs(T=64, seed=8))
    bc = torch.cat([Bm, Cm], dim=-1)          # strided views of one buffer
    K4.check_inputs(x, la, bc[..., :4], bc[..., 4:], 16)
    K4.check_inputs(x, la, Bm.bfloat16(), Cm.bfloat16(), 64)
