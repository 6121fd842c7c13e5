"""The f32 arithmetic of the flash-attention kernel, emulated on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/flash_attention.cu``)
runs f32 inputs on the tensor cores through split TF32: each operand is
``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, and each
product is ``hi*hi + hi*lo + lo*hi`` accumulated in f32, inside an online
softmax over 64-key tiles (max in score units, exponents in base 2 with
the scale folded in).  ``split_attention`` below
does the same arithmetic in torch (TF32 rounding by integer bit
operations on f32), so the numerical design is checked here against the
plain version and the JAX kernel (Pallas interpret mode) at the
reference's f32 tolerance, 1e-5 (tests/test_precision_flash.py).  A
single TF32 product misses that tolerance, which shows the test can
fail.  (The kernel rounds to TF32 with ``cvt.rna``, ties away from zero;
the emulation rounds ties to even; the two differ only at exact ties.)
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro_torch.kernels import flash_attention as TFA


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
NEG = -1e30
BK = 64        # the kernel's key tile


def tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, terms):
    """einsum of f32 operands as the tensor cores do it: 3 TF32 products
    (hi*hi + hi*lo + lo*hi, f32 sums) or a single one (hi*hi)."""
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def split_attention(q, k, v, *, causal, window, terms=3):
    """The kernel's f32 arithmetic: (B, H, S, hd) f32 -> (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale_log2 = torch.tensor((1.0 / math.sqrt(hd)) * math.log2(math.e),
                              dtype=torch.float32)
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq), NEG)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Sk, BK):
        kt, vt = k[:, :, k0:k0 + BK], v[:, :, k0:k0 + BK]
        k_pos = k0 + torch.arange(kt.shape[2])[None, :]
        mask = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, _product("bhqd,bhkd->bhqk", q, kt, terms),
                        NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * scale_log2)
        p = torch.where(mask, torch.exp2(s * scale_log2
                                         - (m_new * scale_log2)[..., None]),
                        0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _product("bhqk,bhkd->bhqd", p, vt,
                                                terms)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def _qkv(B, H, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, S, hd),
                                                 dtype=np.float32))
            for S in (Sq, Sk, Sk)]


def _err(a, b):
    return (a - b).abs().max().item()


def test_tf32_rounds_to_nearest_even_at_10_bits():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2,       # tie, rounds to the even 1.0
                      one + 3 * ulp / 2,   # tie, rounds to the even 1 + 2 ulp
                      one + ulp / 2 + 2.0 ** -20,   # above the tie: up
                      -(one + 3 * ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = [one, one + 2 * ulp, one + ulp, -(one + 2 * ulp), 3.0, 0.0]
    assert tf32(x).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000, dtype=np.float32)) * 1e3
    t = tf32(r)
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()          # 10 bits
    assert ((t - r).abs() <= r.abs() * 2.0 ** -11).all()        # half ulp
    # hi + lo carries 21+ bits: the split alone is within 2^-21
    lo = tf32(r - t)
    assert ((t + lo - r).abs() <= r.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,window", [
    (2, 3, 50, 50, 64, False, 0),       # ViT serving shape
    (2, 3, 77, 77, 64, True, 0),        # text serving shape
    (2, 3, 64, 300, 64, False, 0),      # Sq != Sk, ragged key tiles
    (2, 3, 130, 130, 64, True, 17),     # window across key tiles
    (2, 3, 37, 37, 32, False, 9),       # window, non-causal, ragged S
    (2, 3, 90, 40, 32, True, 0),        # causal with Sq > Sk
    (1, 2, 10, 10, 64, True, 0),        # below one tile
])
def test_split_tf32_matches_plain_and_jax(B, H, Sq, Sk, hd, causal, window):
    q, k, v = _qkv(B, H, Sq, Sk, hd, seed=Sq * 7 + Sk)
    got = split_attention(q, k, v, causal=causal, window=window)
    ref = TFA.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert _err(got, ref) <= TOL
    jx = JFA.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             causal=causal, window=window, interpret=True)
    assert _err(got, torch.from_numpy(np.array(jx))) <= TOL


def test_split_tf32_at_long_causal_and_single_tf32_misses():
    """1 x 2 x 1024 x 1024 x 64 causal: the three-product split stays
    within 1e-5 of the plain version; one TF32 product (about three
    decimal digits) does not."""
    q, k, v = _qkv(1, 2, 1024, 1024, 64, seed=1024)
    ref = TFA.flash_attention_ref(q, k, v, causal=True)
    split = _err(split_attention(q, k, v, causal=True, window=0), ref)
    single = _err(split_attention(q, k, v, causal=True, window=0, terms=1),
                  ref)
    assert split <= TOL, split
    assert single > 10 * TOL, single
