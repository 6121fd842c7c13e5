"""The port's attention (``repro_torch.kernels.flash_attention`` and
``repro_torch.models.attention``) against the JAX package on the same
numpy-seeded inputs.  On the CPU the port's flash wrapper runs its plain
version; the JAX kernel runs in Pallas interpret mode.  Tolerances are
those of tests/test_precision_flash.py: f32 1e-5, bf16 1e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as TFA
from repro_torch.models import attention as TA


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _qkv(B, H, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, hd), dtype=np.float32)
            for S in (Sq, Sk, Sk)]


def _both(arrs, dtype):
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (50, 50, False, 0),     # ViT serving shape
    (77, 77, True, 0),      # text serving shape
    (64, 300, False, 0),    # Sq != Sk
    (130, 130, True, 17),   # sliding window across tiles
    (37, 37, False, 9),     # window, non-causal, ragged S
    (90, 40, True, 0),      # causal with Sq > Sk
])
def test_flash_attention_plain_matches_jax(Sq, Sk, causal, window, dtype):
    arrs = _qkv(2, 3, Sq, Sk, 32, seed=Sq + Sk)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    out = TFA.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == tq.shape
    ref_kernel = JFA.flash_attention(jq, jk, jv, causal=causal,
                                     window=window, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(ref_kernel),
                               atol=TOL[dtype], rtol=0)
    # the naive oracle takes (B, S, H, hd) and f32 inputs, as the JAX
    # package's own flash test uses it
    up = [jnp.asarray(_f32(t)).transpose(0, 2, 1, 3) for t in (tq, tk, tv)]
    ref_naive = JA.naive_attention(*up, causal=causal, window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref_naive).transpose(
        0, 2, 1, 3), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_layout_and_chunked_match_jax(causal):
    """(B, S, H, hd) entry point and the chunked path, several blocks."""
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(2, 4, 70, 70, 16, 1))
    jx = [jnp.asarray(a) for a in (q, k, v)]
    tx = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v)]
    want = JA.chunked_attention(*jx, causal=causal, q_chunk=16, kv_chunk=24)
    got_mha = TFA.flash_mha(*tx, causal=causal)
    got_chunk = TA.chunked_attention(*tx, causal=causal, q_chunk=16,
                                     kv_chunk=24)
    got_naive = TA.naive_attention(*tx, causal=causal)
    for got in (got_mha, got_chunk, got_naive):
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_fully_masked_rows_give_zero_like_the_kernel():
    """A window past every key of a row (Sq > Sk, causal offsetless
    masks) leaves the row empty: l clamps at 1e-30 and the output is 0."""
    arrs = _qkv(1, 2, 8, 8, 32, seed=3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    # window 1 + causal keeps only the diagonal; then drop keys past 4
    out = TFA.flash_attention(tq, tk[:, :, :4], tv[:, :, :4], causal=True,
                              window=1)
    ref = JFA.flash_attention(jq, jk[:, :, :4], jv[:, :, :4], causal=True,
                              window=1, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-6)
    assert np.all(_f32(out)[:, :, 4:] == 0.0)


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("causal,n_kv,theta", [
    (True, 2, 1e6),     # text tower: causal, GQA (reduced config), RoPE 1e6
    (False, 4, 1e4),    # ViT: non-causal, RoPE 1e4
])
def test_attention_layer_matches_jax(impl, causal, n_kv, theta):
    """Projections + RoPE + GQA repeat + core + output projection, with
    the JAX layer's params loaded into the port's module."""
    spec_j = JA.AttnSpec(d_model=64, n_heads=4, n_kv_heads=n_kv,
                         head_dim=16, rope_theta=theta, causal=causal,
                         q_chunk=8, kv_chunk=16)
    spec_t = TA.AttnSpec(d_model=64, n_heads=4, n_kv_heads=n_kv,
                         head_dim=16, rope_theta=theta, causal=causal,
                         q_chunk=8, kv_chunk=16)
    params = JA.init_attention(jax.random.PRNGKey(5), spec_j)
    x = np.random.default_rng(7).standard_normal((2, 33, 64),
                                                 dtype=np.float32) * 0.5
    mod = TA.Attention(spec_t)
    mod.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in params.items()})
    want = JA.attention(params, spec_j, jnp.asarray(x), impl="naive")
    with torch.inference_mode():
        got = mod(torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_attention_unknown_impl_raises():
    mod = TA.Attention(TA.AttnSpec(d_model=32, n_heads=2, n_kv_heads=2,
                                   head_dim=16))
    with pytest.raises(ValueError, match="unknown attention impl"):
        mod(torch.zeros(1, 4, 32), impl="bogus")


def test_flash_wrapper_never_falls_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes
    to the kernel's launcher, which refuses what is not CUDA (here a
    meta tensor) instead of computing on the CPU."""
    q = torch.empty((1, 2, 8, 64), device="meta")
    before = TFA.flash_attention.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TFA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TFA.flash_mha(q, q, q)
    assert TFA.flash_attention.launches == before


def _cpu_views(hd=64, dtype=torch.float32):
    q, k, v, out = (torch.zeros((2, 3, 40, hd), dtype=dtype)
                    for _ in range(4))
    return q, k, v, out


def _misaligned_ptr(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("what,exc,match", [
    ("float16", TypeError, "float32 or bfloat16"),
    ("mixed_dtype", TypeError, "q is torch.float32"),
    ("hd_not_contiguous", ValueError, "contiguous"),
    ("misaligned_pointer", ValueError, "16-byte aligned"),
    ("misaligned_s_stride", ValueError, "16-byte aligned"),
    ("misaligned_bf16_h_stride", ValueError, "16-byte aligned"),
    ("head_dim_48", ValueError, "head dim"),
    ("head_dim_96", ValueError, "head dim"),
    ("shape", ValueError, "shape mismatch"),
    ("window", ValueError, "window"),
])
def test_flash_check_inputs_refuses_on_cpu(what, exc, match):
    """Every refusal of the kernel's launcher, reached on CPU tensors
    through ``check_inputs`` (the launcher calls it before any launch)."""
    q, k, v, out = _cpu_views()
    window = 0
    if what == "float16":
        q, k, v, out = (t.half() for t in (q, k, v, out))
    elif what == "mixed_dtype":
        v = v.bfloat16()
    elif what == "hd_not_contiguous":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif what == "misaligned_pointer":
        q = _misaligned_ptr(q)
    elif what == "misaligned_s_stride":        # S stride hd + 1 elements
        v = torch.zeros((2, 3, 40, 65))[..., :64]
    elif what == "misaligned_bf16_h_stride":   # H stride 40*64 + 4 bf16
        q, k, v, out = _cpu_views(dtype=torch.bfloat16)
        out = torch.zeros((2, 3, 40 * 64 + 4), dtype=torch.bfloat16)[
            ..., :40 * 64].view(2, 3, 40, 64)
    elif what.startswith("head_dim"):
        q, k, v, out = _cpu_views(hd=int(what.split("_")[-1]))
    elif what == "shape":
        k = torch.zeros((2, 3, 40, 32))
    elif what == "window":
        window = -1
    with pytest.raises(exc, match=match):
        TFA.check_inputs(q, k, v, out, window)


def test_flash_check_inputs_takes_the_main_paths_layouts():
    """Fresh (B, H, S, hd) tensors, the (B, S, H, hd) views ``flash_mha``
    hands the launcher, every head dim and both dtypes, and a size-1
    dimension whose stride is odd (never used) all pass."""
    for hd in (32, 64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, out = _cpu_views(hd, dtype)
            TFA.check_inputs(q, k, v, out)
            bshd = [torch.zeros((2, 40, 3, hd), dtype=dtype)
                    for _ in range(4)]
            TFA.check_inputs(*(t.transpose(1, 2) for t in bshd))
    odd = torch.zeros((1, 3, 40, 64)).as_strided((1, 3, 40, 64),
                                                 (7, 40 * 64, 64, 1))
    q, k, v, out = _cpu_views()
    TFA.check_inputs(odd, k[:1], v[:1], out[:1])
