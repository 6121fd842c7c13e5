"""The port's CUDA kernels on the card, held to their plain PyTorch
versions.  Every test here needs an NVIDIA GPU: it carries the ``cuda``
marker and skips itself without one.  The file imports neither jax nor
``repro``, so it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports jax).  Tolerances:
attention f32 1e-5, bf16 1e-2, as tests/test_precision_flash.py; the loss
kernels those of tests/test_kernels.py; K4 ``TOL_SSD`` below."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels import flash_attention as FA  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, B, H, Sq, Sk, hd, dtype):
    return [torch.randn((B, H, S, hd), generator=gen, device="cuda").to(
        dtype) for S in (Sq, Sk, Sk)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,window", [
    (8, 12, 50, 50, 64, False, 0),      # ViT serving shape
    (8, 8, 77, 77, 64, True, 0),        # text serving shape
    (2, 4, 64, 300, 64, False, 0),      # Sq != Sk
    (2, 4, 200, 70, 32, True, 0),       # causal, Sq > Sk
    (2, 4, 130, 130, 64, True, 17),     # window across tiles
    (1, 2, 1000, 1000, 64, False, 40),  # long, ragged, window only
    (2, 4, 200, 200, 64, True, 0),      # S ragged against the 64-key tile
    (3, 2, 10, 10, 64, False, 0),       # S below one tile
    (3, 2, 10, 10, 32, True, 0),
    (256, 12, 50, 50, 64, False, 0),    # ViT training shape (batch 256)
    (256, 8, 77, 77, 64, True, 0),      # text training shape
    (256, 12, 197, 197, 64, False, 0),  # ViT-B/16 training shape (14 x 14
                                        # patches and the class token)
    (256, 12, 2, 2, 64, False, 0),      # curriculum: a 32 px image (1 patch)
    (256, 8, 32, 32, 64, True, 0),      # curriculum: a 32-token context
    # head dim 128: the dense LMs (qwen3-1.7b 16 heads over 8 KV heads,
    # repeated before the call; qwen1.5-32b 40 heads)
    (2, 16, 1024, 1024, 128, True, 0),  # qwen3's heads, a shorter prefill
    (1, 40, 256, 256, 128, True, 0),    # qwen1.5-32b's heads
    (2, 4, 77, 77, 128, True, 0),       # ragged S
    (2, 4, 300, 300, 128, True, 100),   # window across tiles
    (2, 4, 64, 300, 128, False, 0),     # Sq != Sk
    (2, 4, 200, 70, 128, True, 0),      # causal, Sq > Sk
    (3, 2, 10, 10, 128, False, 0),      # S below one tile
    # cross-attention, non-causal at Sq != Sk: llama-3.2-vision-11b's cross
    # blocks (32 heads over its 8 KV heads repeated, 1024 image tokens) and
    # seamless-m4t-large-v2's decoder over its encoder (4096 // 4 frames);
    # its causal encoder over the frames
    (2, 32, 4096, 1024, 128, False, 0),
    (2, 16, 4096, 1024, 64, False, 0),
    (2, 16, 1024, 1024, 64, True, 0),
])
def test_flash_kernel_matches_plain(cuda, B, H, Sq, Sk, hd, causal, window,
                                    dtype):
    q, k, v = _qkv(cuda, B, H, Sq, Sk, hd, dtype)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    mha = FA.flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal, window=window)
    ref = FA.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 2
    assert out.dtype == dtype and mha.dtype == dtype
    for got in (out, mha.transpose(1, 2)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 2, 8, 8, 64, torch.float32)
    before = FA.flash_attention.launches
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.half(), v)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(*(t[..., :48].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q, k, v.transpose(2, 3).contiguous().transpose(
            2, 3))
    with pytest.raises(ValueError, match="is on"):
        FA.flash_attention(q, k.cpu(), v)
    # rows that are not 16-byte aligned: a view one element into a buffer,
    # and an S stride of hd + 1 elements
    flat = torch.randn(q.numel() + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention(flat[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention(q, k, torch.randn((1, 2, 8, 65), device="cuda")[
            ..., :64])
    assert FA.flash_attention.launches == before


@pytest.mark.cuda
def test_reduced_towers_flash_match_plain_on_card(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    from repro_torch.models import clip as C
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    model = BB.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    c = cfg.clip
    batch = {"images": torch.randn((4, c.image_size, c.image_size, 3),
                                   generator=cuda, device="cuda"),
             "texts": torch.randint(0, cfg.vocab_size,
                                    (4, c.context_length), generator=cuda,
                                    device="cuda")}
    with torch.inference_mode():
        flash = C.encode_pair(model, batch, impl="flash")
        naive = C.encode_pair(model, batch, impl="naive")
    for a, b in zip(flash, naive):
        assert (a - b).abs().max().item() <= 1e-5 * max(
            1.0, b.abs().max().item())


# ---------------------------------------------------------------------------
# Attention gradients through the kernel's autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,causal", [
    (8, 50, 12, 64, False),             # ViT training shape at batch 8
    (8, 77, 8, 64, True),               # text
])
def test_flash_mha_gradients_match_naive(cuda, B, S, H, hd, causal):
    """The (B, S, H, hd) entry point carries gradients on the card: its
    backward (the chunked recompute) equals autograd through the naive
    attention within 1e-5 (f32), and launches no kernel."""
    from repro_torch.models.attention import naive_attention
    q, k, v = (torch.randn((B, S, H, hd), generator=cuda, device="cuda",
                           requires_grad=True) for _ in range(3))
    ct = torch.randn((B, S, H, hd), generator=cuda, device="cuda")
    before = FA.flash_attention.launches
    out = FA.flash_mha(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), ct)
    assert FA.flash_attention.launches == before + 1
    want = torch.autograd.grad(naive_attention(q, k, v, causal=causal),
                               (q, k, v), ct)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# K1 / K2 (the FCCO loss kernels) vs their plain versions on the card
# ---------------------------------------------------------------------------

from repro_torch.kernels import gcl_loss as GL  # noqa: E402

# name, b (anchor rows), B (columns), d, row_offset, dtype, tau.  The
# kernels cut columns into splits of GL.SPLIT = 32: at b = B = 33 the last
# split holds only column 32, all masked for row 32 (its own column);
# d = 37 (f32) and d = 44 (bf16) give rows that are not 16-byte aligned
GCL_CASES = [
    ("main", 256, 256, 512, 0, torch.float32, 0.07),
    ("main_bf16", 256, 256, 512, 0, torch.bfloat16, 0.07),
    ("rn50", 256, 256, 1024, 0, torch.float32, 0.07),   # embed_dim 1024
    ("ragged", 200, 200, 128, 0, torch.float32, 0.05),
    ("rect", 64, 256, 512, 128, torch.float32, 0.07),
    ("wide_d", 48, 48, 3072, 0, torch.float32, 0.06),
    ("tau_min_rows", 130, 130, 64, 0, torch.float32, None),
    ("d37_masked_split", 33, 33, 37, 0, torch.float32, 0.07),
    ("d44_bf16", 33, 33, 44, 0, torch.bfloat16, 0.05),
    ("rect_paper", 256, 2048, 512, 768, torch.float32, 0.07),
    ("rect_paper_bf16", 256, 2048, 512, 768, torch.bfloat16, 0.07),
]


def _gcl_inputs(gen, b, B, d, off, dtype, tau):
    def norm(x):
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    e1a = norm(torch.randn((B, d), generator=gen, device="cuda"))
    e2a = norm(torch.randn((B, d), generator=gen, device="cuda"))
    if tau is None:         # per-row taus down to tau_min = 0.01
        ta = 0.01 + 0.06 * torch.rand((2, B), generator=gen, device="cuda")
        ta[:, ::3] = 0.01
    else:
        ta = torch.full((2, B), tau, device="cuda")
    return e1a, e2a, ta


def _log_weights(gen, e1a, e2a, ta):
    """lwt = log w - log tau as the loss op makes them: u tracks g, so
    lwt = -log(eps + u) ~ -(m + log g), here times a random factor in
    [0.2, 1.2); every backward exponent then stays below log(B / 0.2)."""
    g1, g2, _, _, m1, m2 = GL.gcl_pair_stats_plain(e1a, e2a, ta[0], ta[1])
    jitter = torch.log(torch.rand((2, e1a.shape[0]), generator=gen,
                                  device="cuda") + 0.2)
    return torch.stack([-(m1 + torch.log(g1)), -(m2 + torch.log(g2))]) \
        + jitter


def _rect(e1a, e2a, ta, b, B, off):
    if b == B:
        return e1a, e2a, ta, {}
    sl = slice(off, off + b)
    kw = dict(e1_all=e1a, e2_all=e2a, row_offset=off)
    return e1a[sl].contiguous(), e2a[sl].contiguous(), ta[:, sl], kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", GCL_CASES, ids=[c[0] for c in GCL_CASES])
def test_gcl_pair_stats_kernel_matches_plain(cuda, case):
    _, b, B, d, off, dtype, tau = case
    e1a, e2a, ta = _gcl_inputs(cuda, b, B, d, off, dtype, tau)
    e1, e2, t, kw = _rect(e1a, e2a, ta, b, B, off)
    before = (GL.gcl_pair_stats.launches, GL.gcl_pair_stats.cuda_launches)
    got = GL.gcl_pair_stats(e1, e2, t[0], t[1], **kw)
    want = GL.gcl_pair_stats_plain(e1, e2, t[0], t[1], **kw)
    torch.cuda.synchronize()
    assert (GL.gcl_pair_stats.launches,
            GL.gcl_pair_stats.cuda_launches) == (before[0] + 1, before[1] + 2)
    if dtype == torch.float32:
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    else:   # bf16: in log domain, m + log g
        for i in (0, 1):
            lg = got[4 + i] + torch.log(got[i])
            lw = want[4 + i] + torch.log(want[i])
            assert (lg - lw).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", GCL_CASES, ids=[c[0] for c in GCL_CASES])
def test_gcl_pair_grads_kernel_matches_plain(cuda, case):
    _, b, B, d, off, dtype, tau = case
    e1a, e2a, ta = _gcl_inputs(cuda, b, B, d, off, dtype, tau)
    lwa = _log_weights(cuda, e1a, e2a, ta)
    if dtype == torch.float32 and tau is not None:
        lwa[0, off] = 80.0  # the clamp at 60 fires on this row (sat = 1)
    e1, e2, t, kw = _rect(e1a, e2a, ta, b, B, off)
    lw = lwa[:, off:off + b] if kw else lwa
    if kw:
        sda = torch.sum(e1a.float() * e2a.float(), dim=-1)
        kw.update(sd_all=sda, lwt1_all=lwa[0], lwt2_all=lwa[1],
                  tau1_all=ta[0], tau2_all=ta[1])
    before = (GL.gcl_pair_grads.launches, GL.gcl_pair_grads.cuda_launches)
    got = GL.gcl_pair_grads(e1, e2, lw[0], lw[1], t[0], t[1], **kw)
    want = GL.gcl_pair_grads_plain(e1, e2, lw[0], lw[1], t[0], t[1], **kw)
    torch.cuda.synchronize()
    assert (GL.gcl_pair_grads.launches,
            GL.gcl_pair_grads.cuda_launches) == (before[0] + 1, before[1] + 2)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


def _grads_case(gen, case):
    """(e1, e2, lwt rows (2, b), tau rows (2, b), rectangular kwargs)."""
    _, b, B, d, off, dtype, tau = case
    e1a, e2a, ta = _gcl_inputs(gen, b, B, d, off, dtype, tau)
    lwa = _log_weights(gen, e1a, e2a, ta)
    e1, e2, t, kw = _rect(e1a, e2a, ta, b, B, off)
    if kw:
        sda = torch.sum(e1a.float() * e2a.float(), dim=-1)
        kw.update(sd_all=sda, lwt1_all=lwa[0], lwt2_all=lwa[1],
                  tau1_all=ta[0], tau2_all=ta[1])
    return e1, e2, lwa[:, off:off + b], t, kw


GCL_PASS_CASES = [c for c in GCL_CASES
                  if c[0] in ("main_bf16", "d37_masked_split", "rect")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GCL_PASS_CASES,
                         ids=[c[0] for c in GCL_PASS_CASES])
def test_gcl_passes_match_plain(cuda, case):
    """Each of the four passes against its plain version on the same
    inputs (the kernel's outputs of the pass before)."""
    e1, e2, lw, t, kw = _grads_case(cuda, case)
    e1a, e2a, sd, t1, t2, denom = GL._stats_args(
        e1, e2, t[0], t[1], kw.get("e1_all"), kw.get("e2_all"))
    off = kw.get("row_offset", 0)
    part = GL.stats_partial(e1, e2, e1a, e2a, sd, t1, t2, off)
    stats = GL.stats_merge(part, denom)
    args, kappa = GL._grads_args(
        e1, e2, lw[0], lw[1], t[0], t[1], kw.get("e1_all"),
        kw.get("e2_all"), kw.get("sd_all"), kw.get("lwt1_all"),
        kw.get("lwt2_all"), kw.get("tau1_all"), kw.get("tau2_all"))
    pw, r = GL.grads_weights(e1, e2, *args, off)
    out = GL.grads_product(pw, args[0], args[1], e1, e2, r, kappa)
    want = dict(
        part=GL.stats_partial_plain(e1, e2, e1a, e2a, sd, t1, t2, off),
        stats=GL.stats_merge_plain(part, denom),
        weights=GL.grads_weights_plain(e1, e2, *args, off),
        out=GL.grads_product_plain(pw, args[0], args[1], e1, e2, r, kappa))
    torch.cuda.synchronize()
    bf16 = e1.dtype == torch.bfloat16
    # a split's sums on the scale of the outputs (divided by B - 1), which
    # the tolerances are stated for; the weights to the bf16 rounding
    scale = torch.tensor([1.0, denom, denom], device="cuda")[:, None, None]
    for got, w in ((part / scale, want["part"] / scale),
                   (stats, want["stats"])):
        torch.testing.assert_close(got, w, rtol=1e-2 if bf16 else 1e-5,
                                   atol=1e-2 if bf16 else 1e-5)
    for got, w in zip((pw, r), want["weights"]):
        torch.testing.assert_close(got.float(), w.float(),
                                   rtol=1e-2 if bf16 else 1e-4, atol=1e-5)
    torch.testing.assert_close(out, want["out"], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in GCL_CASES
                                  if c[0] in ("main", "rect_paper_bf16")],
                         ids=["main", "rect_paper_bf16"])
def test_gcl_kernels_are_bitwise_deterministic(cuda, case):
    """No atomics in any sum: two calls give the same bits."""
    e1, e2, lw, t, kw = _grads_case(cuda, case)
    kw1 = {k: kw[k] for k in ("e1_all", "e2_all", "row_offset") if k in kw}
    runs = [(GL.gcl_pair_stats(e1, e2, t[0], t[1], **kw1),
             GL.gcl_pair_grads(e1, e2, lw[0], lw[1], t[0], t[1], **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip([*runs[0][0], *runs[0][1]], [*runs[1][0], *runs[1][1]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gcl_kernels_refuse_what_they_do_not_take(cuda):
    e = torch.randn((8, 16), generator=cuda, device="cuda")
    t = torch.full((8,), 0.07, device="cuda")
    with pytest.raises(TypeError):
        GL.gcl_pair_stats(e.half(), e.half(), t, t)
    with pytest.raises(ValueError, match="contiguous"):
        GL.gcl_pair_stats(e.T.contiguous().T, e, t, t)
    with pytest.raises(ValueError, match="is on"):
        GL.gcl_pair_stats(e, e, t, t, e1_all=e.cpu(), e2_all=e)


@pytest.mark.cuda
def test_fcco_op_fused_matches_dense_on_card(cuda):
    """The loss op end to end on the card: K1 forward / K2 backward
    against the dense path (values 1e-5, gradients 1e-4 / 1e-5)."""
    from repro_torch.core import distributed as DI
    B, d = 256, 512
    e1a, e2a, ta = _gcl_inputs(cuda, B, B, d, 0, torch.float32, 0.07)
    lu = torch.log(torch.rand((2, B), generator=cuda, device="cuda") + 0.1)
    res = {}
    for impl in ("dense", "fused"):
        e1 = e1a.clone().requires_grad_(True)
        e2 = e2a.clone().requires_grad_(True)
        op = DI.make_fcco_loss_op(None, 1e-14, loss_impl=impl)
        loss, (lu1, lu2, stats, sat) = op(e1, e2, lu[0], lu[1], ta[0],
                                          ta[1], 0.5)
        res[impl] = (loss, lu1, lu2, *stats, sat,
                     *torch.autograd.grad(loss, (e1, e2)))
    for i, (a, w) in enumerate(zip(res["fused"], res["dense"])):
        tol = (1e-4, 1e-5) if i >= 10 else (1e-5, 1e-5)
        torch.testing.assert_close(a, w, rtol=tol[0], atol=tol[1])


# ---------------------------------------------------------------------------
# K4 (the Mamba2 SSD chunk scan) vs its plain version on the card
# ---------------------------------------------------------------------------

from repro_torch.kernels import ssd_chunk as K4  # noqa: E402

# name, B, T, H, P, N, chunk, B/C dtype, dt bias (dt = softplus(z + bias)):
# the zamba2-1.2b prefill shape, ragged T, T < chunk, chunk 64, large
# decay (dt up to ~10: the ratio form exp(F_i) / exp(F_j) would be 0/0),
# the reduced config's shapes and tests/test_kernels.py's
SSD_CASES = [
    ("prefill", 2, 4096, 64, 64, 64, 256, torch.float32, -2.0),
    ("prefill_bf16", 2, 4096, 64, 64, 64, 256, torch.bfloat16, -2.0),
    ("ragged", 1, 4000, 8, 64, 64, 256, torch.float32, -2.0),
    ("short", 2, 100, 8, 64, 64, 256, torch.float32, -2.0),
    ("chunk64", 1, 1000, 8, 64, 64, 64, torch.float32, -2.0),
    ("large_decay", 1, 1024, 8, 64, 64, 256, torch.float32, 8.0),
    ("reduced", 2, 50, 16, 32, 16, 16, torch.float32, -2.0),
    ("jax_test", 2, 60, 3, 8, 4, 16, torch.float32, 0.0),
]
# max abs error relative to max(1, max |y|): the kernel's cumsum (a warp
# scan) and torch.cumsum round F differently, and every decay carries
# that rounding (eps * |F|, |F| up to ~35 over a 256-row chunk here)
TOL_SSD = 5e-5


def ssd_inputs(gen, B, T, H, P, N, dtype, dt_bias):
    """Inputs shaped as ``models.ssm._ssm_inputs`` makes them."""
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=gen, device="cuda") + dt_bias)
    x = torch.randn((B, T, H, P), generator=gen, device="cuda") * dt[..., None]
    bc = torch.randn((B, T, 2 * N), generator=gen, device="cuda") * 0.5
    # B and C as strided views of one buffer, as the model passes them
    bc = bc.to(dtype)
    return x, -dt, bc[..., :N], bc[..., N:]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_ssd_chunk_kernel_matches_plain(cuda, case):
    _, B, T, H, P, N, chunk, dtype, dt_bias = case
    x, la, Bm, Cm = ssd_inputs(cuda, B, T, H, P, N, dtype, dt_bias)
    before = K4.ssd_chunk.launches
    got = K4.ssd_chunk(x, la, Bm, Cm, chunk=chunk)
    want = K4.ssd_chunk_plain(x, la, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert K4.ssd_chunk.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL_SSD * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_ssd_chunk_kernel_refuses_what_it_does_not_take(cuda):
    x, la, Bm, Cm = ssd_inputs(cuda, 1, 600, 2, 64, 64, torch.float32, -2.0)
    with pytest.raises(ValueError, match="chunks of"):
        K4.ssd_chunk(x, la, Bm, Cm, chunk=512)
    x, la, Bm, Cm = (t[:, :32] for t in (x, la, Bm, Cm))
    wide = torch.zeros((1, 32, 2, 128), device="cuda")
    with pytest.raises(ValueError, match="head dim P"):
        K4.ssd_chunk(wide, la, Bm, Cm)
    with pytest.raises(TypeError):
        K4.ssd_chunk(x.half(), la, Bm, Cm)
    with pytest.raises(TypeError):
        K4.ssd_chunk(x, la, Bm, Cm.bfloat16())
    with pytest.raises(ValueError, match="is on"):
        K4.ssd_chunk(x, la.cpu(), Bm, Cm)


# the four passes of K4 (C B^T, chunk states, state pass, outputs), each
# against its plain version on the same inputs: the reduced config's, the
# JAX tests' and a 64-row chunk's shapes
SSD_PASS_CASES = [c for c in SSD_CASES
                  if c[0] in ("reduced", "jax_test", "chunk64")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_PASS_CASES,
                         ids=[c[0] for c in SSD_PASS_CASES])
def test_ssd_passes_match_plain(cuda, case):
    _, B, T, H, P, N, chunk, dtype, dt_bias = case
    x, la, Bm, Cm = ssd_inputs(cuda, B, T, H, P, N, dtype, dt_bias)
    Lc = min(chunk, T)
    G = K4.ssd_chunk_cb(Bm, Cm, Lc)
    cum, S = K4.ssd_chunk_state(x, la, Bm, Lc)
    S_in = K4.ssd_state_pass(cum, S.clone(), Lc)
    y = K4.ssd_chunk_scan(x, Cm, G, cum, S_in, Lc)
    want = (K4.ssd_chunk_cb_plain(Bm, Cm, Lc),
            *K4.ssd_chunk_state_plain(x, la, Bm, Lc),
            K4.ssd_state_pass_plain(cum, S, Lc),
            K4.ssd_chunk_scan_plain(x, Cm, G, cum, S_in, Lc))
    torch.cuda.synchronize()
    # the tiles of G above the diagonal are not written
    for name, got, w in zip(("cb", "cum", "state", "state_pass", "scan"),
                            (torch.tril(G), cum, S, S_in, y), want):
        assert got.shape == w.shape and torch.isfinite(got).all(), name
        err = (got - w).abs().max().item()
        assert err <= TOL_SSD * max(1.0, w.abs().max().item()), (name, err)


@pytest.mark.cuda
def test_ssd_chunk_counts_one_call_and_four_cuda_launches(cuda):
    x, la, Bm, Cm = ssd_inputs(cuda, 2, 50, 16, 32, 16, torch.float32, -2.0)
    calls, launches = K4.ssd_chunk.launches, K4.ssd_chunk.cuda_launches
    K4.ssd_chunk(x, la, Bm, Cm, chunk=16)
    torch.cuda.synchronize()
    assert K4.ssd_chunk.launches == calls + 1
    assert K4.ssd_chunk.cuda_launches == launches + 4


@pytest.mark.cuda
def test_reduced_hybrid_prefill_launches_and_matches_plain(cuda):
    """One reduced-width zamba2 prefill: one K4 launch per Mamba2 layer,
    one K3 launch per shared-block call; logits within 1e-4 of the plain
    path (plain SSD, chunked attention) and of the sequential decode
    within 5e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import backbones as BB
    cfg = get_arch("zamba2-1.2b").reduced().replace(n_layers=3)
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=cuda,
                           device="cuda")
    k4, k3 = K4.ssd_chunk.launches, FA.flash_attention.launches
    got = steps.make_prefill_step(cfg, impl="flash")(model,
                                                     {"tokens": tokens})
    assert K4.ssd_chunk.launches - k4 == cfg.n_layers
    assert FA.flash_attention.launches - k3 == 1
    want = steps.make_prefill_step(cfg, impl="chunked")(model,
                                                        {"tokens": tokens})
    assert (got - want).abs().max().item() <= 1e-4
    state = BB.prepare_decode_state(model, cfg, {}, 2, 40)
    k4 = K4.ssd_chunk.launches
    with torch.inference_mode():
        for t in range(40):
            lg, state = BB.decode_step(model, cfg, state, tokens[:, t:t + 1],
                                       t)
    assert K4.ssd_chunk.launches == k4
    assert (lg - got[:, 0]).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [("qwen3-1.7b", 128),
                                           ("qwen1.5-32b", 128)])
def test_reduced_dense_prefill_launches_and_matches_plain(cuda, arch,
                                                          head_dim):
    """A reduced dense prefill at head dim 128 (qwen3: qk-norm, GQA;
    qwen1.5: QKV bias): one K3 launch per layer, logits within 1e-4 of
    the plain path (chunked attention) and of the sequential decode
    within 5e-3 (no launch)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import backbones as BB
    cfg = get_arch(arch).reduced().replace(head_dim=head_dim, n_layers=3)
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 90), generator=cuda,
                           device="cuda")
    k3 = FA.flash_attention.launches
    got = steps.make_prefill_step(cfg, impl="flash")(model,
                                                     {"tokens": tokens})
    assert FA.flash_attention.launches - k3 == cfg.n_layers
    want = steps.make_prefill_step(cfg, impl="chunked")(model,
                                                        {"tokens": tokens})
    assert (got - want).abs().max().item() <= 1e-4
    state = BB.prepare_decode_state(model, cfg, {}, 2, 90)
    k3 = FA.flash_attention.launches
    with torch.inference_mode():
        for t in range(90):
            lg, state = BB.decode_step(model, cfg, state, tokens[:, t:t + 1],
                                       t)
    assert FA.flash_attention.launches == k3
    assert (lg - got[:, 0]).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_reduced_cross_prefill_launches_and_matches_plain(cuda, arch):
    """A reduced vlm (4 layers, 2 super-blocks) or audio prefill: one K3
    launch per self- and cross-attention at the shapes of the path,
    logits within 1e-4 of the plain path and of the sequential decode
    from ``prepare_decode_state`` within 5e-3 (neither launches)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve, steps
    from repro_torch.models import backbones as BB
    cfg = get_arch(arch).reduced()
    if cfg.family == "vlm":
        cfg = cfg.replace(n_layers=4)
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    S = 96
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=cuda,
                           device="cuda")
    batch = {"tokens": tokens, **serve.stub_inputs(cfg, 2, S, cuda, "cuda")}
    if cfg.family == "vlm":
        want = {(S, S): cfg.n_layers,
                (S, cfg.n_image_tokens): cfg.n_layers // cfg.cross_attn_every}
    else:
        E = S // cfg.audio_subsample
        want = {(E, E): cfg.enc_layers, (S, S): cfg.n_layers,
                (S, E): cfg.n_layers}
    before = dict(FA.flash_attention.launches_by_seq)
    got = steps.make_prefill_step(cfg, impl="flash")(model, batch)
    by_seq = {k: n - before.get(k, 0)
              for k, n in FA.flash_attention.launches_by_seq.items()
              if n - before.get(k, 0)}
    assert by_seq == want
    plain = steps.make_prefill_step(cfg, impl="chunked")(model, batch)
    assert (got - plain).abs().max().item() <= 1e-4
    k3 = FA.flash_attention.launches
    state = BB.prepare_decode_state(model, cfg, batch, 2, S)
    with torch.inference_mode():
        for t in range(S):
            lg, state = BB.decode_step(model, cfg, state, tokens[:, t:t + 1],
                                       t)
    assert FA.flash_attention.launches == k3
    assert (lg - got[:, 0]).abs().max().item() <= 5e-3


# ---------------------------------------------------------------------------
# K4 gradients: the kernel forward, the plain scan's autograd backward
# ---------------------------------------------------------------------------

def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30)).item()


SSD_GRAD_CASES = [c for c in SSD_CASES if c[0] in ("reduced", "jax_test")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_GRAD_CASES,
                         ids=[c[0] for c in SSD_GRAD_CASES])
def test_ssd_chunk_gradients_match_plain(cuda, case):
    """Gradients of x, log_a, B and C through ``ssd_chunk`` on the card
    within 1e-4 relative L2 of autograd through ``ssd_scan_plain``; the
    backward launches no kernel."""
    _, B, T, H, P, N, chunk, dtype, dt_bias = case
    ins = [t.detach().contiguous().requires_grad_(True)
           for t in ssd_inputs(cuda, B, T, H, P, N, dtype, dt_bias)]
    gy = torch.randn((B, T, H, P), generator=cuda, device="cuda")
    calls, launches = K4.ssd_chunk.launches, K4.ssd_chunk.cuda_launches
    got = torch.autograd.grad(K4.ssd_chunk(*ins, chunk=chunk), ins, gy)
    assert (K4.ssd_chunk.launches, K4.ssd_chunk.cuda_launches) == (
        calls + 1, launches + 4)
    want = torch.autograd.grad(K4.ssd_scan_plain(*ins, chunk=chunk)[0],
                               ins, gy)
    torch.cuda.synchronize()
    for name, a, w in zip(("x", "log_a", "B", "C"), got, want):
        assert a.dtype == w.dtype and torch.isfinite(a).all(), name
        assert _rel_l2(a, w) <= 1e-4, (name, _rel_l2(a, w))


@pytest.mark.cuda
def test_reduced_hybrid_gradients_flash_match_chunked(cuda):
    """A reduced zamba2 forward + backward: every leaf's gradient through
    ``impl="flash"`` (K4 and K3 forwards) within 1e-4 relative L2 of
    ``impl="chunked"`` (the plain scan and attention).  Under grad
    ``forward_hidden`` recomputes each layer once: K4 runs twice per
    layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    cfg = get_arch("zamba2-1.2b").reduced().replace(n_layers=3)
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=cuda,
                           device="cuda")
    ct = None
    grads = {}
    for impl in ("flash", "chunked"):
        model.zero_grad(set_to_none=True)
        k4 = K4.ssd_chunk.launches
        x, _ = BB.forward_hidden(model, cfg, {"tokens": tokens}, impl=impl)
        if ct is None:
            ct = torch.randn(x.shape, generator=cuda, device="cuda")
        (x * ct).sum().backward()
        assert K4.ssd_chunk.launches - k4 == (
            2 * 3 if impl == "flash" else 0)
        grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}
    torch.cuda.synchronize()
    assert grads["flash"].keys() == grads["chunked"].keys()
    for n, w in grads["chunked"].items():
        assert _rel_l2(grads["flash"][n], w) <= 1e-4, n


@pytest.mark.cuda
def test_reduced_hybrid_lm_step_flash_matches_plain(cuda):
    """One reduced zamba2 LM step (``launch.steps.make_lm_train_step``,
    one super-block of 2 Mamba2 layers and one tail layer) on the card,
    the kernel path against the plain path from the same init: under the
    recompute, exactly 2 * 3 = 6 K4 calls (24 CUDA launches) and 2 K3
    launches; the loss within rtol 1e-4 and every leaf's gradient
    within 1e-4 relative L2 (the training step's bounds, chip_smoke.py);
    the metrics ``loss`` and ``ce``."""
    from repro_torch.configs import get_arch
    from repro_torch.core import train_step as TS
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    from repro_torch.models import backbones as BB
    cfg = get_arch("zamba2-1.2b").reduced().replace(n_layers=3)
    ds = LMDataset(n=8, seq_len=40, vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.batch(np.arange(2)).items()}
    grads, losses, counts = {}, {}, {}
    for impl in ("flash", "chunked"):
        model = BB.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        before = (K4.ssd_chunk.launches, K4.ssd_chunk.cuda_launches,
                  FA.flash_attention.launches)
        with torch.enable_grad():
            loss, _ = BB.lm_loss(model, cfg, batch, impl=impl)
            grads[impl] = TS.param_grads(loss, model)
        torch.cuda.synchronize()
        counts[impl] = (K4.ssd_chunk.launches - before[0],
                        K4.ssd_chunk.cuda_launches - before[1],
                        FA.flash_attention.launches - before[2])
        losses[impl] = loss.item()
    assert counts == {"flash": (6, 24, 2), "chunked": (0, 0, 0)}
    assert abs(losses["flash"] - losses["chunked"]) <= 1e-4 * abs(
        losses["chunked"])
    for n, w in grads["chunked"].items():
        if not w.any():                  # ctr_proj / pair_proj
            assert not grads["flash"][n].any(), n
            continue
        assert _rel_l2(grads["flash"][n], w) <= 1e-4, n
    step, opt = steps.make_lm_train_step(cfg, device="cuda")
    state = steps.init_lm_train_state(cfg, torch.Generator().manual_seed(0),
                                      opt, "cuda")
    state, m = step(state, batch)
    assert sorted(m) == ["ce", "loss"] and int(state["step"]) == 1
    assert abs(m["loss"].item() - losses["flash"]) <= 1e-6 * abs(
        losses["flash"])


@pytest.mark.cuda
@pytest.mark.parametrize("n_layers", [12, 8])
def test_reduced_dense_lm_step_flash_matches_plain(cuda, n_layers):
    """A reduced qwen3-1.7b on the card (12 layers: JAX's grouped
    recompute, 2 groups of 6; 8 layers: its per-layer fall-back), the
    kernel path against the plain path from the same init: K3 launches
    each layer's forward and its recompute, no K1 / K2; the loss within
    rtol 1e-4 and every leaf's gradient within 1e-4 relative L2; then one
    ``make_lm_train_step`` step."""
    from repro_torch.configs import get_arch
    from repro_torch.core import train_step as TS
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    from repro_torch.models import backbones as BB
    cfg = get_arch("qwen3-1.7b").reduced().replace(n_layers=n_layers)
    ds = LMDataset(n=8, seq_len=80, vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.batch(np.arange(2)).items()}
    grads, losses, counts = {}, {}, {}
    for impl in ("flash", "chunked"):
        model = BB.init_params(cfg, torch.Generator().manual_seed(0),
                               "cuda")
        before = (FA.flash_attention.launches, GL.gcl_pair_stats.launches)
        with torch.enable_grad():
            loss, _ = BB.lm_loss(model, cfg, batch, impl=impl)
            grads[impl] = TS.param_grads(loss, model)
        torch.cuda.synchronize()
        counts[impl] = (FA.flash_attention.launches - before[0],
                        GL.gcl_pair_stats.launches - before[1])
        losses[impl] = loss.item()
    assert counts == {"flash": (2 * n_layers, 0), "chunked": (0, 0)}
    assert abs(losses["flash"] - losses["chunked"]) <= 1e-4 * abs(
        losses["chunked"])
    for n, w in grads["chunked"].items():
        if not w.any():                  # ctr_proj / pair_proj
            assert not grads["flash"][n].any(), n
            continue
        assert _rel_l2(grads["flash"][n], w) <= 1e-4, n
    step, opt = steps.make_lm_train_step(cfg, device="cuda")
    state = steps.init_lm_train_state(
        cfg, torch.Generator().manual_seed(0), opt, "cuda")
    state, m = step(state, batch)
    assert int(state["step"]) == 1
    assert abs(m["loss"].item() - losses["flash"]) <= 1e-6 * abs(
        losses["flash"])


@pytest.mark.cuda
def test_reduced_dense_contrastive_step_launches_k1_k2_k3(cuda):
    """One v3 step of reduced qwen1.5-32b (QKV bias, untied head) on the
    card: 2 layers, each recomputed on its own (4 K3 launches), one K1
    and one K2 call (2 CUDA launches each); finite loss, the untied
    ``lm_head`` with zero moments."""
    from repro_torch.configs import get_arch
    from repro_torch.core import fastclip as FC
    from repro_torch.core import train_step as TS
    from repro_torch.core.schedules import lr_warmup_cosine
    from repro_torch.data import PairedEmbeddingDataset
    from repro_torch.optim import adamw
    cfg = get_arch("qwen1.5-32b").reduced()
    fc = FC.FastCLIPConfig(version="v3", n_samples=16, steps_per_epoch=2,
                           gamma_decay_epochs=1, loss_impl="fused")
    tc = TS.TrainStepConfig(arch=cfg, fc=fc, optimizer=adamw(),
                            lr_fn=lr_warmup_cosine(1e-3, 0, 4), wd=0.1)
    state = TS.init_train_state(torch.Generator().manual_seed(0), tc, "cuda")
    ds = PairedEmbeddingDataset(n=16, seq_len=64, vocab_size=cfg.vocab_size)
    idx = np.arange(8)
    before = (FA.flash_attention.launches, GL.gcl_pair_stats.launches,
              GL.gcl_pair_grads.launches, GL.gcl_pair_stats.cuda_launches,
              GL.gcl_pair_grads.cuda_launches)
    state, m = TS.make_train_step(tc, "cuda")(state, ds.batch(idx), idx)
    torch.cuda.synchronize()
    after = (FA.flash_attention.launches, GL.gcl_pair_stats.launches,
             GL.gcl_pair_grads.launches, GL.gcl_pair_stats.cuda_launches,
             GL.gcl_pair_grads.cuda_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 1, 1, 2, 2)
    assert np.isfinite(float(m["loss"]))
    assert not state["opt"]["m"]["lm_head"].any()


# ---------------------------------------------------------------------------
# The eval engine on the card: streaming top-k and K1 at the eval shape
# ---------------------------------------------------------------------------

def _quantized(n, d, seed):
    """Entries in multiples of 1/64 (tests/test_eval.py): every f32 dot
    product is exact in any summation order."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy((np.round(rng.randn(n, d) * 16) / 64.0).astype(
        np.float32)).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1024, 512, 100])
def test_streaming_topk_on_card_equals_dense_on_quantized(cuda, chunk):
    """Bitwise equal to the dense ``lex_topk`` on the card at N = 3072
    (the chip eval's size), with exact duplicate columns."""
    from repro_torch.eval import metrics as M
    from repro_torch.eval import retrieval as RT
    e1, e2 = _quantized(3072, 512, 0), _quantized(3072, 512, 1)
    e2[10:13] = e2[3:6]
    s, i = RT.streaming_topk(e1, e2, 10, chunk=chunk)
    ds, di = M.lex_topk(e1 @ e2.T, 10)
    torch.cuda.synchronize()
    assert torch.equal(i, di)
    assert torch.equal(s.view(torch.int32), ds.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 522, 1034, 3072, 5000])
def test_stable_sort_on_card_keeps_signed_zeros_in_input_order(cuda, width):
    """The tie rule's stable sort at the widths the scans sort (each
    torch sort path): -0.0 and 0.0 are ties, kept in index order, as on
    the CPU and in JAX."""
    from repro_torch.eval import metrics as M
    vals = torch.tensor([-0.0, 0.0, 0.5, -1.0])
    x = vals[torch.randint(0, 4, (4, width), generator=torch.Generator()
                           .manual_seed(width))]
    _, want = M.lex_topk(x, width)
    _, got = M.lex_topk(x.to("cuda"), width)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 3072])
def test_eval_loss_fused_is_k1_and_matches_dense_on_card(cuda, n):
    """``contrastive_eval_loss(loss_impl="fused")`` is one K1 call (two
    CUDA launches) at the square eval shape, within rtol 1e-5 of the
    dense loss math; its row statistics within K1's 1e-5."""
    from repro_torch.eval import metrics as M
    e1a, e2a, ta = _gcl_inputs(cuda, n, n, 512, 0, torch.float32, 0.07)
    before = (GL.gcl_pair_stats.launches, GL.gcl_pair_stats.cuda_launches)
    fused = M.contrastive_eval_loss(e1a, e2a, 0.07, loss_impl="fused")
    assert (GL.gcl_pair_stats.launches,
            GL.gcl_pair_stats.cuda_launches) == (before[0] + 1, before[1] + 2)
    dense = M.contrastive_eval_loss(e1a, e2a, 0.07, loss_impl="dense")
    torch.cuda.synchronize()
    assert abs(fused.item() - dense.item()) <= 1e-5 * abs(dense.item())
    got = GL.gcl_pair_stats(e1a, e2a, ta[0], ta[1])
    want = GL.gcl_pair_stats_plain(e1a, e2a, ta[0], ta[1])
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The async checkpointer's snapshot of tensors on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_async_snapshot_on_the_card_is_mutation_safe(cuda, tmp_path):
    """``AsyncCheckpointer.save`` copies the leaves to the host after the
    work queued on them (a multiply launched just before) and before any
    later change (in-place writes launched just after, while the writer
    is held at its first stage): the checkpoint holds the values of the
    moment of the save."""
    from repro_torch import checkpoint as CK
    live = {"w": torch.randn((1024, 1024), generator=cuda, device="cuda"),
            "t": torch.tensor(3, dtype=torch.int32, device="cuda")}
    want = {"w": live["w"].cpu().numpy() * np.float32(2.0),
            "t": live["t"].cpu().numpy()}
    block = threading.Event()
    CK.set_fault_hook(lambda ev: block.wait(30.0) if ev == "pre_npz"
                      else None)
    try:
        ac = CK.AsyncCheckpointer(str(tmp_path))
        live["w"].mul_(2.0)
        ac.save(live, 1)
        live["w"].fill_(-777.0)
        live["t"].fill_(-1)
        block.set()
        ac.close()
    finally:
        CK.set_fault_hook(None)
    got, step, _ = CK.restore(str(tmp_path), live)
    assert step == 1
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# The mesh's collectives on the card: two ranks sharing it (gloo)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_rank_checks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    import json
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "helpers"))
    import torch_mesh_check as H
    d = tmp_path_factory.mktemp("two_ranks")
    ranks = H.spawn("cuda", d, nproc=2, timeout=180)
    assert [r.returncode for r in ranks] == [0, 0], ranks[0].stderr[-3000:]
    with open(d / "cuda.json") as f:
        return json.load(f)


@pytest.mark.cuda
def test_gloo_collectives_take_cuda_tensors_on_a_shared_card(
        two_rank_checks):
    """all_gather_into_tensor, reduce_scatter_tensor and all_reduce on
    CUDA tensors of two ranks sharing one card: the backend rule picks
    gloo (NCCL refuses two ranks on one device)."""
    c = two_rank_checks
    if torch.cuda.device_count() < 2:
        assert c["backend"] == "gloo" and c["device"] == "cuda:0"
    assert c["all_gather"] and c["reduce_scatter"] and c["all_reduce"]
    assert c["all_ranks"]


@pytest.mark.cuda
def test_differentiable_gathers_reduce_scatter_on_the_card(two_rank_checks):
    """The backward of ``shard_state.gather_params`` (the fsdp weight
    gather) and of ``distributed._GatherAxes`` (the baselines' feature
    gather) sums the ranks' cotangents onto this rank's block."""
    c = two_rank_checks
    assert c["gather_params_backward"] and c["gather_axes_backward"]


# ---------------------------------------------------------------------------
# The MoE LMs: routing by JAX's tie rule on the card, K3 in every
# attention block, deterministic combine
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((2, 16, 4096), 320),
                                     ((2, 128, 4096), 320),
                                     ((4, 64, 128), 8)])
def test_moe_top_k_ties_on_card_equal_cpu(cuda, shape, k):
    """``models.moe.top_k`` on rows full of ties (1.0 / 0.0, what top-1
    routing gives the capacity top-k; a few levels, as router
    probabilities that tie): the card's picks and their order equal the
    CPU's, which the CPU tests hold to ``jax.lax.top_k``."""
    from repro_torch.models import moe as M
    rng = np.random.default_rng(shape[-1] + k)
    for x in ((rng.random(shape) < 0.3).astype(np.float32),
              rng.integers(0, 4, shape).astype(np.float32) / 4):
        cv, ci = M.top_k(torch.from_numpy(x), k)
        gv, gi = M.top_k(torch.from_numpy(x).cuda(), k)
        assert torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu(), cv)


def _record_routes(M, into, replay=None):
    """``models.moe.route`` wrapped: records each call's result into
    ``into``, or returns ``replay``'s results in call order."""
    orig = M.route
    calls = iter(replay or ())

    def wrapped(*a):
        r = next(calls) if replay is not None else orig(*a)
        into.append(r)
        return r
    return orig, wrapped


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_reduced_moe_prefill_flash_matches_plain_with_replayed_routes(
        cuda, arch):
    """A reduced MoE prefill at head dim 128 on the card: one K3 launch
    per attention block, the last-position logits within 1e-4 of the
    plain path (chunked attention) when the kernel path replays the
    plain path's routing decisions (unforced, a routing decision may
    flip on a 1e-7 difference), and of the sequential decode at
    capacity 64 within 5e-3 (no launch)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import backbones as BB
    from repro_torch.models import moe as M
    cfg = get_arch(arch).reduced().replace(head_dim=128, n_layers=4)
    model = BB.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 90), generator=cuda,
                           device="cuda")
    batch = {"tokens": tokens}
    plain_routes, flash_routes = [], []
    orig, rec = _record_routes(M, plain_routes)
    try:
        M.route = rec
        want = steps.make_prefill_step(cfg, impl="chunked")(model, batch)
        M.route = _record_routes(M, flash_routes, plain_routes)[1]
        k3 = FA.flash_attention.launches
        got = steps.make_prefill_step(cfg, impl="flash")(model, batch)
        k3 = FA.flash_attention.launches - k3
    finally:
        M.route = orig
    n_super = cfg.n_layers // cfg.moe.every
    assert len(plain_routes) == n_super == len(flash_routes)
    assert k3 == n_super * (2 if cfg.moe.every == 2 else 1)
    assert (got - want).abs().max().item() <= 1e-4
    wide = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=64.0))
    full = steps.make_prefill_step(wide, impl="flash")(model, batch)
    state = BB.prepare_decode_state(model, wide, {}, 2, 90)
    k3 = FA.flash_attention.launches
    with torch.inference_mode():
        for t in range(90):
            lg, state = BB.decode_step(model, wide, state,
                                       tokens[:, t:t + 1], t)
    assert FA.flash_attention.launches == k3
    assert (lg - full[:, 0]).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_moe_layer_on_card_is_bitwise_repeatable(cuda, arch):
    """Two calls of ``apply_moe`` on the card give the same bits (the
    combine gathers; no atomics), at a shape with capacity drops; the
    result within 2e-5 of the same layer on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M
    cfg = get_arch(arch).reduced()
    mod = M.MoE(cfg)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    mod.norm.reset_parameters()
    if hasattr(mod, "shared"):
        mod.shared.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn((4, 256, cfg.d_model), generator=torch.Generator(
    ).manual_seed(2))
    with torch.inference_mode():
        cpu, _ = M.apply_moe(mod, cfg, x)
        mod = mod.cuda()
        a, aux_a = M.apply_moe(mod, cfg, x.cuda())
        b, aux_b = M.apply_moe(mod, cfg, x.cuda())
    assert torch.equal(a, b)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
    assert (a.cpu() - cpu).abs().max().item() <= 2e-5


# ---------------------------------------------------------------------------
# MoE training: the deterministic dispatch backward, a step's replay
# ---------------------------------------------------------------------------

def _moe_layer(cfg):
    from repro_torch.models import moe as M
    mod = M.MoE(cfg)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    mod.norm.reset_parameters()
    if hasattr(mod, "shared"):
        mod.shared.reset_parameters(torch.Generator().manual_seed(1))
    return mod


def _moe_layer_grads(M, mod, cfg, x, w):
    """Gradients of ``sum(y * w) + lb + z`` for x and every parameter,
    and each call's (router input, gate gradient)."""
    gates, orig = [], M.route

    def route(*a):
        r = orig(*a)
        r.gates.register_hook(gates.append)
        return r
    x = x.clone().requires_grad_(True)
    M.route = route
    try:
        with torch.enable_grad():
            y, aux = M.apply_moe(mod, cfg, x)
            loss = (y * w).sum() + aux["moe_lb"] + aux["moe_z"]
            names, ps = zip(*mod.named_parameters())
            gs = torch.autograd.grad(loss, (x, *ps))
    finally:
        M.route = orig
    with torch.no_grad():
        h = mod.norm(x)
    return dict(zip(("x",) + names, gs)), h, gates[0]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_moe_layer_backward_on_card_is_bitwise_repeatable(cuda, arch):
    """One MoE layer's backward on the card (the dispatch's backward in
    ascending expert order, the combine's gathers, the sorts' backward)
    twice to the bit, at a shape with capacity fills and drops; each
    gradient within 1e-4 relative L2 of the CPU's.  A top-1 router's
    gradient is the aux losses' plus the gates' rounding noise
    (tests/test_torch_moe_train.py's NOISE_ROUNDINGS arithmetic), so it
    is held to the CPU's within twice that noise bound."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M
    cfg = get_arch(arch).reduced()
    mod = _moe_layer(cfg)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 256, cfg.d_model), generator=gen)
    w = torch.randn(x.shape, generator=gen)
    cpu, h, gg = _moe_layer_grads(M, mod, cfg, x, w)
    mod = mod.cuda()
    a = _moe_layer_grads(M, mod, cfg, x.cuda(), w.cuda())[0]
    b = _moe_layer_grads(M, mod, cfg, x.cuda(), w.cuda())[0]
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k, want in cpu.items():
        got = a[k].cpu()
        if k == "router" and cfg.moe.top_k == 1:
            bound = 2 * 8 * 2.0 ** -24 * torch.einsum(
                "btd,bt->d", h.double().abs(), gg[..., 0].double().abs())
            assert bool(((got - want).double().abs()
                         <= 2 * bound[:, None]).all())
            continue
        assert _rel_l2(got, want) <= 1e-4, (k, _rel_l2(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers", [("qwen3-moe-30b-a3b", 12),
                                           ("llama4-scout-17b-a16e", 4)])
def test_reduced_moe_lm_step_on_card_equals_its_replay(cuda, arch,
                                                       n_layers):
    """A reduced MoE LM (head dim 128; qwen3-moe at 12 super-blocks, 2
    recompute groups of 6) trained two steps on the card twice from the
    same init and batches: every parameter and moment equal to the bit;
    K3 launched in each attention block's forward and its recompute."""
    from repro_torch.configs import get_arch
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    cfg = get_arch(arch).reduced().replace(head_dim=128, n_layers=n_layers)
    ds = LMDataset(n=8, seq_len=96, vocab_size=cfg.vocab_size)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in ds.batch(np.arange(2 * i, 2 * i + 2)).items()}
               for i in range(2)]
    runs = []
    for _ in range(2):
        step, opt = steps.make_lm_train_step(cfg, lr=1e-2, total_steps=4,
                                             device="cuda")
        state = steps.init_lm_train_state(
            cfg, torch.Generator().manual_seed(0), opt, "cuda")
        k3 = FA.flash_attention.launches
        for b in batches:
            state, m = step(state, b)
            assert np.isfinite(m["loss"].item())
        torch.cuda.synchronize()
        assert FA.flash_attention.launches - k3 == 2 * 2 * n_layers
        runs.append({**{f"p/{k}": p.detach().clone()
                        for k, p in state["params"].named_parameters()},
                     **{f"{mo}/{k}": v for mo in ("m", "v")
                        for k, v in state["opt"][mo].items()}})
    assert sorted(runs[0]) == sorted(runs[1])
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
