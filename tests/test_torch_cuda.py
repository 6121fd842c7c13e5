"""The port's CUDA kernels on the card, held to their plain PyTorch
versions.  Every test here needs an NVIDIA GPU: it carries the ``cuda``
marker and skips itself without one.  The file imports neither jax nor
``repro``, so it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports jax).  Tolerances:
f32 1e-5, bf16 1e-2, as tests/test_precision_flash.py."""
import os
import sys

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
