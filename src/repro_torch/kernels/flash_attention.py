"""Flash-attention forward: a CUDA kernel written by hand for Hopper.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``).  Same public functions and
layouts: ``flash_attention`` on ``(B, H, S, hd)`` and ``flash_mha`` on
``(B, S, H, hd)``; any ``Sq``/``Sk``, causal and sliding-window masks, f32
or bf16 inputs, f32 softmax statistics and accumulation, output in the q
dtype.

What bounds it on the H100: at the serving and training shapes (ViT ``B
x 12 x 50 x 64`` non-causal, text ``B x 8 x 77 x 64`` causal) it moves q,
k, v and o once and does a few hundred kFLOP per (batch, head), so the
bytes and the launch bound it; at zamba2's prefill (``2 x 32 x 4096 x
64`` causal) and qwen3-1.7b's (``2 x 16 x 4096 x 128``) the two products
do.  The design (``csrc/flash_attention.cu``) runs both products on the
tensor cores (bf16 on ``wgmma``, f32 through split TF32 on ``mma.sync``,
three TF32 products per f32 product, for f32 accuracy), the online
softmax on the accumulator registers (for f32 at head dim 128 the
running output sum waits in shared memory, so that nothing spills), and
K/V tiles of 64 keys through a two-stage ``cp.async`` ring; it masks its
own ragged edge and skips fully masked key tiles.

Input conditions, checked by ``check_inputs`` before any launch: q, k, v
and out on one device, float32 or bfloat16 alike, (B, H, S, hd) with hd
in {32, 64, 128} and contiguous, and 16-byte aligned rows for ``cp.async``
(base pointers and the strides of B, H and S, in bytes, multiples of
16).  Fresh tensors and ``flash_mha``'s (B, S, H, hd) views meet them.

Dispatch: a tensor on the CPU takes the plain version
(``flash_attention_ref``); a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts kernel launches (both entry points),
``flash_attention.launches_by_seq`` the same launches by (Sq, Sk).

Gradients: on the card both entry points are a ``torch.autograd.Function``
whose forward is the kernel (saving q, k, v) and whose backward
recomputes the attention through the plain ``models.attention.
chunked_attention`` and differentiates that, as the JAX package's
``jax.custom_vjp`` does (``_flash_mha_bwd``): the TPU version has no
backward kernel either, so the backward launches no kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

NEG = -1e30
# the dense LMs: 128; the towers and zamba2: 64; the reduced ViT tower: 32
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """Plain PyTorch version: naive masked f32 softmax, ``p`` rounded to
    the v dtype before the PV product, ``l`` clamped at 1e-30 (a fully
    masked row gives 0), output in the q dtype.  (B, H, S, hd) layout."""
    Sq, Sk, hd = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(hd))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32]
                   + [i64] * 12 + [ctypes.c_float, i32, i32, ptr])
    fn.restype = i32
    return fn


def _strides(t):
    """(B, H, S) element strides, 0 for a dimension of size 1 (its stride
    is never used, and PyTorch may report any value for it)."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def check_inputs(q, k, v, out, window=0):
    """Raise on what the kernel does not take; (B, H, S, hd) views.
    Runs on tensors of any device, so the CPU tests reach every
    refusal."""
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    if (tuple(k.shape) != (B, H, Sk, hd) or v.shape != k.shape
            or out.shape != q.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} out "
                         f"{tuple(out.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("the head dim must be contiguous (stride 1)")
    item = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % 16 or any(st * item % 16 for st in _strides(t)):
            raise ValueError(
                f"{name} is not 16-byte aligned (data_ptr {t.data_ptr()}, "
                f"strides {tuple(t.stride())} of {item}-byte elements): "
                f"the kernel copies rows with 16-byte cp.async")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _launch(q, k, v, out, causal, window):
    """Launch on (B, H, S, hd) views of one CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    check_inputs(q, k, v, out, window)
    B, H, Sq, hd = q.shape
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), _DTYPE_CODE[q.dtype], B, H, Sq, k.shape[2], hd,
             *_strides(q), *_strides(k), *_strides(v), *_strides(out),
             1.0 / math.sqrt(hd), int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_seq[Sq, k.shape[2]] += 1


class _FlashMHA(torch.autograd.Function):
    """(B, S, H, hd) layout: the kernel forward, the chunked recompute
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                out.transpose(1, 2), causal, window)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, ct):
        from repro_torch.models.attention import chunked_attention
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = chunked_attention(q, k, v, causal=ctx.causal,
                                  window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), ct)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, H, Sq, hd), k/v: (B, H, Sk, hd) -> (B, H, Sq, hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return _FlashMHA.apply(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal, window).transpose(1, 2)


flash_attention.launches = 0
flash_attention.launches_by_seq = collections.Counter()


def flash_mha(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, hd), k/v: (B, Sk, H, hd) (GQA heads already
    repeated, as in the JAX package) -> (B, Sq, H, hd) in the q dtype.  On the card the kernel
    reads and writes this layout in place, with no transposing copy."""
    if q.device.type == "cpu":
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
        return o.transpose(1, 2)
    return _FlashMHA.apply(q, k, v, causal, window)
