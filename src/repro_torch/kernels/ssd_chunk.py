"""Mamba2 chunkwise SSD scan (K4): a CUDA kernel written by hand for Hopper.

Replaces the TPU kernel ``src/repro/kernels/ssd_chunk.py``
(``ssd_chunked_pallas``, body ``_ssd_kernel``).  Same function: for each
(batch, head), walking the chunks of ``Lc = min(chunk, T)`` rows in order
and carrying the state S (N, P) from zero,

    F      = cumsum(log_a)                       over the chunk
    y      = ((C B^T) o exp(F_i - F_j) o tril) x + exp(F) o (C S)
    S_next = exp(F_L) S + B^T diag(exp(F_L - F)) x

with x (B, T, H, P) f32, log_a (B, T, H) f32 and B/C (B, T, N) f32 or
bf16, shared by every head; y (B, T, H, P) f32.  A ragged T is padded
with log_a = 0 and x = 0, and only T rows are returned.

The kernel (``csrc/ssd_chunk.cu``) takes ``1 <= P, N <= 64`` and chunks up
to 256 rows (the hybrid configs' own: P = N = 64 and chunk 256 at full
width, P 32 / N 16 / chunk 16 reduced); its source note says what bounds
it on the H100 and how the design answers that.

Dispatch: a tensor on the CPU takes the plain version
(``ssd_chunk_plain``, the chunk loop of the TPU kernel's math in torch); a
CUDA tensor launches the kernel or raises.  ``ssd_chunk.launches`` counts
kernel launches.  There is no autograd Function: the kernel serves
inference (prefill) only.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

MAX_DIM = 64        # largest P and N the kernel takes
MAX_CHUNK = 256     # largest chunk the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(x, log_a, Bm, Cm, S0=None, chunk=256):
    """The chunkwise scan in plain torch, f32 inside (f64 for f64 x, the
    exact yardstick of the card checks): returns y (B, T, H, P) and the
    final state (B, H, N, P).  ``S0``: the initial state (zeros if
    None)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Lc = min(chunk, T)
    pad = (-T) % Lc
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (T + pad) // Lc
    ct = torch.promote_types(x.dtype, torch.float32)
    xc = x.to(ct).reshape(Bsz, nc, Lc, H, P)
    lac = log_a.to(ct).reshape(Bsz, nc, Lc, H)
    bc = Bm.to(ct).reshape(Bsz, nc, Lc, N)
    cc = Cm.to(ct).reshape(Bsz, nc, Lc, N)
    S = (torch.zeros((Bsz, H, N, P), dtype=ct, device=x.device)
         if S0 is None else S0.to(ct))
    idx = torch.arange(Lc, device=x.device)
    tril = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        xb, bb, cb = xc[:, c], bc[:, c], cc[:, c]
        Fc = torch.cumsum(lac[:, c], dim=1)                   # (B, Lc, H)
        G = torch.einsum("bin,bjn->bij", cb, bb)              # (B, Lc, Lc)
        # exp(F_i - F_j) for j <= i: every exponent a difference, <= 0
        D = torch.where(tril, torch.exp(Fc[:, :, None, :] - Fc[:, None, :, :]),
                        0.0)                                  # (B, i, j, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", G[..., None] * D, xb)
        y_inter = torch.exp(Fc)[..., None] * torch.einsum(
            "bin,bhnp->bihp", cb, S)
        FL = Fc[:, -1]                                        # (B, H)
        w = torch.exp(FL[:, None, :] - Fc)                    # (B, Lc, H)
        S = (torch.exp(FL)[:, :, None, None] * S
             + torch.einsum("bjn,bjhp->bhnp", bb, xb * w[..., None]))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * Lc, H, P)
    return y[:, :T], S


def ssd_chunk_plain(x, log_a, Bm, Cm, *, chunk=64):
    """Plain PyTorch version of the kernel: y of ``ssd_scan_plain``."""
    return ssd_scan_plain(x, log_a, Bm, Cm, chunk=chunk)[0]


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("ssd_chunk").ssd_chunk_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i32] + [ptr] * 5 + [i32] * 7 + [i64] * 13 + [ptr]
    fn.restype = i32
    return fn


def _launch(x, log_a, Bm, Cm, y, Lc):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk kernel needs CUDA tensors, got {dev}")
    for name, t in (("log_a", log_a), ("Bm", Bm), ("Cm", Cm), ("y", y)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    for name, t in (("x", x), ("log_a", log_a), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if Bm.dtype not in _DTYPE_CODE or Cm.dtype != Bm.dtype:
        raise TypeError(f"Bm and Cm must both be float32 or bfloat16, not "
                        f"{Bm.dtype} / {Cm.dtype}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(log_a.shape) != (B, T, H) or tuple(Bm.shape) != (B, T, N)
            or Cm.shape != Bm.shape or y.shape != x.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} log_a "
                         f"{tuple(log_a.shape)} Bm {tuple(Bm.shape)} Cm "
                         f"{tuple(Cm.shape)}")
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"ssd_chunk kernel takes head dim P and state size "
                         f"N in 1..{MAX_DIM}, got P={P}, N={N}")
    if not 1 <= Lc <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk kernel takes chunks of 1..{MAX_CHUNK} "
                         f"rows, got {Lc}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm, y)):
        raise ValueError("the last axis of x, Bm, Cm and y must be "
                         "contiguous (stride 1)")
    if max(B * H, T) >= 2 ** 31:
        raise ValueError("ssd_chunk kernel takes B*H and T below 2**31")
    fn = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, x.data_ptr(), log_a.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), y.data_ptr(), _DTYPE_CODE[Bm.dtype], B, T, H, P,
             N, Lc, *x.stride()[:3], *log_a.stride(), *Bm.stride()[:2],
             *Cm.stride()[:2], *y.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_fwd launch failed: cudaError {err}")
    ssd_chunk.launches += 1


def ssd_chunk(x, log_a, Bm, Cm, *, chunk=64):
    """x: (B, T, H, P) f32; log_a: (B, T, H) f32; Bm/Cm: (B, T, N) f32 or
    bf16 -> y (B, T, H, P) f32 (the final state is not returned)."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, log_a, Bm, Cm, chunk=chunk)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch(x, log_a, Bm, Cm, y, min(chunk, x.shape[1]))
    return y


ssd_chunk.launches = 0
