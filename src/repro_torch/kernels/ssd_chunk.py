"""Mamba2 chunkwise SSD scan (K4): CUDA kernels written by hand for Hopper.

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

On the card the scan runs as four passes (``csrc/ssd_chunk.cu``; its
source note says what bounds each on the H100 and how the design answers
that), each with a plain PyTorch version here on the same scratch
layouts (nc = ceil(T / Lc)):

1. ``ssd_chunk_cb``: G = tril(C B^T) per chunk, once for all heads,
   (B, nc, Lc, Lc) f32;
2. ``ssd_chunk_state``: the chunk cumsum F of log_a, (B, H, nc * Lc),
   and each chunk's local state B^T diag(exp(F_L - F)) x, (B, H, nc, N, P);
3. ``ssd_state_pass``: the state entering each chunk, S_in[c + 1] =
   exp(F_L[c]) S_in[c] + S_loc[c] from zero (the kernel overwrites the
   local states in place);
4. ``ssd_chunk_scan``: y = (G o exp(F_i - F_j) o tril) x + exp(F) (C S_in).

The kernels take ``1 <= P, N <= 64`` and chunks up to 256 rows (the
hybrid configs' own: P = N = 64 and chunk 256 at full width, P 32 / N 16
/ chunk 16 reduced).

Dispatch: a tensor on the CPU takes the plain version (``ssd_chunk_plain``,
the chunk loop of the TPU kernel's math in torch, or the pass's own); a
CUDA tensor launches the kernels or raises.  ``ssd_chunk.launches``
counts calls of ``ssd_chunk`` that went to the kernels (one per Mamba2
layer), ``ssd_chunk.cuda_launches`` the CUDA launches inside (four per
call).  On the card ``ssd_chunk`` is an autograd Function (``_SSDChunk``):
the forward is the four launches, the backward recomputes
``ssd_scan_plain`` on the saved inputs and differentiates it, as the JAX
package differentiates its jnp ``ssd_chunked``; it launches no kernel.
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
        # exp(F_i - F_j) for j <= i: every exponent a difference, <= 0.
        # The masked exponents (j > i, up to the chunk's whole decay) go to
        # -inf before the exp: exp of one past 88 is inf in f32, and its
        # gradient, 0 * inf, would be NaN (the JAX package's ssd_chunked
        # masks after the exp and has that NaN)
        D = torch.exp(torch.where(
            tril, Fc[:, :, None, :] - Fc[:, None, :, :],
            -torch.inf))                                      # (B, i, j, H)
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


def _padded(t, Lc):
    """``t`` (B, T, ...) with T padded by zero rows to a multiple of Lc."""
    pad = (-t.shape[1]) % Lc
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


def _ctype(t):
    return torch.promote_types(t.dtype, torch.float32)


def ssd_chunk_cb_plain(Bm, Cm, Lc):
    """Pass 1: G = tril(C B^T) within each chunk, (B, nc, Lc, Lc)."""
    B, _, N = Bm.shape
    ct = _ctype(Bm)
    b = _padded(Bm, Lc).to(ct).reshape(B, -1, Lc, N)
    c = _padded(Cm, Lc).to(ct).reshape(B, -1, Lc, N)
    return torch.tril(torch.einsum("bkin,bkjn->bkij", c, b))


def ssd_chunk_state_plain(x, log_a, Bm, Lc):
    """Pass 2: the cumsum of log_a within each chunk, (B, H, nc * Lc), and
    each chunk's local state B^T diag(exp(F_L - F)) x, (B, H, nc, N, P)."""
    B, _, H, P = x.shape
    N = Bm.shape[-1]
    ct = _ctype(x)
    xc = _padded(x, Lc).to(ct).reshape(B, -1, Lc, H, P)
    nc = xc.shape[1]
    cum = torch.cumsum(_padded(log_a, Lc).to(ct).reshape(B, nc, Lc, H),
                       dim=2)
    w = torch.exp(cum[:, :, -1:] - cum)                       # (B, nc, Lc, H)
    b = _padded(Bm, Lc).to(ct).reshape(B, nc, Lc, N)
    S = torch.einsum("bkjn,bkjhp->bhknp", b, xc * w[..., None])
    return cum.permute(0, 3, 1, 2).reshape(B, H, nc * Lc), S


def ssd_state_pass_plain(cum, S, Lc):
    """Pass 3: the state entering each chunk (zeros for chunk 0) from the
    local states S (B, H, nc, N, P); returns a new tensor."""
    B, H, nc = S.shape[:3]
    decay = torch.exp(cum.reshape(B, H, nc, Lc)[..., -1])       # (B, H, nc)
    out = torch.empty_like(S)
    carry = torch.zeros_like(S[:, :, 0])
    for c in range(nc):
        out[:, :, c] = carry
        carry = decay[:, :, c, None, None] * carry + S[:, :, c]
    return out


def ssd_chunk_scan_plain(x, Cm, G, cum, S_in, Lc):
    """Pass 4: y (B, T, H, P) from G (only its lower triangles are read),
    the chunk cumsums and the incoming states."""
    B, T, H, P = x.shape
    N = Cm.shape[-1]
    ct = _ctype(x)
    xc = _padded(x, Lc).to(ct).reshape(B, -1, Lc, H, P)
    nc = xc.shape[1]
    cc = _padded(Cm, Lc).to(ct).reshape(B, nc, Lc, N)
    Fc = cum.reshape(B, H, nc, Lc).permute(0, 2, 3, 1)          # (B, nc, Lc, H)
    idx = torch.arange(Lc, device=x.device)
    tril = (idx[:, None] >= idx[None, :])[:, :, None]
    # every exponent a difference, <= 0 on the triangle that is kept
    M = torch.where(tril, G[..., None] * torch.exp(
        Fc[:, :, :, None, :] - Fc[:, :, None, :, :]), 0.0)      # (B, nc, i, j, H)
    y = (torch.einsum("bkijh,bkjhp->bkihp", M, xc)
         + torch.exp(Fc)[..., None] * torch.einsum("bkin,bhknp->bkihp", cc,
                                                   S_in))
    return y.reshape(B, nc * Lc, H, P)[:, :T]


@functools.cache
def _lib():
    from repro_torch.kernels import build
    lib = build.load("ssd_chunk")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, argtypes in (
            ("ssd_chunk_cb", [i32] + [ptr] * 3 + [i32] * 5 + [i64] * 4),
            ("ssd_chunk_state", [i32] + [ptr] * 5 + [i32] * 7 + [i64] * 8),
            ("ssd_state_pass", [i32] + [ptr] * 2 + [i32] * 6),
            ("ssd_chunk_scan", [i32] + [ptr] * 6 + [i32] * 7 + [i64] * 8)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes + [ptr]          # the stream last
        fn.restype = i32
    return lib


def _call(name, dev, *args):
    err = getattr(_lib(), name)(dev.index, *args,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    ssd_chunk.cuda_launches += 1


def _n_chunks(T, Lc):
    return -(-T // Lc)


def _need_scratch(name, t, shape, dev):
    if (t.device != dev or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 {tuple(shape)} "
                         f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_x(x, Lc):
    """x (B, T, H, P) as the kernels take it."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, not {x.dtype}")
    B, T, H, P = x.shape
    if not 1 <= P <= MAX_DIM:
        raise ValueError(f"ssd_chunk kernel takes head dim P in 1..{MAX_DIM}, "
                         f"got P={P}")
    if not 1 <= Lc <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk kernel takes chunks of 1..{MAX_CHUNK} "
                         f"rows, got {Lc}")
    if x.stride(-1) != 1:
        raise ValueError("the last axis of x must be contiguous (stride 1)")
    if max(B * H * _n_chunks(T, Lc), T) >= 2 ** 31:
        raise ValueError("ssd_chunk kernel takes B*H*n_chunks and T below "
                         "2**31")


def _check_bc(Bm, Cm, shape, dev):
    """B and C (B, T, N) as the kernels take them, (B, T) = ``shape``."""
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if Bm.dtype not in _DTYPE_CODE or Cm.dtype != Bm.dtype:
        raise TypeError(f"Bm and Cm must both be float32 or bfloat16, not "
                        f"{Bm.dtype} / {Cm.dtype}")
    N = Bm.shape[-1]
    if tuple(Bm.shape) != (*shape, N) or Cm.shape != Bm.shape:
        raise ValueError(f"shape mismatch: (B, T) {tuple(shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if not 1 <= N <= MAX_DIM:
        raise ValueError(f"ssd_chunk kernel takes state size N in "
                         f"1..{MAX_DIM}, got N={N}")
    if Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("the last axis of Bm and Cm must be contiguous "
                         "(stride 1)")


def check_inputs(x, log_a, Bm, Cm, Lc):
    """Raise unless the kernels take these inputs (any device)."""
    _check_x(x, Lc)
    _check_bc(Bm, Cm, x.shape[:2], x.device)
    if log_a.device != x.device:
        raise ValueError(f"log_a is on {log_a.device}, x on {x.device}")
    if log_a.dtype != torch.float32:
        raise TypeError(f"log_a must be float32, not {log_a.dtype}")
    if log_a.shape != x.shape[:3]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} log_a "
                         f"{tuple(log_a.shape)}")


def ssd_chunk_cb(Bm, Cm, Lc):
    """Pass 1 (kernel on CUDA tensors): G (B, nc, Lc, Lc) f32, tril(C B^T)
    within each chunk; on the card the tiles above the diagonal are not
    written."""
    if Bm.device.type == "cpu":
        return ssd_chunk_cb_plain(Bm, Cm, Lc)
    B, T, N = Bm.shape
    if not 1 <= Lc <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk kernel takes chunks of 1..{MAX_CHUNK} "
                         f"rows, got {Lc}")
    _check_bc(Bm, Cm, (B, T), Bm.device)
    G = torch.empty((B, _n_chunks(T, Lc), Lc, Lc), dtype=torch.float32,
                    device=Bm.device)
    _call("ssd_chunk_cb", Bm.device, Bm.data_ptr(), Cm.data_ptr(),
          G.data_ptr(), _DTYPE_CODE[Bm.dtype], B, T, N, Lc,
          *Bm.stride()[:2], *Cm.stride()[:2])
    return G


def ssd_chunk_state(x, log_a, Bm, Lc):
    """Pass 2 (kernel on CUDA tensors): (cumsum (B, H, nc * Lc), local
    states (B, H, nc, N, P))."""
    if x.device.type == "cpu":
        return ssd_chunk_state_plain(x, log_a, Bm, Lc)
    check_inputs(x, log_a, Bm, Bm, Lc)
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = _n_chunks(T, Lc)
    cum = torch.empty((B, H, nc * Lc), dtype=torch.float32, device=x.device)
    S = torch.empty((B, H, nc, N, P), dtype=torch.float32, device=x.device)
    _call("ssd_chunk_state", x.device, x.data_ptr(), log_a.data_ptr(),
          Bm.data_ptr(), cum.data_ptr(), S.data_ptr(), _DTYPE_CODE[Bm.dtype],
          B, T, H, P, N, Lc, *x.stride()[:3], *log_a.stride(),
          *Bm.stride()[:2])
    return cum, S


def ssd_state_pass(cum, S, Lc):
    """Pass 3 (kernel on CUDA tensors): the state entering each chunk.  On
    the card it overwrites ``S`` and returns it; the plain version returns
    a new tensor."""
    if S.device.type == "cpu":
        return ssd_state_pass_plain(cum, S, Lc)
    B, H, nc, N, P = S.shape
    _need_scratch("S", S, S.shape, S.device)
    _need_scratch("cum", cum, (B, H, nc * Lc), S.device)
    _call("ssd_state_pass", S.device, cum.data_ptr(), S.data_ptr(), B, H, N,
          P, Lc, nc)
    return S


def ssd_chunk_scan(x, Cm, G, cum, S_in, Lc):
    """Pass 4 (kernel on CUDA tensors): y (B, T, H, P) f32."""
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, Cm, G, cum, S_in, Lc)
    _check_x(x, Lc)
    _check_bc(Cm, Cm, x.shape[:2], x.device)
    B, T, H, P = x.shape
    N = Cm.shape[-1]
    nc = _n_chunks(T, Lc)
    _need_scratch("G", G, (B, nc, Lc, Lc), x.device)
    _need_scratch("cum", cum, (B, H, nc * Lc), x.device)
    _need_scratch("S_in", S_in, (B, H, nc, N, P), x.device)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _call("ssd_chunk_scan", x.device, x.data_ptr(), Cm.data_ptr(),
          G.data_ptr(), cum.data_ptr(), S_in.data_ptr(), y.data_ptr(),
          _DTYPE_CODE[Cm.dtype], B, T, H, P, N, Lc, *x.stride()[:3],
          *Cm.stride()[:2], *y.stride()[:3])
    return y


class _SSDChunk(torch.autograd.Function):
    """The four passes forward, the plain scan's autograd backward."""

    @staticmethod
    def forward(ctx, x, log_a, Bm, Cm, chunk):
        Lc = min(chunk, x.shape[1])
        G = ssd_chunk_cb(Bm, Cm, Lc)
        cum, S = ssd_chunk_state(x, log_a, Bm, Lc)
        y = ssd_chunk_scan(x, Cm, G, cum, ssd_state_pass(cum, S, Lc), Lc)
        ctx.save_for_backward(x, log_a, Bm, Cm)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, gy):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, _ = ssd_scan_plain(*inputs, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(y, wanted, gy))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def ssd_chunk(x, log_a, Bm, Cm, *, chunk=64):
    """x: (B, T, H, P) f32; log_a: (B, T, H) f32; Bm/Cm: (B, T, N) f32 or
    bf16 -> y (B, T, H, P) f32 (the final state is not returned)."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, log_a, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk kernel needs CUDA tensors, got "
                         f"{x.device}")
    check_inputs(x, log_a, Bm, Cm, min(chunk, x.shape[1]))  # before any launch
    y = _SSDChunk.apply(x, log_a, Bm, Cm, chunk)
    ssd_chunk.launches += 1
    return y


ssd_chunk.launches = 0
ssd_chunk.cuda_launches = 0
