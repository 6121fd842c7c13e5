"""FCCO loss kernels: K1 (row statistics, the loss forward) and K2 (the
closed-form feature gradients, the loss backward), CUDA kernels written by
hand for Hopper.

Replaces the TPU kernels ``src/repro/kernels/gcl_loss.py``
(``gcl_pair_stats``, body ``_stats_kernel``; ``gcl_pair_grads``, bodies
``_grads_kernel`` and ``_grads_kernel_dblocked``).  Same public
signatures, including the rectangular sharded form (``e1_all``,
``e2_all``, ``sd_all``, ``lwt*_all``, ``tau*_all``, ``row_offset``: local
anchor rows against gathered columns).  The TPU tile knobs (``br``,
``bc``, ``d_block``) and its autotune table are not inputs here: the
kernel (``csrc/gcl_loss.cu``) loops over any ``d`` itself.  Its source
note says what bounds it on the H100 and how the design answers that.

Around the launch, in plain torch as around ``pallas_call`` in the TPU
version: ``s_ii``, per-row taus, the ``(B - 1)`` denominators of K1 and
the finish ``kappa * (de - (r1 + r2) e)`` of K2.

Dispatch: a tensor on the CPU takes the plain version (``_stats_plain``,
``_grads_plain``, the same arithmetic as the kernel in dense torch); a
CUDA tensor launches the kernel or raises.  ``gcl_pair_stats.launches``
and ``gcl_pair_grads.launches`` count kernel launches.  Inputs f32 or
bf16; statistics and accumulation in f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.losses import EXP_CLAMP, MASK_NEG

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _vec(x, n: int, device) -> torch.Tensor:
    """A scalar or (n,) tau as a contiguous (n,) f32 tensor."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.broadcast_to((n,)).contiguous()


def _pair_mask(b: int, B: int, row_offset: int, device) -> torch.Tensor:
    rows = row_offset + torch.arange(b, device=device)[:, None]
    cols = torch.arange(B, device=device)[None, :]
    return (rows != cols) & (rows >= 0)


# ---------------------------------------------------------------------------
# Plain versions (dense torch; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _stats_plain(e1, e2, e1a, e2a, sd, t1, t2, row_offset):
    """Undivided (g1, g2, dg1, dg2, m1, m2), as the kernel leaves them."""
    mask = _pair_mask(e1.shape[0], e1a.shape[0], row_offset, e1.device)
    s1 = e1.float() @ e2a.float().T
    s2 = e2.float() @ e1a.float().T
    out = []
    for s, t in ((s1, t1), (s2, t2)):
        diff = s - sd[:, None]
        z = torch.where(mask, diff / t[:, None], MASK_NEG)
        m = z.amax(dim=1)
        p = torch.where(mask, torch.exp(z - m[:, None]), 0.0)
        out.append((p.sum(dim=1), (p * -diff).sum(dim=1) / (t * t), m))
    (g1, dg1, m1), (g2, dg2, m2) = out
    return g1, g2, dg1, dg2, m1, m2


def _grads_plain(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1,
                 t2, t1a, t2a, row_offset):
    """Unfinished (de1, de2, r1, r2), as the kernel leaves them."""
    mask = _pair_mask(e1.shape[0], e1a.shape[0], row_offset, e1.device)
    s1 = e1.float() @ e2a.float().T
    s2 = e2.float() @ e1a.float().T

    def a(z):
        return torch.where(mask, torch.exp(torch.clamp_max(z, EXP_CLAMP)),
                           0.0)

    a1 = a((s1 - sd[:, None]) / t1[:, None] + lwt1[:, None])
    a2 = a((s2 - sd[:, None]) / t2[:, None] + lwt2[:, None])
    m1 = a((s2 - sda[None, :]) / t1a[None, :] + lwt1a[None, :])
    m2 = a((s1 - sda[None, :]) / t2a[None, :] + lwt2a[None, :])
    de1 = (a1 + m2).to(e2a.dtype).float() @ e2a.float()
    de2 = (a2 + m1).to(e1a.dtype).float() @ e1a.float()
    return de1, de2, a1.sum(dim=1), a2.sum(dim=1)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from repro_torch.kernels import build
    lib = build.load("gcl_loss")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gcl_pair_stats_fwd.argtypes = ([i32, i32] + [ptr] * 7 + [i32] * 4
                                       + [ptr] * 6 + [ptr])
    lib.gcl_pair_stats_fwd.restype = i32
    lib.gcl_pair_grads_bwd.argtypes = ([i32, i32] + [ptr] * 14 + [i32] * 4
                                       + [ptr] * 4 + [ptr])
    lib.gcl_pair_grads_bwd.restype = i32
    return lib


def _check(feats, vecs, b, B, d):
    """Device, dtype, shape and contiguity of the launch's inputs."""
    dev = feats["e1"].device
    if dev.type != "cuda":
        raise ValueError(f"gcl kernels need CUDA tensors, got {dev}")
    dt = feats["e1"].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"gcl kernels take float32 or bfloat16, not {dt}")
    for name, t in feats.items():
        rows = b if name in ("e1", "e2") else B
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, e1 on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, e1 is {dt}")
        if tuple(t.shape) != (rows, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{(rows, d)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, (t, n) in vecs.items():
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (n,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({n},) float32 "
                             f"tensor on {dev}")
    if max(b, B, d) >= 2 ** 31:
        raise ValueError("gcl kernels take dims below 2**31")


def _launch_stats(e1, e2, e1a, e2a, sd, t1, t2, row_offset):
    b, d = e1.shape
    B = e1a.shape[0]
    _check({"e1": e1, "e2": e2, "e1_all": e1a, "e2_all": e2a},
           {"sd": (sd, b), "tau1": (t1, b), "tau2": (t2, b)}, b, B, d)
    outs = [torch.empty((b,), dtype=torch.float32, device=e1.device)
            for _ in range(6)]
    lib = _lib()
    stream = torch.cuda.current_stream(e1.device).cuda_stream
    err = lib.gcl_pair_stats_fwd(
        e1.device.index, _DTYPE_CODE[e1.dtype], e1.data_ptr(), e2.data_ptr(),
        e1a.data_ptr(), e2a.data_ptr(), sd.data_ptr(), t1.data_ptr(),
        t2.data_ptr(), b, B, d, int(row_offset),
        *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"gcl_pair_stats_fwd launch failed: cudaError "
                           f"{err}")
    gcl_pair_stats.launches += 1
    return tuple(outs)


def _launch_grads(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1,
                  t2, t1a, t2a, row_offset):
    b, d = e1.shape
    B = e1a.shape[0]
    _check({"e1": e1, "e2": e2, "e1_all": e1a, "e2_all": e2a},
           {"sd": (sd, b), "sd_all": (sda, B), "lwt1": (lwt1, b),
            "lwt2": (lwt2, b), "lwt1_all": (lwt1a, B),
            "lwt2_all": (lwt2a, B), "tau1": (t1, b), "tau2": (t2, b),
            "tau1_all": (t1a, B), "tau2_all": (t2a, B)}, b, B, d)
    de1, de2 = (torch.empty((b, d), dtype=torch.float32, device=e1.device)
                for _ in range(2))
    r1, r2 = (torch.empty((b,), dtype=torch.float32, device=e1.device)
              for _ in range(2))
    lib = _lib()
    stream = torch.cuda.current_stream(e1.device).cuda_stream
    err = lib.gcl_pair_grads_bwd(
        e1.device.index, _DTYPE_CODE[e1.dtype],
        *(t.data_ptr() for t in (e1, e2, e1a, e2a, sd, sda, lwt1, lwt2,
                                 lwt1a, lwt2a, t1, t2, t1a, t2a)),
        b, B, d, int(row_offset),
        *(t.data_ptr() for t in (de1, de2, r1, r2)), stream)
    if err != 0:
        raise RuntimeError(f"gcl_pair_grads_bwd launch failed: cudaError "
                           f"{err}")
    gcl_pair_grads.launches += 1
    return de1, de2, r1, r2


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------

def _stats(inner, e1, e2, tau1, tau2, e1_all, e2_all, row_offset):
    b = e1.shape[0]
    if e1_all is None:
        e1_all, e2_all = e1, e2
    B = e1_all.shape[0]
    sd = torch.sum(e1.float() * e2.float(), dim=-1)
    t1, t2 = _vec(tau1, b, e1.device), _vec(tau2, b, e1.device)
    g1, g2, dg1, dg2, m1, m2 = inner(e1, e2, e1_all, e2_all, sd, t1, t2,
                                     row_offset)
    denom = float(max(B - 1, 1))
    return g1 / denom, g2 / denom, dg1 / denom, dg2 / denom, m1, m2


def gcl_pair_stats(e1, e2, tau1, tau2, *, e1_all=None, e2_all=None,
                   row_offset=0):
    """e1/e2: (b, d) normalised anchor rows (f32 or bf16); tau1/tau2:
    scalar or (b,).  Square case by default (columns are the rows);
    rectangular: ``e1_all``/``e2_all`` are the (B, d) gathered batch and
    ``row_offset`` the global index of local row 0.  Returns the
    shift-decomposed stats (g1, g2, dg1, dg2, m1, m2), each (b,) f32, in
    ``losses.RowStats`` order, sums divided by B - 1."""
    inner = _stats_plain if e1.device.type == "cpu" else _launch_stats
    return _stats(inner, e1, e2, tau1, tau2, e1_all, e2_all, row_offset)


gcl_pair_stats.launches = 0


def gcl_pair_stats_plain(e1, e2, tau1, tau2, *, e1_all=None, e2_all=None,
                         row_offset=0):
    """``gcl_pair_stats`` through the plain version on any device (the
    kernel's yardstick on the card)."""
    return _stats(_stats_plain, e1, e2, tau1, tau2, e1_all, e2_all,
                  row_offset)


def _grads(inner, e1, e2, lwt1, lwt2, tau1, tau2, e1_all, e2_all, sd_all,
           lwt1_all, lwt2_all, tau1_all, tau2_all, row_offset):
    b = e1.shape[0]
    dev = e1.device
    sd = torch.sum(e1.float() * e2.float(), dim=-1)
    lwt1, lwt2 = _vec(lwt1, b, dev), _vec(lwt2, b, dev)
    t1, t2 = _vec(tau1, b, dev), _vec(tau2, b, dev)
    if e1_all is None:
        e1_all, e2_all = e1, e2
        sd_all, lwt1_all, lwt2_all = sd, lwt1, lwt2
        tau1_all, tau2_all = t1, t2
    B = e1_all.shape[0]
    sda = _vec(sd_all, B, dev)
    lwt1a, lwt2a = _vec(lwt1_all, B, dev), _vec(lwt2_all, B, dev)
    t1a, t2a = _vec(tau1_all, B, dev), _vec(tau2_all, B, dev)
    de1, de2, r1, r2 = inner(e1, e2, e1_all, e2_all, sd, sda, lwt1, lwt2,
                             lwt1a, lwt2a, t1, t2, t1a, t2a, row_offset)
    kappa = 1.0 / (B * max(B - 1.0, 1.0))
    rsum = (r1 + r2)[:, None]
    return (kappa * (de1 - rsum * e2.float()),
            kappa * (de2 - rsum * e1.float()))


def gcl_pair_grads(e1, e2, lwt1, lwt2, tau1, tau2, *, e1_all=None,
                   e2_all=None, sd_all=None, lwt1_all=None, lwt2_all=None,
                   tau1_all=None, tau2_all=None, row_offset=0):
    """Closed-form (de1, de2) of L = (1/B) sum_i w1_i g1_i + w2_i g2_i with
    log-domain weights ``lwt* = log(w*) - log(tau*)``.  Square case: the
    ``*_all`` args default to the local ones.  Rectangular: they are the
    gathered (B,)-shaped quantities of the transpose terms; the returned
    (b, d) f32 grads are the local rows."""
    inner = _grads_plain if e1.device.type == "cpu" else _launch_grads
    return _grads(inner, e1, e2, lwt1, lwt2, tau1, tau2, e1_all, e2_all,
                  sd_all, lwt1_all, lwt2_all, tau1_all, tau2_all, row_offset)


gcl_pair_grads.launches = 0


def gcl_pair_grads_plain(e1, e2, lwt1, lwt2, tau1, tau2, *, e1_all=None,
                         e2_all=None, sd_all=None, lwt1_all=None,
                         lwt2_all=None, tau1_all=None, tau2_all=None,
                         row_offset=0):
    """``gcl_pair_grads`` through the plain version on any device."""
    return _grads(_grads_plain, e1, e2, lwt1, lwt2, tau1, tau2, e1_all,
                  e2_all, sd_all, lwt1_all, lwt2_all, tau1_all, tau2_all,
                  row_offset)
