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
kernels (``csrc/gcl_loss.cu``) take any ``d``.  Its source note says what
bounds them on the H100 and how the design answers that.

On the card each kernel is two passes over 32 x 32 tiles of the pair
matrix, a column "split" being one 32-column tile (``n_splits =
ceil(B / 32)``); each pass has a plain PyTorch version here on the same
scratch layouts:

- K1: ``stats_partial`` -> the per-split (m, g, dg) of both sides,
  (2, 3, n_splits, b) f32; ``stats_merge`` -> the splits combined in
  order by the online-max rule and divided by B - 1, (6, b) f32 in
  ``losses.RowStats`` order;
- K2: ``grads_weights`` -> (A1 + M2, A2 + M1) rounded to the feature
  dtype, (2, b, 32 n_splits) (zero where masked), and the per-split row
  sums of A1 and A2, (2, n_splits, b) f64; ``grads_product`` -> de1 =
  P1 e2_all, de2 = P2 e1_all, finished as ``kappa * (de - (r1 + r2) e)``,
  (2, b, d) f32.

Around the launches, in plain torch: ``s_ii`` and the per-row taus.

Dispatch: a tensor on the CPU takes the plain version (``_stats_plain``,
``_grads_plain`` and the finish in torch for the public functions; the
pass's own for a pass); a CUDA tensor launches the kernel or raises.
``gcl_pair_stats.launches`` and ``gcl_pair_grads.launches`` count calls
that went to the kernels, their ``cuda_launches`` the CUDA launches
inside (two per call).  Inputs f32 or bf16; statistics and accumulation
in f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.losses import EXP_CLAMP, MASK_NEG

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SPLIT = 32          # columns per split (the kernels' tile, csrc TN)


def n_splits(B: int, split: int = SPLIT) -> int:
    return -(-B // split)


def _vec(x, n: int, device) -> torch.Tensor:
    """A scalar or (n,) tau as a contiguous (n,) f32 tensor."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.broadcast_to((n,)).contiguous()


def _pair_mask(b: int, B: int, row_offset: int, device) -> torch.Tensor:
    rows = row_offset + torch.arange(b, device=device)[:, None]
    cols = torch.arange(B, device=device)[None, :]
    return (rows != cols) & (rows >= 0)


def _by_split(x, split, fill):
    """(b, B) -> (b, n_splits, split), padded with ``fill`` past B."""
    b, B = x.shape
    return F.pad(x, (0, n_splits(B, split) * split - B),
                 value=fill).reshape(b, -1, split)


def _matmul(a, b):
    """a @ b in f32 (the plain versions' similarities)."""
    return a.float() @ b.float()


def _product(a, b):
    """a @ b in f32 (the plain version of K2's second product)."""
    return a.float() @ b.float()


def _sims(e1, e2, e1a, e2a):
    return _matmul(e1, e2a.T), _matmul(e2, e1a.T)


# ---------------------------------------------------------------------------
# Plain versions (dense torch; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _stats_plain(e1, e2, e1a, e2a, sd, t1, t2, row_offset):
    """Undivided (g1, g2, dg1, dg2, m1, m2) in one pass over all
    columns."""
    mask = _pair_mask(e1.shape[0], e1a.shape[0], row_offset, e1.device)
    out = []
    for s, t in zip(_sims(e1, e2, e1a, e2a), (t1, t2)):
        diff = s - sd[:, None]
        z = torch.where(mask, diff / t[:, None], MASK_NEG)
        m = z.amax(dim=1)
        p = torch.where(mask, torch.exp(z - m[:, None]), 0.0)
        out.append((p.sum(dim=1), (p * -diff).sum(dim=1) / (t * t), m))
    (g1, dg1, m1), (g2, dg2, m2) = out
    return g1, g2, dg1, dg2, m1, m2


def stats_partial_plain(e1, e2, e1a, e2a, sd, t1, t2, row_offset,
                        split=SPLIT):
    """K1's first pass: (2, 3, n_splits, b) f32, [side][m, g, dg][split]
    [row], each split's statistics of ``split`` columns (m = MASK_NEG and
    g = dg = 0 where all its columns are masked)."""
    mask = _by_split(_pair_mask(e1.shape[0], e1a.shape[0], row_offset,
                                e1.device), split, False)
    out = []
    for s, t in zip(_sims(e1, e2, e1a, e2a), (t1, t2)):
        diff = _by_split(s - sd[:, None], split, 0.0)
        z = torch.where(mask, diff / t[:, None, None], MASK_NEG)
        m = z.amax(dim=2)
        p = torch.where(mask, torch.exp(z - m[..., None]), 0.0)
        g = p.sum(dim=2)
        dg = (p * -diff).sum(dim=2) / (t * t)[:, None]
        out.append(torch.stack([m, g, dg]).transpose(1, 2))
    return torch.stack(out).contiguous()


def stats_merge_plain(part, denom):
    """K1's merge: the splits of ``part`` combined in split order by the
    online-max rule, sums divided by ``denom`` -> (6, b) f32, (g1, g2,
    dg1, dg2, m1, m2)."""
    res = []
    for side in part:
        m = torch.full_like(side[0, 0], MASK_NEG)
        g = torch.zeros_like(m)
        dg = torch.zeros_like(m)
        for ms, gs, dgs in zip(side[0], side[1], side[2]):
            mn = torch.maximum(m, ms)
            ea, eb = torch.exp(m - mn), torch.exp(ms - mn)
            g, dg, m = g * ea + gs * eb, dg * ea + dgs * eb, mn
        res.append((g / denom, dg / denom, m))
    (g1, dg1, m1), (g2, dg2, m2) = res
    return torch.stack([g1, g2, dg1, dg2, m1, m2])


def _pair_weights(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1,
                  t2, t1a, t2a, row_offset):
    """A1, A2 and the transpose terms M1, M2, each (b, B) f32."""
    mask = _pair_mask(e1.shape[0], e1a.shape[0], row_offset, e1.device)
    s1, s2 = _sims(e1, e2, e1a, e2a)

    def a(z):
        return torch.where(mask, torch.exp(torch.clamp_max(z, EXP_CLAMP)),
                           0.0)

    return (a((s1 - sd[:, None]) / t1[:, None] + lwt1[:, None]),
            a((s2 - sd[:, None]) / t2[:, None] + lwt2[:, None]),
            a((s2 - sda[None, :]) / t1a[None, :] + lwt1a[None, :]),
            a((s1 - sda[None, :]) / t2a[None, :] + lwt2a[None, :]))


def _grads_plain(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1,
                 t2, t1a, t2a, row_offset):
    """Unfinished (de1, de2, r1, r2) in one pass over all columns."""
    a1, a2, m1, m2 = _pair_weights(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2,
                                   lwt1a, lwt2a, t1, t2, t1a, t2a,
                                   row_offset)
    de1 = (a1 + m2).to(e2a.dtype).float() @ e2a.float()
    de2 = (a2 + m1).to(e1a.dtype).float() @ e1a.float()
    return de1, de2, a1.sum(dim=1), a2.sum(dim=1)


def grads_weights_plain(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a,
                        lwt2a, t1, t2, t1a, t2a, row_offset, split=SPLIT):
    """K2's first pass: the weights (2, b, split * n_splits) in the
    feature dtype, [0] = A1 + M2, [1] = A2 + M1 (zero where masked and past
    B), and the per-split row sums of A1 and A2, (2, n_splits, b) f64."""
    a1, a2, m1, m2 = _pair_weights(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2,
                                   lwt1a, lwt2a, t1, t2, t1a, t2a,
                                   row_offset)
    b = e1.shape[0]
    pw = torch.stack([_by_split(a1 + m2, split, 0.0).reshape(b, -1),
                      _by_split(a2 + m1, split, 0.0).reshape(b, -1)])
    r = torch.stack([_by_split(a, split, 0.0).double().sum(dim=2).T
                     for a in (a1, a2)])
    return pw.to(e1a.dtype).contiguous(), r.contiguous()


def grads_product_plain(pw, e1a, e2a, e1, e2, r, kappa):
    """K2's second pass: (2, b, d) f32, [0] = kappa (P1 e2a - (r1 + r2)
    e2), [1] = kappa (P2 e1a - (r1 + r2) e1), r1 and r2 summed over the
    splits in f64 and rounded to f32."""
    B = e1a.shape[0]
    rsum = (r[0].sum(dim=0).float() + r[1].sum(dim=0).float())[:, None]
    de1 = _product(pw[0, :, :B], e2a)
    de2 = _product(pw[1, :, :B], e1a)
    return torch.stack([kappa * (de1 - rsum * e2.float()),
                        kappa * (de2 - rsum * e1.float())])


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from repro_torch.kernels import build
    lib = build.load("gcl_loss")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, argtypes in (
            ("gcl_stats_partial", [i32] + [ptr] * 7 + [i32] * 4 + [ptr]),
            ("gcl_stats_merge", [ptr, i32, i32, f32, ptr]),
            ("gcl_grads_weights", [i32] + [ptr] * 14 + [i32] * 4
             + [ptr] * 2),
            ("gcl_grads_product", [i32] + [ptr] * 6 + [i32] * 3
             + [f32, ptr])):
        fn = getattr(lib, name)
        fn.argtypes = [i32] + argtypes + [ptr]   # the device first, the stream last
        fn.restype = i32
    return lib


def _call(counter, name, dev, *args):
    err = getattr(_lib(), name)(dev.index, *args,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    counter.cuda_launches += 1


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
                or tuple(t.shape) != tuple(n) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(n)} "
                             f"float32 tensor on {dev}")
    if max(b, B, d) >= 2 ** 31 or B > 65535 * SPLIT:
        raise ValueError(f"gcl kernels take dims below 2**31 and B up to "
                         f"{65535 * SPLIT}")


def stats_partial(e1, e2, e1a, e2a, sd, t1, t2, row_offset):
    """K1, pass 1 (kernel on CUDA tensors): (2, 3, n_splits, b) f32."""
    if e1.device.type == "cpu":
        return stats_partial_plain(e1, e2, e1a, e2a, sd, t1, t2, row_offset)
    b, d = e1.shape
    B = e1a.shape[0]
    _check({"e1": e1, "e2": e2, "e1_all": e1a, "e2_all": e2a},
           {"sd": (sd, (b,)), "tau1": (t1, (b,)), "tau2": (t2, (b,))},
           b, B, d)
    part = torch.empty((2, 3, n_splits(B), b), dtype=torch.float32,
                       device=e1.device)
    _call(gcl_pair_stats, "gcl_stats_partial", e1.device,
          _DTYPE_CODE[e1.dtype], e1.data_ptr(), e2.data_ptr(),
          e1a.data_ptr(), e2a.data_ptr(), sd.data_ptr(), t1.data_ptr(),
          t2.data_ptr(), b, B, d, int(row_offset), part.data_ptr())
    return part


def stats_merge(part, denom):
    """K1, pass 2 (kernel on CUDA tensors): (6, b) f32 in RowStats
    order."""
    if part.device.type == "cpu":
        return stats_merge_plain(part, denom)
    ns, b = part.shape[2:]
    if (part.device.type != "cuda" or part.dtype != torch.float32
            or part.dim() != 4 or part.shape[:2] != (2, 3)
            or not part.is_contiguous() or ns > 65535):
        raise ValueError(f"part must be a contiguous (2, 3, n_splits, b) "
                         f"float32 CUDA tensor, got {part.dtype} "
                         f"{tuple(part.shape)} on {part.device}")
    out = torch.empty((6, b), dtype=torch.float32, device=part.device)
    _call(gcl_pair_stats, "gcl_stats_merge", part.device, part.data_ptr(),
          b, ns * SPLIT, float(denom), out.data_ptr())
    return out


def grads_weights(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1,
                  t2, t1a, t2a, row_offset):
    """K2, pass 1 (kernel on CUDA tensors): (weights (2, b, 32 n_splits)
    in the feature dtype, row sums (2, n_splits, b) f64)."""
    if e1.device.type == "cpu":
        return grads_weights_plain(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2,
                                   lwt1a, lwt2a, t1, t2, t1a, t2a,
                                   row_offset)
    b, d = e1.shape
    B = e1a.shape[0]
    _check({"e1": e1, "e2": e2, "e1_all": e1a, "e2_all": e2a},
           {"sd": (sd, (b,)), "sd_all": (sda, (B,)), "lwt1": (lwt1, (b,)),
            "lwt2": (lwt2, (b,)), "lwt1_all": (lwt1a, (B,)),
            "lwt2_all": (lwt2a, (B,)), "tau1": (t1, (b,)),
            "tau2": (t2, (b,)), "tau1_all": (t1a, (B,)),
            "tau2_all": (t2a, (B,))}, b, B, d)
    ns = n_splits(B)
    pw = torch.empty((2, b, ns * SPLIT), dtype=e1.dtype, device=e1.device)
    r = torch.empty((2, ns, b), dtype=torch.float64, device=e1.device)
    _call(gcl_pair_grads, "gcl_grads_weights", e1.device,
          _DTYPE_CODE[e1.dtype],
          *(t.data_ptr() for t in (e1, e2, e1a, e2a, sd, sda, lwt1, lwt2,
                                   lwt1a, lwt2a, t1, t2, t1a, t2a)),
          b, B, d, int(row_offset), pw.data_ptr(), r.data_ptr())
    return pw, r


def grads_product(pw, e1a, e2a, e1, e2, r, kappa):
    """K2, pass 2 (kernel on CUDA tensors): the finished (2, b, d) f32."""
    if pw.device.type == "cpu":
        return grads_product_plain(pw, e1a, e2a, e1, e2, r, kappa)
    b, d = e1.shape
    B = e1a.shape[0]
    ns = n_splits(B)
    _check({"e1": e1, "e2": e2, "e1_all": e1a, "e2_all": e2a}, {}, b, B, d)
    for name, t, dt, shape in (("weights", pw, e1.dtype, (2, b, ns * SPLIT)),
                               ("r", r, torch.float64, (2, ns, b))):
        if (t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != e1.device):
            raise ValueError(f"{name} must be a contiguous {dt} {shape} "
                             f"tensor on {e1.device}")
    out = torch.empty((2, b, d), dtype=torch.float32, device=e1.device)
    _call(gcl_pair_grads, "gcl_grads_product", e1.device,
          _DTYPE_CODE[e1.dtype],
          *(t.data_ptr() for t in (pw, e1a, e2a, e1, e2, r)), b, B, d,
          float(kappa), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------

def _stats_args(e1, e2, tau1, tau2, e1_all, e2_all):
    b = e1.shape[0]
    if e1_all is None:
        e1_all, e2_all = e1, e2
    sd = torch.sum(e1.float() * e2.float(), dim=-1)
    return (e1_all, e2_all, sd, _vec(tau1, b, e1.device),
            _vec(tau2, b, e1.device), float(max(e1_all.shape[0] - 1, 1)))


def gcl_pair_stats(e1, e2, tau1, tau2, *, e1_all=None, e2_all=None,
                   row_offset=0):
    """e1/e2: (b, d) normalised anchor rows (f32 or bf16); tau1/tau2:
    scalar or (b,).  Square case by default (columns are the rows);
    rectangular: ``e1_all``/``e2_all`` are the (B, d) gathered batch and
    ``row_offset`` the global index of local row 0.  Returns the
    shift-decomposed stats (g1, g2, dg1, dg2, m1, m2), each (b,) f32, in
    ``losses.RowStats`` order, sums divided by B - 1."""
    if e1.device.type == "cpu":
        return gcl_pair_stats_plain(e1, e2, tau1, tau2, e1_all=e1_all,
                                    e2_all=e2_all, row_offset=row_offset)
    e1a, e2a, sd, t1, t2, denom = _stats_args(e1, e2, tau1, tau2, e1_all,
                                              e2_all)
    out = stats_merge(stats_partial(e1, e2, e1a, e2a, sd, t1, t2,
                                    row_offset), denom)
    gcl_pair_stats.launches += 1
    return tuple(out)


gcl_pair_stats.launches = 0
gcl_pair_stats.cuda_launches = 0


def gcl_pair_stats_plain(e1, e2, tau1, tau2, *, e1_all=None, e2_all=None,
                         row_offset=0):
    """``gcl_pair_stats`` through the plain version on any device (the
    kernel's yardstick on the card)."""
    e1a, e2a, sd, t1, t2, denom = _stats_args(e1, e2, tau1, tau2, e1_all,
                                              e2_all)
    g1, g2, dg1, dg2, m1, m2 = _stats_plain(e1, e2, e1a, e2a, sd, t1, t2,
                                            row_offset)
    return g1 / denom, g2 / denom, dg1 / denom, dg2 / denom, m1, m2


def _grads_args(e1, e2, lwt1, lwt2, tau1, tau2, e1_all, e2_all, sd_all,
                lwt1_all, lwt2_all, tau1_all, tau2_all):
    """(e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1, t2, t1a, t2a) as
    the launches take them, and kappa = 1 / (B (B - 1))."""
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
    args = (e1_all, e2_all, sd, _vec(sd_all, B, dev), lwt1, lwt2,
            _vec(lwt1_all, B, dev), _vec(lwt2_all, B, dev), t1, t2,
            _vec(tau1_all, B, dev), _vec(tau2_all, B, dev))
    return args, 1.0 / (B * max(B - 1.0, 1.0))


def gcl_pair_grads(e1, e2, lwt1, lwt2, tau1, tau2, *, e1_all=None,
                   e2_all=None, sd_all=None, lwt1_all=None, lwt2_all=None,
                   tau1_all=None, tau2_all=None, row_offset=0):
    """Closed-form (de1, de2) of L = (1/B) sum_i w1_i g1_i + w2_i g2_i with
    log-domain weights ``lwt* = log(w*) - log(tau*)``.  Square case: the
    ``*_all`` args default to the local ones.  Rectangular: they are the
    gathered (B,)-shaped quantities of the transpose terms; the returned
    (b, d) f32 grads are the local rows."""
    kw = dict(e1_all=e1_all, e2_all=e2_all, sd_all=sd_all,
              lwt1_all=lwt1_all, lwt2_all=lwt2_all, tau1_all=tau1_all,
              tau2_all=tau2_all, row_offset=row_offset)
    if e1.device.type == "cpu":
        return gcl_pair_grads_plain(e1, e2, lwt1, lwt2, tau1, tau2, **kw)
    args, kappa = _grads_args(e1, e2, lwt1, lwt2, tau1, tau2, e1_all,
                              e2_all, sd_all, lwt1_all, lwt2_all, tau1_all,
                              tau2_all)
    pw, r = grads_weights(e1, e2, *args, row_offset)
    out = grads_product(pw, args[0], args[1], e1, e2, r, kappa)
    gcl_pair_grads.launches += 1
    return out[0], out[1]


gcl_pair_grads.launches = 0
gcl_pair_grads.cuda_launches = 0


def gcl_pair_grads_plain(e1, e2, lwt1, lwt2, tau1, tau2, *, e1_all=None,
                         e2_all=None, sd_all=None, lwt1_all=None,
                         lwt2_all=None, tau1_all=None, tau2_all=None,
                         row_offset=0):
    """``gcl_pair_grads`` through the plain version on any device."""
    args, kappa = _grads_args(e1, e2, lwt1, lwt2, tau1, tau2, e1_all,
                              e2_all, sd_all, lwt1_all, lwt2_all, tau1_all,
                              tau2_all)
    de1, de2, r1, r2 = _grads_plain(e1, e2, *args, row_offset)
    rsum = (r1 + r2)[:, None]
    return (kappa * (de1 - rsum * e2.float()),
            kappa * (de2 - rsum * e1.float()))
