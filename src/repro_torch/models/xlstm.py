"""xLSTM blocks (port of ``repro.models.xlstm``; arXiv:2405.04517): the
mLSTM (matrix memory, chunkwise in training and prefill) and the sLSTM
(scalar memory, a sequential recurrence with exponential gating).

mLSTM per head (stabilized, paper eq. 19-27):
    m_t = max(logsig(f~_t) + m_{t-1}, i~_t)
    f'  = exp(logsig(f~_t) + m_{t-1} - m_t);  i' = exp(i~_t - m_t)
    C_t = f' C_{t-1} + i' v_t k_t^T ;  n_t = f' n_{t-1} + i' k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

``mlstm_chunked`` is the chunkwise form (intra-chunk quadratic, the
carry (C, n, m) across chunks in the exp(-m)-stabilized scale),
``mlstm_sequential`` the oracle and the decode path.  Everything here is
plain PyTorch, as the JAX package computes it in plain ``jnp`` and
``lax.scan`` outside any Pallas kernel; the time loops are Python loops.
The loops are what a step costs on the card (a few microseconds of
device work a launch), so the chunked mLSTM loops over its carry alone,
and the sLSTM's recurrence (``_SLSTMScan``) has a hand-written backward
and replays its token loops as CUDA graphs, a window of tokens at a
time.

One place where the port differs from the JAX package (ROADMAP F7): JAX's
``mlstm_chunked`` takes ``exp(b_j - c_i)`` over the whole (i, j) square
and masks the upper triangle afterwards, so an exponent above the
diagonal that passes f32's range gives an inf whose masked gradient is
0 * inf = NaN.  Here the exponent is masked (to -inf) before the exp:
the same forward bits, and a zero gradient above the diagonal.

The recurrences accumulate in f32, or in f64 for f64 inputs (the card's
f64 reference of the gradients); JAX's ``astype(float32)`` sites are
``_acc`` here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

NEG = -1e30       # the stabilizer's start; -inf would give inf - inf


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The accumulation dtype: f32, or f64 for an f64 tensor."""
    return t if t.dtype == torch.float64 else t.float()


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------

def _zero_carry(q, B, H, P):
    dt, dev = _acc(q).dtype, q.device
    return (torch.zeros((B, H, P, P), dtype=dt, device=dev),
            torch.zeros((B, H, P), dtype=dt, device=dev),
            torch.full((B, H), NEG, dtype=dt, device=dev))


def mlstm_sequential(q, k, v, i_raw, f_raw, carry=None):
    """Oracle and decode path.  q/k/v: (B,T,H,P); i_raw/f_raw: (B,T,H).
    carry: (C (B,H,P,P), n (B,H,P), m (B,H)) in the stabilized scale.
    Returns (h (B,T,H,P), carry)."""
    B, T, H, P = q.shape
    q = _acc(q) / math.sqrt(P)
    k, v = _acc(k), _acc(v)
    lf = F.logsigmoid(_acc(f_raw))
    li = _acc(i_raw)
    C, n, m = carry if carry is not None else _zero_carry(q, B, H, P)
    hs = []
    for t in range(T):
        qt, kt, vt, lft, lit = q[:, t], k[:, t], v[:, t], lf[:, t], li[:, t]
        m_new = torch.maximum(lft + m, lit)
        fp = torch.exp(lft + m - m_new)[..., None]
        ip = torch.exp(lit - m_new)[..., None]
        C = fp[..., None] * C + ip[..., None] * vt[..., :, None] * \
            kt[..., None, :]
        n = fp * n + ip * kt
        num = torch.einsum("bhvp,bhp->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunked(q, k, v, i_raw, f_raw, chunk=64):
    """Chunkwise-stabilized mLSTM (training, prefill): the outputs of
    ``mlstm_sequential`` from a zero carry.

    JAX scans the chunks.  Here what does not depend on the carry is
    computed for every chunk at once (the cumulative gates, the
    intra-chunk weights, each chunk's own contribution to the carry),
    and the carry itself, the stabilizer m and then (C, n) at each
    chunk's start, is a loop of a few launches a chunk: the same
    arithmetic, ~1/5 of the launches, for the memory of a (C, n) per
    chunk (B x n_chunks x H x P x P floats: 302 MB at xlstm-125m's 2 x
    4096)."""
    B, T, H, P = q.shape
    Lc = min(chunk, T)
    pad = (-T) % Lc
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=NEG)  # padded i-gate off
        f_raw = F.pad(f_raw, (0, 0, 0, pad))
    nc = (T + pad) // Lc
    qf = (_acc(q) / math.sqrt(P)).reshape(B, nc, Lc, H, P)
    kf = _acc(k).reshape(B, nc, Lc, H, P)
    vf = _acc(v).reshape(B, nc, Lc, H, P)
    lf = F.logsigmoid(_acc(f_raw)).reshape(B, nc, Lc, H)
    li = _acc(i_raw).reshape(B, nc, Lc, H)
    Fc = torch.cumsum(lf, dim=2)                          # (B,nc,Lc,H)
    b = li - Fc                     # log weight relative to the chunk start
    cm = torch.cummax(b, dim=2).values
    FL = Fc[:, :, -1]                                     # (B,nc,H)
    # the stabilizer carried into each chunk, m_prev, and out of it:
    # m' = F_L + max(cummax(b)_L, m_prev)
    C0, n0, m0 = _zero_carry(q, B, H, P)
    m = [m0]
    for ci in range(nc):
        m.append(FL[:, ci] + torch.maximum(cm[:, ci, -1], m[-1]))
    m_prev, m_new = torch.stack(m[:-1], 1), torch.stack(m[1:], 1)
    # per-position stabilizer: m_i = F_i + c_i
    c = torch.maximum(cm, m_prev[:, :, None])
    m_i = Fc + c
    # intra-chunk weights w_ij = exp(b_j - c_i), the exponent masked
    # before the exp (F7)
    idx = torch.arange(Lc, device=q.device)
    tril = (idx[:, None] >= idx[None, :])[:, :, None]      # (i,j,1)
    e = b[:, :, None, :, :] - c[:, :, :, None, :]          # (B,nc,i,j,H)
    wd = torch.exp(torch.where(tril, e, -math.inf))
    G = torch.einsum("bnihp,bnjhp->bnijh", qf, kf) * wd
    num = torch.einsum("bnijh,bnjhv->bnihv", G, vf)
    den = G.sum(dim=3)
    # each chunk's own contribution to the carry at its end, then the
    # carry (C, n) at each chunk's start
    wS = torch.exp(FL[:, :, None] + b - m_new[:, :, None])  # (B,nc,Lc,H)
    decay = torch.exp(FL + m_prev - m_new)                  # (B,nc,H)
    dC = torch.einsum("bnjhv,bnjhp->bnhvp", wS[..., None] * vf, kf)
    dn = torch.einsum("bnjh,bnjhp->bnhp", wS, kf)
    Cs, ns = [C0], [n0]
    for ci in range(nc - 1):
        Cs.append(torch.addcmul(dC[:, ci], decay[:, ci, :, None, None],
                                Cs[-1]))
        ns.append(torch.addcmul(dn[:, ci], decay[:, ci, :, None], ns[-1]))
    C, n = torch.stack(Cs, 1), torch.stack(ns, 1)
    # inter-chunk: scale exp(F_i + m_prev - m_i) = exp(m_prev - c_i)
    sc = torch.exp(m_prev[:, :, None] - c)                 # (B,nc,Lc,H)
    num = num + sc[..., None] * torch.einsum("bnhvp,bnihp->bnihv", C, qf)
    den = den + sc * torch.einsum("bnhp,bnihp->bnih", n, qf)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_i))[..., None]
    return h.reshape(B, nc * Lc, H, P)[:, :T]


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mdims(cfg: ArchConfig):
    d = cfg.d_model
    d_inner = cfg.ssm.expand * d
    H = cfg.n_heads
    return d, d_inner, H, d_inner // H


class MLSTMBlock(nn.Module):
    """Parameters named as the JAX ``init_mlstm_block``: ``norm``,
    ``w_up`` (d -> [x_in, z gate]), ``wq``/``wk``/``wv``, ``w_if``
    (d_inner -> [i, f] per head), ``b_i``, ``b_f``, ``onorm``,
    ``w_down``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        d, d_inner, H, _ = _mdims(cfg)
        self.norm = L.RMSNorm(d)
        self.w_up = L.param(d, 2 * d_inner)
        self.wq = L.param(d_inner, d_inner)
        self.wk = L.param(d_inner, d_inner)
        self.wv = L.param(d_inner, d_inner)
        self.w_if = L.param(d_inner, 2 * H)
        self.b_i = L.param(H)
        self.b_f = L.param(H)
        self.onorm = L.RMSNorm(d_inner)
        self.w_down = L.param(d_inner, d)

    def reset_parameters(self, gen):
        for w in (self.w_up, self.wq, self.wk, self.wv):
            L.dense_init_(w, gen)
        L.dense_init_(self.w_if, gen, scale=0.01)
        L.dense_init_(self.w_down, gen)
        with torch.no_grad():
            self.b_i.zero_()
            self.b_f.fill_(3.0)            # forget gate open at init


def _mlstm_qkvif(blk: MLSTMBlock, cfg, h):
    d, d_inner, H, P = _mdims(cfg)
    xin, z = torch.split(h @ blk.w_up.to(h.dtype), d_inner, dim=-1)
    q = xin @ blk.wq.to(h.dtype)
    k = xin @ blk.wk.to(h.dtype)
    v = xin @ blk.wv.to(h.dtype)
    i_raw, f_raw = torch.split(_acc(xin @ blk.w_if.to(h.dtype)), H, dim=-1)
    shp = (*q.shape[:-1], H, P)
    # (q is scaled by 1/sqrt(P) inside the mLSTM core)
    return (q.reshape(shp), k.reshape(shp), v.reshape(shp),
            i_raw + blk.b_i, f_raw + blk.b_f, z)


def _mlstm_out(blk: MLSTMBlock, x, y, z, d_inner):
    y = y.reshape(x.shape[0], x.shape[1], d_inner).to(x.dtype)
    y = blk.onorm(y) * F.silu(z)
    return x + y @ blk.w_down.to(x.dtype)


def apply_mlstm_block(blk: MLSTMBlock, cfg: ArchConfig, x, *, chunked=True):
    """Prefill / training.  x: (B,T,d)."""
    d_inner = _mdims(cfg)[1]
    q, k, v, i_raw, f_raw, z = _mlstm_qkvif(blk, cfg, blk.norm(x))
    if chunked:
        y = mlstm_chunked(q, k, v, i_raw, f_raw, chunk=cfg.ssm.chunk)
    else:
        y, _ = mlstm_sequential(q, k, v, i_raw, f_raw)
    return _mlstm_out(blk, x, y, z, d_inner)


def init_mlstm_cache(cfg: ArchConfig, batch, lead=(), device=None):
    """Zero decode cache (``C``, ``n``, ``m`` = NEG), f32, with optional
    leading (layer) axes ``lead``."""
    _, _, H, P = _mdims(cfg)
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((*lead, batch, H, P, P), **kw),
            "n": torch.zeros((*lead, batch, H, P), **kw),
            "m": torch.full((*lead, batch, H), NEG, **kw)}


def decode_mlstm_block(blk: MLSTMBlock, cfg: ArchConfig, cache, x):
    """One-token decode.  x: (B,1,d).  Writes the new carry into
    ``cache`` in place (JAX returns a new cache); returns ``(out,
    cache)``."""
    d_inner = _mdims(cfg)[1]
    q, k, v, i_raw, f_raw, z = _mlstm_qkvif(blk, cfg, blk.norm(x))
    y, carry = mlstm_sequential(q, k, v, i_raw, f_raw,
                                carry=(cache["C"], cache["n"], cache["m"]))
    for key, val in zip(("C", "n", "m"), carry):
        cache[key].copy_(val)
    return _mlstm_out(blk, x, y, z, d_inner), cache


# ---------------------------------------------------------------------------
# sLSTM block (sequential scalar recurrence, block-diagonal recurrent R)
# ---------------------------------------------------------------------------

class SLSTMBlock(nn.Module):
    """Parameters named as the JAX ``init_slstm_block``: ``norm``,
    ``w_x`` (d -> the (z, i, f, o) input projections), ``R`` (4, H, P,
    P) block-diagonal recurrent weights per gate, ``b`` (4d: z and i
    zero, f 3.0, o zero), ``gnorm``, ``w_ff`` (a SwiGLU d -> 2d -> d);
    on the card its token loops' graphs, ``window_graphs``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        P = d // H
        self.norm = L.RMSNorm(d)
        self.w_x = L.param(d, 4 * d)
        self.R = L.param(4, H, P, P)
        self.b = L.param(4 * d)
        self.gnorm = L.RMSNorm(d)
        self.w_ff = L.SwiGLU(d, 2 * d)
        self.window_graphs = WindowGraphs()

    def reset_parameters(self, gen):
        L.dense_init_(self.w_x, gen)
        L.normal_init_(self.R, gen, 1.0 / math.sqrt(self.R.shape[-1]))
        d = self.b.shape[0] // 4
        with torch.no_grad():
            self.b.zero_()
            self.b[2 * d:3 * d].fill_(3.0)   # forget gate open at init


def _zero_state(cfg, batch, lead=(), dtype=torch.float32, device=None):
    H = cfg.n_heads
    shape = (*lead, batch, H, cfg.d_model // H)
    z = torch.zeros(shape, dtype=dtype, device=device)
    return (z, z.clone(), z.clone(),
            torch.full(shape, NEG, dtype=dtype, device=device))


def _balanced(a, b):
    """d max(a, b) / d a, as JAX and PyTorch take it: 1 where a > b, 1/2
    at a tie, else 0."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


# On the card the sLSTM's token loops are host-bound: ~17 launches a
# token forward and ~14 backward, each a couple of microseconds of device
# work.  So the loops run in windows of WINDOW tokens, and on the card a
# full window is a CUDA graph of those same launches (``WindowGraphs``).
# A window's arithmetic is the same launches either way, so the bits are
# too.
WINDOW = 64


class WindowGraphs:
    """An sLSTM block's CUDA graphs of its full windows and their buffers
    (``SLSTMBlock.window_graphs``): they live as long as the block, and a
    copy of the block starts without them.  Per window function, shape,
    dtype and inference mode, the first window runs eagerly, the next is
    captured, and every later one replays it (its inputs copied into the
    graph's buffers, its outputs copied out: ~12 launches a window).
    ``captured`` and ``replayed`` count them."""

    def __init__(self):
        self._graphs: "dict[tuple, tuple]" = {}
        self._seen: "set[tuple]" = set()
        self.captured = self.replayed = 0

    def __deepcopy__(self, memo):
        return WindowGraphs()

    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.__init__()

    def run(self, fn, args, outs):
        """``fn(*args)`` on one full window on the card (``args``:
        tensors, views into the whole sequence's buffers; ``fn`` writes
        its results into those at the indices ``outs``)."""
        key = (fn.__name__, torch.is_inference_mode_enabled(),
               args[0].device, *((a.shape, a.dtype) for a in args))
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:     # the first window: eager (warm-up)
                self._seen.add(key)
                fn(*args)
                return
            static = tuple(a.clone() for a in args)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                fn(*static)
            entry = self._graphs[key] = (graph, static)
            self.captured += 1
        graph, static = entry
        for dst, src in zip(static, args):
            dst.copy_(src)
        graph.replay()
        self.replayed += 1
        for i in outs:
            args[i].copy_(static[i])


def _window(fn, args, outs, graphs):
    """``fn(*args)`` on one window: through ``graphs`` (a
    ``WindowGraphs``) for a full window on the card, else eagerly (on the
    CPU, for a window shorter than ``WINDOW``, or ``graphs`` None)."""
    if graphs is None or not args[0].is_cuda or args[0].shape[0] < WINDOW:
        fn(*args)
    else:
        graphs.run(fn, args, outs)


def _forward_window(X, Rm, G, hs, cn, ms):
    """The forward over one window: X, G (K, H, B, 4P); hs, ms (K+1, H,
    B, P) and cn (K+1, 2, H, B, P), whose row 0 holds the state before
    the window; fills G (the pre-activations) and rows 1..K."""
    P = X.shape[-1] // 4
    z1 = X.new_ones((2, *X.shape[1:3], P))      # [z, 1]: c += ip z, n += ip
    w = torch.empty_like(z1)                    # [ip, fp]
    for t in range(X.shape[0]):
        g = torch.baddbmm(X[t], hs[t], Rm, out=G[t])
        torch.tanh(g[..., :P], out=z1[0])
        torch.add(F.logsigmoid(g[..., 2 * P:3 * P]), ms[t], out=w[1])
        m = torch.maximum(g[..., P:2 * P], w[1], out=ms[t + 1])
        torch.sub(g[..., P:2 * P], m, out=w[0])
        w[1].sub_(m)
        w.exp_()
        torch.mul(cn[t], w[1], out=cn[t + 1]).addcmul_(z1, w[0])
        den = torch.maximum(cn[t + 1, 1], torch.exp(-m))
        torch.mul(torch.sigmoid(g[..., 3 * P:]), cn[t + 1, 0],
                  out=hs[t + 1]).div_(den)


def _backward_window(dhs, dh, s, G, hs, cn, ms, Rm, dG):
    """The backward over one window, last token first: ``dhs`` (K, H, B,
    P) the output's gradient; ``dh`` (H, B, P) the gradient reaching h
    at the window's last token (the output's and the next token's); ``s``
    (3, H, B, P) the gradients reaching (c, n, m) from after the window,
    updated in place to those reaching the state before it; G, hs, cn,
    ms as ``_forward_window`` left them; fills ``dG`` (K, H, B, 4P)."""
    K, P = G.shape[0], G.shape[-1] // 4
    # the factors of each step, over the window at once
    gz, gi, gf, go = G.view(*G.shape[:3], 4, P).unbind(3)
    z, o = torch.tanh(gz), torch.sigmoid(go)
    m, h = ms[1:], hs[1:]
    a = F.logsigmoid(gf) + ms[:-1]
    ip, fp = torch.exp(gi - m), torch.exp(a - m)
    c, n = cn[1:, 0], cn[1:, 1]
    e = torch.exp(-m)
    den = torch.maximum(n, e)
    hd = h / den
    mn = _balanced(n, e)
    mi = _balanced(gi, a)
    # dh -> (dc, dn, dm); dc -> dz; dh -> do; (dc, dn) -> (u, v) =
    # (dip ip, dfp fp); dm - u - v -> (di, da) by the max's split
    k_dh = torch.stack([o / den, -hd * mn, hd * (1 - mn) * e], 1)
    k_z = ip * (1 - z * z)
    k_o = c / den * o * (1 - o)
    k_dc = torch.stack([z * ip, cn[:-1, 0] * fp], 3)          # (K,H,B,2,P)
    k_dn = torch.stack([ip, cn[:-1, 1] * fp], 3)
    k_m = torch.stack([mi, 1 - mi], 3)
    s_f = torch.sigmoid(-gf)
    dG4 = dG.view(*dG.shape[:3], 4, P)
    RmT = Rm.transpose(1, 2)
    dme = torch.empty_like(dh)
    for t in range(K - 1, -1, -1):
        s.addcmul_(k_dh[t], dh)
        torch.mul(s[0], k_z[t], out=dG4[t, :, :, 0])
        torch.mul(dh, k_o[t], out=dG4[t, :, :, 3])
        uv = dG4[t, :, :, 1:3]                                 # (H,B,2,P)
        torch.mul(k_dc[t], s[0, :, :, None], out=uv)
        uv.addcmul_(k_dn[t], s[1, :, :, None])
        torch.sub(s[2], uv.sum(2), out=dme)
        uv.addcmul_(k_m[t], dme[:, :, None])                   # [di, da]
        s[2].copy_(uv[:, :, 1])                                # dm_{t-1}
        uv[:, :, 1].mul_(s_f[t])                               # df
        s[:2].mul_(fp[t])
        if t:
            dh = torch.baddbmm(dhs[t - 1], dG[t], RmT)


def _windows(T):
    return [(t0, min(t0 + WINDOW, T)) for t0 in range(0, T, WINDOW)]


def _scan_forward(X, Rm, h0, c0, n0, m0, graphs):
    """The forward's token loop (``_SLSTMScan``): (G, hs, cn, ms)."""
    T, H, B, P4 = X.shape
    G = torch.empty_like(X)
    hs = X.new_empty((T + 1, H, B, P4 // 4))
    cn = X.new_empty((T + 1, 2, H, B, P4 // 4))
    ms = torch.empty_like(hs)
    hs[0].copy_(h0)
    cn[0, 0].copy_(c0)
    cn[0, 1].copy_(n0)
    ms[0].copy_(m0)
    for t0, t1 in _windows(T):
        _window(_forward_window, (X[t0:t1], Rm, G[t0:t1], hs[t0:t1 + 1],
                                  cn[t0:t1 + 1], ms[t0:t1 + 1]),
                outs=(2, 3, 4, 5), graphs=graphs)
    return G, hs, cn, ms


def _scan_backward(dhs, Rm, G, hs, cn, ms, graphs):
    """The backward's token loop (``_SLSTMScan``): (dG, dRm)."""
    T, H, B, P4 = G.shape
    dG = torch.empty_like(G)
    s = dhs.new_zeros((3, H, B, P4 // 4))                     # dc, dn, dm
    dh = dhs[T - 1].clone()
    RmT = Rm.transpose(1, 2)
    for t0, t1 in reversed(_windows(T)):
        _window(_backward_window, (dhs[t0:t1], dh, s, G[t0:t1],
                                   hs[t0:t1 + 1], cn[t0:t1 + 1],
                                   ms[t0:t1 + 1], Rm, dG[t0:t1]),
                outs=(2, 8), graphs=graphs)
        if t0:
            dh = torch.baddbmm(dhs[t0 - 1], dG[t0], RmT)
    dRm = torch.bmm(hs[:-1].permute(1, 3, 0, 2).reshape(H, P4 // 4, T * B),
                    dG.permute(1, 0, 2, 3).reshape(H, T * B, P4))
    return dG, dRm


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over (T, H, B, 4P) gate pre-activations
    without the recurrent term (the input projections and the bias, the
    gates in the order z, i, f, o), ``Rm`` (H, P, 4P) the recurrent
    weights of the four gates side by side, and a start state (h, c, n,
    m) each (H, B, P), and the block's ``WindowGraphs`` (None: every
    window eager).  Returns h (T, H, B, P) and the final state.

    The backward is the recurrence's own, derived by hand (the gradient
    reaches the pre-activations and ``Rm``; the start state is a
    constant): autograd through the token loop records ~50 nodes a token
    and, under the block's recompute, sends each saved tensor through a
    Python hook.  Here the forward is ~17 launches a token, the backward
    ~14: the factors each step multiplies by come from the saved
    pre-activations and states in a few operations over a window first,
    and ``Rm``'s gradient is one ``bmm`` at the end.  A max splits its
    gradient at a tie, as ``torch.maximum`` and JAX's ``jnp.maximum``
    do."""

    @staticmethod
    def forward(ctx, X, Rm, h0, c0, n0, m0, graphs):
        G, hs, cn, ms = _scan_forward(X, Rm, h0, c0, n0, m0, graphs)
        ctx.save_for_backward(Rm, G, hs, cn, ms)
        ctx.graphs = graphs
        last = (hs[-1].clone(), cn[-1, 0].clone(), cn[-1, 1].clone(),
                ms[-1].clone())
        ctx.mark_non_differentiable(*last)
        return (hs[1:], *last)

    @staticmethod
    def backward(ctx, dhs, *_):
        dG, dRm = _scan_backward(dhs.contiguous(), *ctx.saved_tensors,
                                 ctx.graphs)
        return dG, dRm, None, None, None, None, None


def slstm_scan(blk: SLSTMBlock, cfg: ArchConfig, xproj, state=None, *,
               graphs=True):
    """xproj: (B,T,4d) input projections.  A sequential scan over T;
    state: (h, c, n, m), each (B,H,P), a constant (no gradient reaches
    it).  Returns (h (B,T,d), state).  ``graphs=False`` runs every
    window eagerly, also on the card.

    Per step one ``baddbmm`` for the four gates' recurrent products (R
    laid out as (H, P, 4P)) and the gate arithmetic (``_SLSTMScan``);
    the bias is added to the input projections once, before the loop."""
    B, T, _ = xproj.shape
    d, H = cfg.d_model, cfg.n_heads
    P = d // H
    Rm = _acc(blk.R).permute(1, 2, 0, 3).reshape(H, P, 4 * P)  # [h,p,(g,q)]
    xb = (_acc(xproj).reshape(B, T, 4, H, P)
          + _acc(blk.b).reshape(4, H, P))
    X = xb.permute(1, 3, 0, 2, 4).reshape(T, H, B, 4 * P)
    if state is None:
        state = _zero_state(cfg, B, dtype=X.dtype, device=X.device)
    hs, *last = _SLSTMScan.apply(X, Rm, *(s.detach().transpose(0, 1)
                                           for s in state),
                                 blk.window_graphs if graphs else None)
    return (hs.permute(2, 0, 1, 3).reshape(B, T, d),
            tuple(s.transpose(0, 1) for s in last))


def _slstm_out(blk: SLSTMBlock, x, y):
    x = x + blk.gnorm(y.to(x.dtype))
    return x + blk.w_ff(x)


def apply_slstm_block(blk: SLSTMBlock, cfg: ArchConfig, x, *, graphs=True):
    """Prefill / training.  x: (B,T,d); ``graphs``: ``slstm_scan``'s."""
    h = blk.norm(x)
    y, _ = slstm_scan(blk, cfg, h @ blk.w_x.to(h.dtype), graphs=graphs)
    return _slstm_out(blk, x, y)


def init_slstm_cache(cfg: ArchConfig, batch, lead=(), device=None):
    """Zero decode cache (``h``, ``c``, ``n``, ``m`` = NEG), f32, with
    optional leading (layer) axes ``lead``."""
    return dict(zip("hcnm", _zero_state(cfg, batch, lead, device=device)))


def decode_slstm_block(blk: SLSTMBlock, cfg: ArchConfig, cache, x):
    """One-token decode.  x: (B,1,d).  Writes the new state into
    ``cache`` in place; returns ``(out, cache)``."""
    h = blk.norm(x)
    y, state = slstm_scan(blk, cfg, h @ blk.w_x.to(h.dtype),
                          state=tuple(cache[k] for k in "hcnm"))
    for key, val in zip("hcnm", state):
        cache[key].copy_(val)
    return _slstm_out(blk, x, y), cache
