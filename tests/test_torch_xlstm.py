"""The port's xLSTM family (``xlstm-125m``, ``models/xlstm.py`` and the ssm
branches of ``models/backbones.py``) against the JAX package on the CPU.
The same inputs, made from numpy seeds, and one set of params (the
port's init, with every norm scale and gate bias drawn away from its
init value so that a swap shows, carried to JAX by the bridge: JAX's
init would cost a compile) go through both packages:

  * the mLSTM cores, ``mlstm_sequential`` (with its carry) and
    ``mlstm_chunked``, at T 40 / chunk 8, T 40 / chunk 40 and T 37 /
    chunk 8 (the padding branch): rtol 1e-5 (atol 1e-6 for entries near
    zero);
  * ``slstm_scan`` from zero and from a given state: the same bounds;
    its hand-written backward, across the token windows that the card
    replays as CUDA graphs, against autograd through JAX's steps in
    plain PyTorch, in f64 (1e-9); on the card (``cuda`` marker), the
    graphs against the eager windows, to the bit;
    each block's forward (the mLSTM chunked and sequential) and its
    decode token by token, the decode caches: rtol 1e-5, atol 1e-5;
  * the backbone at ``reduced().replace(n_layers=8, ssm chunk 16)`` (two
    units of ``mmms``: both block kinds; three chunks at T = 40, the
    last padded): ``lm_loss`` rtol 1e-5; ``forward_hidden`` (chunked and
    sequential mLSTM), ``prefill_logits``, ``encode``, ``decode_step``
    over the sequence against JAX's decode, and the decode state after
    the prompt leaf by leaf, each within 1e-4 relative L2; decode
    against the port's own forward 5e-3 (tests/test_decode_equivalence
    .py);
  * ``lm_loss``'s gradients against JAX's (the first AdamW moment of a
    JAX step at the warm-up's lr 0, / (1 - beta1)) and both against the
    port's gradients in f64, each leaf within 1e-3 relative L2; the
    recompute bitwise;
  * two ``make_lm_train_step`` steps and two v3 ``make_train_step``
    steps against JAX's (the first at lr 0), per group of leaves:
    AdamW's moments within 1e-3 and the update / lr within 3e-2 relative
    L2 (the update is m / (sqrt(v) + eps): an entry whose gradient lies
    within the f32 noise below moves by a sign that rounding decides;
    1.47e-2 measured, ``embed``);
  * F7: JAX's chunked mLSTM gives non-finite gate gradients at large
    gates; the port's are finite, equal autograd through its sequential
    mLSTM in f64 (rtol 1e-4) and lie within 1e-3 relative L2 of that in
    f32.

The bounds from the model up are wider than the other families' (1e-4,
1e-5): f32 rounding moves this model's outputs by ~2e-5 and each leaf's
gradient by 4e-5 to 3e-4 (relative L2) from an f64 reference, in either
package alike (measured on this reduced config, perturbed or not): the
exponential gates and the division by max(|n . q|, exp(-m)) amplify
it.  ``test_lm_loss_gradients_match_jax`` measures both packages'
distance to the port's f64 gradients and holds it to the same bound.
  * the configs, the full-size parameter tree, the bridge, the
    launchers, the long_500k serve step and one ``data:1,fsdp:2``
    contrastive step (tests/helpers/torch_mesh_check.py battery
    ``xlstm``).
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.core import fastclip as JFC
from repro.launch import steps as JST
from repro.models import backbones as JBB
from repro.models import xlstm as JX
from repro_torch import checkpoint as TCK
from repro_torch.checkpoint import bridge, flatten, unflatten
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import fastclip as TFC
from repro_torch.core import train_step as TTS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import LMDataset as TLD
from repro_torch.data import PairedEmbeddingDataset as TPD
from repro_torch.data import ShardedLoader as TSL
from repro_torch.launch import serve, steps, train
from repro_torch.models import backbones as TBB
from repro_torch.models import precision as PR
from repro_torch.models import xlstm as TX
from repro_torch.optim import adamw

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_mesh_check as H  # noqa: E402

ARCH = "xlstm-125m"
FULL_PARAMS = 193_280_584
B, S, N = 2, 40, 16
GB = 4                      # the contrastive steps' global batch
LR, TOTAL = 0.5, 10
CORE_RTOL, CORE_ATOL = 1e-5, 1e-6
BLOCK_TOL = 1e-5
MODEL_TOL, LOSS_RTOL, PREFILL_DECODE_TOL = 1e-4, 1e-5, 5e-3
GRAD_TOL, MOMENT_TOL, UPDATE_TOL = 1e-3, 1e-3, 3e-2
U_TOL = 1e-4                # the FCCO u after a step, rtol and atol
F64 = PR.Precision("f64", compute_dtype=torch.float64,
                   output_dtype=torch.float64)
BETA1 = 0.9                 # AdamW's, in both packages
UNREACHED = {"lm": ["ctr_proj", "pair_proj"], "contrastive": ["lm_head"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the CPU matmuls' bits
    depend on the thread count, and the suite's workers share the host's
    cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(n_layers=8, chunk=16):
    """Both packages' reduced xLSTM: at 8 layers two units of ``mmms``
    (``reduced()`` alone gives ``mm``, no sLSTM), chunk 16."""
    out = []
    for get in (j_get_arch, t_get_arch):
        c = get(ARCH).reduced()
        out.append(c.replace(n_layers=n_layers, ssm=dataclasses.replace(
            c.ssm, chunk=chunk)))
    return out


def jax_flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(state):
    """Owned numpy copies (the model's parameters change in place)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in flatten(
        bridge.state_to_tree(state)).items()}


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, rtol=CORE_RTOL, atol=CORE_ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _near(got, want, what=""):
    """Within ``MODEL_TOL`` relative L2."""
    rel = _rel_l2(got, want)
    assert rel <= MODEL_TOL, (what, rel)


def _groups(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            out.setdefault(k[len(prefix):].split("/")[0], []).append(
                np.asarray(v, np.float64).ravel())
    return {g: np.concatenate(v) for g, v in out.items()}


def _perturb(flat, seed):
    """Norm scales away from one, the gate biases away from their init."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("scale"):
            v = v * (1.0 + 0.5 * rng.standard_normal(v.shape,
                                                     dtype=np.float32))
        elif k.endswith(("b_i", "b_f", "/b")):
            v = v + 0.5 * rng.standard_normal(v.shape, dtype=np.float32)
        out[k] = v.astype(np.float32)
    return out


def _module_flat(mod):
    return {k: v.detach().numpy() for k, v in flatten(
        bridge.model_to_tree(mod)).items()}


def _block(kind, tcfg, seed):
    """A perturbed port block and its JAX params."""
    cls = TX.MLSTMBlock if kind == "m" else TX.SLSTMBlock
    blk = cls(tcfg)
    gen = torch.Generator().manual_seed(seed)
    for m in blk.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    flat = _perturb(_module_flat(blk), seed)
    bridge.load_tree(blk, unflatten(flat))
    return blk, jax.tree.map(jnp.asarray, unflatten(flat))


def _core_inputs(T, B_=2, H=2, P=8, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B_, T, H, P), dtype=np.float32)
               for _ in range(3))
    i_raw = rng.standard_normal((B_, T, H), dtype=np.float32) * scale
    f_raw = rng.standard_normal((B_, T, H), dtype=np.float32) * scale + 2.0
    return q, k, v, i_raw, f_raw


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# The cores and the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,chunk", [(40, 8), (40, 40), (37, 8)])
def test_mlstm_cores_match_jax(T, chunk):
    ins = _core_inputs(T)
    jy, jcarry = JX.mlstm_sequential(*_j(*ins))
    jc = JX.mlstm_chunked(*_j(*ins), chunk=chunk)
    y, carry = TX.mlstm_sequential(*_t(*ins))
    yc = TX.mlstm_chunked(*_t(*ins), chunk=chunk)
    _close(y, jy, what="sequential")
    _close(yc, jc, what="chunked")
    for name, a, b in zip("Cnm", carry, jcarry):
        _close(a, b, what=name)
    # a carry given: the second half of the sequence from the first's
    half = T // 2
    first = TX.mlstm_sequential(*(a[:, :half] for a in _t(*ins)))[1]
    y2, _ = TX.mlstm_sequential(*(a[:, half:] for a in _t(*ins)),
                                carry=first)
    _close(y2, jy[:, half:], what="carried")


def test_slstm_scan_matches_jax():
    _, tcfg = _cfgs()
    blk, jp = _block("s", tcfg, 1)
    rng = np.random.default_rng(2)
    xproj = rng.standard_normal((B, 12, 4 * tcfg.d_model), dtype=np.float32)
    jy, jstate = JX.slstm_scan(jp, tcfg, jnp.asarray(xproj))
    with torch.no_grad():
        y, state = TX.slstm_scan(blk, tcfg, torch.from_numpy(xproj))
        y2, _ = TX.slstm_scan(blk, tcfg, torch.from_numpy(xproj[:, 6:]),
                              state=TX.slstm_scan(
                                  blk, tcfg, torch.from_numpy(xproj[:, :6]))[1])
    _close(y, jy, what="h")
    for name, a, b in zip("hcnm", state, jstate):
        _close(a, b, what=name)
    _close(y2, jy[:, 6:], what="from a state")


def _plain_slstm(blk, cfg, xproj):
    """JAX's ``slstm_scan`` step by step in plain PyTorch, in the input's
    dtype: the reference that autograd differentiates."""
    B, T, _ = xproj.shape
    H = cfg.n_heads
    P = cfg.d_model // H
    R, b = blk.R.to(xproj.dtype), blk.b.to(xproj.dtype)
    h = c = n = xproj.new_zeros((B, H, P))
    m = xproj.new_full((B, H, P), TX.NEG)
    hs, branches = [], []
    for t in range(T):
        tot = (xproj[:, t].reshape(B, 4, H, P) + b.reshape(4, H, P)
               + torch.einsum("bhp,ghpq->bghq", h, R))
        lf = torch.nn.functional.logsigmoid(tot[:, 2])
        m_new = torch.maximum(lf + m, tot[:, 1])
        ip = torch.exp(tot[:, 1] - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * torch.tanh(tot[:, 0])
        n = fp * n + ip
        e = torch.exp(-m_new)
        branches.append(torch.stack([tot[:, 1] > lf + m, n > e]))
        h = torch.sigmoid(tot[:, 3]) * c / torch.maximum(n, e)
        m = m_new
        hs.append(h)
    return (torch.stack(hs, 1).reshape(B, T, -1), (h, c, n, m),
            torch.stack(branches).flatten(2).double().mean(2))


@pytest.mark.parametrize("T", [TX.WINDOW - 1, 2 * TX.WINDOW + 5])
def test_slstm_hand_backward_matches_autograd_across_windows(T):
    """The sLSTM scan's hand-written backward, over one window short of
    ``WINDOW`` and over two windows and a part one, against autograd
    through ``_plain_slstm``, in f64: outputs, final state and the
    gradients of the input projections, ``R`` and ``b`` within 1e-9
    (the same arithmetic, in another order).  The inputs are scaled so
    that both maxes (i against f + m, n against exp(-m)) take each of
    their sides."""
    _, tcfg = _cfgs()
    blk, _ = _block("s", tcfg, 5)
    blk = blk.double()
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((B, T, 4 * tcfg.d_model), generator=gen,
                    dtype=torch.float64) * 3.0
    w = torch.randn((B, T, tcfg.d_model), generator=gen, dtype=torch.float64)
    out = {}
    for name in ("hand", "plain"):
        blk.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_(True)
        if name == "hand":
            y, state = TX.slstm_scan(blk, tcfg, xx)
        else:
            y, state, branches = _plain_slstm(blk, tcfg, xx)
        (y * w).sum().backward()
        out[name] = [y.detach(), *(s_.detach() for s_ in state), xx.grad,
                     blk.R.grad, blk.b.grad]
    share = branches[1:].mean(0)          # past the first token
    assert bool(((share > 0.01) & (share < 0.99)).all()), share
    for what, a, b_ in zip(["h", "h_T", "c_T", "n_T", "m_T", "dx", "dR",
                            "db"], out["hand"], out["plain"]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=what)


@pytest.mark.cuda
def test_slstm_graphs_equal_the_eager_windows():
    """On the card, a full window runs as a replayed CUDA graph: the same
    launches as the eager window, so the same bits, forward and
    backward, over three windows and a part one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    _, tcfg = _cfgs()
    blk = _block("s", tcfg, 5)[0].cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    T = 3 * TX.WINDOW + 7
    x = torch.randn((B, T, 4 * tcfg.d_model), generator=gen, device="cuda")
    w = torch.randn((B, T, tcfg.d_model), generator=gen, device="cuda")
    got = {}
    for graphs in (False, True, True):     # eager; capture; replay
        blk.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_(True)
        y, _ = TX.slstm_scan(blk, tcfg, xx, graphs=graphs)
        (y * w).sum().backward()
        got.setdefault(graphs, []).append(
            [y.detach(), xx.grad, blk.R.grad, blk.b.grad])
    # forward and backward: each captured once, then replayed
    assert blk.window_graphs.captured == 2
    assert blk.window_graphs.replayed > 2
    for run in got[True]:
        for a, b_ in zip(run, got[False][0]):
            assert torch.equal(a, b_)


def test_slstm_window_graphs_belong_to_the_block():
    """The sLSTM's CUDA graphs live on their block: a copy of the block
    (the card's f64 reference is one) and a pickled one start without
    any, the parameters' state dict does not hold them, and on the CPU
    every window runs eagerly, so none is captured."""
    import copy
    import pickle
    _, tcfg = _cfgs()
    blk = _block("s", tcfg, 5)[0]
    wg = blk.window_graphs
    wg._seen.add("a key")
    x = torch.randn((B, 2 * TX.WINDOW, 4 * tcfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    TX.slstm_scan(blk, tcfg, x)
    assert (wg.captured, wg.replayed) == (0, 0)
    for other in (copy.deepcopy(blk).double(),
                  pickle.loads(pickle.dumps(blk))):
        assert other.window_graphs is not wg
        assert not other.window_graphs._seen
    assert not any("graph" in k for k in blk.state_dict())


@pytest.mark.parametrize("kind", ["m", "s"])
def test_block_forward_and_decode_match_jax(kind):
    """Each block's forward (the mLSTM chunked and sequential) and its
    decode token by token against JAX's, the caches after the last
    token too."""
    _, tcfg = _cfgs()
    blk, jp = _block(kind, tcfg, 3)
    rng = np.random.default_rng(4)
    T = 21
    x = rng.standard_normal((B, T, tcfg.d_model), dtype=np.float32) * 0.5
    if kind == "m":
        jfwd = lambda c: JX.apply_mlstm_block(jp, tcfg, jnp.asarray(x),
                                              chunked=c)
        fwd = lambda c: TX.apply_mlstm_block(blk, tcfg, torch.from_numpy(x),
                                             chunked=c)
        jinit, init = JX.init_mlstm_cache, TX.init_mlstm_cache
        jdec, dec = JX.decode_mlstm_block, TX.decode_mlstm_block
        keys = "Cnm"
    else:
        jfwd = lambda c: JX.apply_slstm_block(jp, tcfg, jnp.asarray(x))
        fwd = lambda c: TX.apply_slstm_block(blk, tcfg, torch.from_numpy(x))
        jinit, init = JX.init_slstm_cache, TX.init_slstm_cache
        jdec, dec = JX.decode_slstm_block, TX.decode_slstm_block
        keys = "hcnm"
    jdec = jax.jit(functools.partial(jdec, jp, tcfg))
    with torch.no_grad():
        for chunked in (True, False):
            _close(fwd(chunked), jfwd(chunked), BLOCK_TOL, BLOCK_TOL,
                   f"chunked={chunked}")
        jc, cache = jinit(tcfg, B), init(tcfg, B)
        for t in range(T):
            jo, jc = jdec(jc, jnp.asarray(x[:, t:t + 1]))
            o, cache = dec(blk, tcfg, cache, torch.from_numpy(x[:, t:t + 1]))
            _close(o, jo, BLOCK_TOL, BLOCK_TOL, f"decode {t}")
    assert sorted(cache) == sorted(jc) == sorted(keys)
    for k in keys:
        _close(cache[k], jc[k], BLOCK_TOL, BLOCK_TOL, k)


# ---------------------------------------------------------------------------
# F7: the chunked mLSTM's gate gradients past f32's exp range
# ---------------------------------------------------------------------------

def test_chunked_gate_gradient_is_finite_past_the_exp_range():
    """At tests/test_xlstm.py's large gates (scale 30, chunk 8) an
    exponent above the diagonal passes f32's exp range: JAX's
    ``mlstm_chunked`` masks after the exp and its gate gradients are
    non-finite (0 * inf); the port masks the exponent before the exp,
    and its gradients are finite and equal autograd through its
    ``mlstm_sequential``: in f64 within rtol 1e-4 (the same function:
    1e-13 measured), in f32 within ``GRAD_TOL`` relative L2 of that
    (9.4e-5 measured on q and k, where gates at the exp range amplify
    f32 rounding)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    T, scale = 32, 30.0
    ins = [np.asarray(jax.random.normal(ks[i], (2, T, 2, 8)))
           for i in range(3)]
    ins.append(np.asarray(jax.random.normal(ks[3], (2, T, 2))) * scale)
    ins.append(np.asarray(jax.random.normal(ks[4], (2, T, 2))) * scale + 2.0)
    jg = jax.grad(lambda i, f: JX.mlstm_chunked(
        *_j(*ins[:3]), i, f, chunk=8).sum(), argnums=(0, 1))(
        *_j(*ins[3:]))
    assert not all(bool(jnp.all(jnp.isfinite(g))) for g in jg)

    def grads(fn, dtype):
        ts = [t.to(dtype).requires_grad_() for t in _t(*ins)]
        fn(*ts).sum().backward()
        return [t.grad.double().numpy() for t in ts]
    chunked = lambda *a: TX.mlstm_chunked(*a, chunk=8)
    sequential = lambda *a: TX.mlstm_sequential(*a)[0]
    got = grads(chunked, torch.float32)
    got64 = grads(chunked, torch.float64)
    want64 = grads(sequential, torch.float64)
    for name, g, g64, w in zip(("q", "k", "v", "i_raw", "f_raw"), got,
                               got64, want64):
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g64, w, rtol=1e-4, atol=1e-12,
                                   err_msg=name)
        assert _rel_l2(g, w) <= GRAD_TOL, (name, _rel_l2(g, w))
    # the forward keeps JAX's values
    _close(TX.mlstm_chunked(*_t(*ins), chunk=8).detach(),
           JX.mlstm_chunked(*_j(*ins), chunk=8), rtol=1e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# The backbone against JAX (one module-scoped JAX run)
# ---------------------------------------------------------------------------

def _lm_batch(cfg, i=0):
    return TLD(n=N, seq_len=S, vocab_size=cfg.vocab_size).batch(
        np.arange(B * i, B * (i + 1)))


def _fc(mod, loss_impl="dense"):
    return mod.FastCLIPConfig(version="v3", n_samples=N,
                              steps_per_epoch=N // GB, gamma_decay_epochs=1,
                              loss_impl=loss_impl)


def _jb(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tb(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the forward, prefill logits, embedding and
    loss; the decode over the sequence and its state; two jitted LM
    steps (the first at lr 0: its first moment is (1 - beta1) g); two
    jitted v3 steps."""
    jcfg, tcfg = _cfgs()
    init = TBB.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat = _perturb(_module_flat(init), 1)
    params = jax.tree.map(jnp.asarray, unflatten(flat))
    b0 = _lm_batch(tcfg)
    jb0 = _jb(b0)

    @jax.jit
    def serve_side(p):
        h, _ = JBB.forward_hidden(p, jcfg, jb0)
        return (h, JBB.logits_from_hidden(p, jcfg, h),
                JBB.encode(p, jcfg, jb0), JBB.lm_loss(p, jcfg, jb0)[0])
    hidden, logits, emb, loss = (np.asarray(a) for a in serve_side(params))
    jdec = jax.jit(lambda p, st, tok: JBB.decode_step(p, jcfg, st, tok, 0))
    st = JBB.init_decode_state(jcfg, B, S, jnp.float32)
    dec_logits, dec_states = [], {}
    for t in range(S):
        lg, st = jdec(params, st, jnp.asarray(b0["tokens"][:, t:t + 1]))
        dec_logits.append(np.asarray(lg))
        if t in (S // 2 - 1, S - 1):
            dec_states[t] = jax_flat(st)
    lm_batches = [b0, _lm_batch(tcfg, 1)]
    step_fn, opt = JST.make_lm_train_step(jcfg, lr=LR, wd=0.1,
                                          total_steps=TOTAL)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(step_fn)
    lm_states, lm_losses = [jax_flat(state)], []
    for b in lm_batches:
        state, m = jstep(state, _jb(b))
        lm_states.append(jax_flat(state))
        lm_losses.append(float(m["loss"]))
    grads = {k[len("opt/m/"):]: v / np.float32(1 - BETA1)
             for k, v in lm_states[1].items() if k.startswith("opt/m/")}
    ctr_data = [(idx, b) for _, _, idx, b in TSL(
        TPD(n=N, seq_len=S, vocab_size=tcfg.vocab_size), global_batch=GB,
        seed=3).steps(2)]
    cstep, jtc = JST.make_contrastive_train_step(
        jcfg, _fc(JFC), lr=LR, wd=0.1, total_steps=TOTAL)
    cstate = {"params": params, "opt": jtc.optimizer.init(params),
              "fc": JFC.init_state(jtc.fc), "step": jnp.zeros((), jnp.int32)}
    jcstep = jax.jit(cstep)
    ctr_states, ctr_metrics = [jax_flat(cstate)], []
    for idx, b in ctr_data:
        cstate, m = jcstep(cstate, _jb(b), jnp.asarray(idx))
        ctr_states.append(jax_flat(cstate))
        ctr_metrics.append({k: float(v) for k, v in m.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, flat=flat, batch=b0, hidden=hidden,
                logits=logits, emb=emb, loss=float(loss),
                dec_logits=np.stack(dec_logits, 1), dec_states=dec_states,
                lm_batches=lm_batches, lm_states=lm_states,
                lm_losses=lm_losses, grads=grads, ctr_data=ctr_data,
                ctr_states=ctr_states, ctr_metrics=ctr_metrics,
                jstate=jax.device_get(state))


def _model(ref):
    return TBB.params_from_tree(ref["tcfg"], unflatten(ref["flat"]), "cpu")


def test_forward_prefill_encode_and_loss_match_jax(ref):
    tcfg = ref["tcfg"]
    model = _model(ref)
    assert isinstance(model, TBB.XLSTMLM)
    assert [type(b).__name__[0] for b in TBB._xlstm_blocks(model)] == \
        list("MMMSMMMS")
    tb = _tb(ref["batch"])
    with torch.inference_mode():
        h, aux = TBB.forward_hidden(model, tcfg, tb)
        seq, _ = TBB.forward_hidden(model, tcfg, tb, chunked=False)
        logits = steps.make_prefill_step(tcfg)(model, tb)
        emb = TBB.encode(model, tcfg, tb)
        loss, metrics = TBB.lm_loss(model, tcfg, tb)
    assert aux == {} and logits.shape == (B, 1, tcfg.padded_vocab)
    _near(h, ref["hidden"], "hidden")
    _near(seq, ref["hidden"], "sequential mLSTM")
    _near(logits, ref["logits"][:, -1:], "prefill")
    _near(emb, ref["emb"], "encode")
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    assert sorted(metrics) == ["ce"]


def test_decode_matches_jax_and_the_prefill(ref):
    """``decode_step`` token by token: logits against JAX's decode
    and the state after half the prompt and after all of it against
    JAX's, leaf by leaf (``MODEL_TOL``), and the logits against the
    port's own forward (5e-3).  Through ``make_serve_step`` at
    decode_32k (no window either way)."""
    tcfg = ref["tcfg"]
    model = _model(ref)
    tokens = torch.from_numpy(ref["batch"]["tokens"])
    state = TBB.prepare_decode_state(model, tcfg, {}, B, S)
    assert sorted(state) == ["g0", "g1"]
    assert tuple(state["g0"]["C"].shape) == (2, 3, B, 4, 128, 128)
    assert tuple(state["g1"]["m"].shape) == (2, 1, B, 4, 64)
    serve_step = steps.make_serve_step(tcfg, INPUT_SHAPES["decode_32k"])
    outs = []
    for t in range(S):
        lg, state = serve_step(model, state, tokens[:, t:t + 1], t)
        outs.append(lg)
        if t in ref["dec_states"]:
            want = ref["dec_states"][t]
            got = {k: v.numpy() for k, v in flatten(state).items()}
            assert sorted(got) == sorted(want)
            for k in want:
                _near(got[k], want[k], k)
    outs = torch.stack(outs, 1).numpy()
    _near(outs, ref["dec_logits"], "vs JAX")
    with torch.inference_mode():
        h, _ = TBB.forward_hidden(model, tcfg, {"tokens": tokens})
        fwd = TBB.logits_from_hidden(model, tcfg, h).numpy()
    np.testing.assert_allclose(outs, fwd, atol=PREFILL_DECODE_TOL, rtol=0)


def test_long_500k_serve_step_decodes_without_a_window(ref):
    """As JAX's: the ssm family takes no window override at long_500k,
    and the serve step there decodes as at decode_32k, bit for bit."""
    tcfg, jcfg = ref["tcfg"], ref["jcfg"]
    shape = INPUT_SHAPES["long_500k"]
    assert steps.decode_window(tcfg, shape) is None
    assert JST.decode_window(jcfg, shape) is None
    model = _model(ref)
    tokens = torch.from_numpy(ref["batch"]["tokens"][:, :6])
    outs = {}
    for name in ("long_500k", "decode_32k"):
        step = steps.make_serve_step(tcfg, INPUT_SHAPES[name])
        state = TBB.init_decode_state(tcfg, B, 8, device="cpu")
        outs[name] = torch.stack([step(model, state, tokens[:, t:t + 1],
                                       t)[0] for t in range(6)], 1)
    assert torch.equal(outs["long_500k"], outs["decode_32k"])
    _near(outs["long_500k"], ref["dec_logits"][:, :6])


def _named_grads(model, grads):
    return {k: v.numpy() for k, v in flatten(
        bridge.named_to_tree(model, grads)).items()}


def test_lm_loss_gradients_match_jax(ref):
    """Every leaf's gradient against JAX's, and both against the port's
    in f64 (the model in f64 under an f64 compute policy: the f32
    rounding each package's gradient carries), within ``GRAD_TOL``
    relative L2; the leaves the loss does not reach zero on both
    sides."""
    tcfg = ref["tcfg"]
    grads = {}
    for name, prec in (("f32", PR.F32), ("f64", F64)):
        model = _model(ref)
        if name == "f64":
            model = model.double()
        with torch.enable_grad():
            loss, _ = TBB.lm_loss(model, tcfg, _tb(ref["batch"]),
                                  precision=prec)
            grads[name] = _named_grads(model, TTS.param_grads(loss, model))
        if name == "f32":
            np.testing.assert_allclose(loss.item(), ref["loss"],
                                       rtol=LOSS_RTOL)
    got, exact = grads["f32"], grads["f64"]
    assert sorted(got) == sorted(ref["grads"]) == sorted(exact)
    for k, w in ref["grads"].items():
        if k.split("/")[0] in UNREACHED["lm"]:
            assert not np.any(w) and not np.any(got[k]), k
            continue
        assert np.any(w), k
        rel = (_rel_l2(got[k], w), _rel_l2(got[k], exact[k]),
               _rel_l2(w, exact[k]))
        assert max(rel) <= GRAD_TOL, (k, rel)


def test_recompute_is_bitwise_and_counted(ref, monkeypatch):
    """Under grad each mLSTM block is one checkpoint and runs twice, each
    sLSTM block once (its scan keeps the states its backward reads);
    with the recompute bypassed the same gradients to the bit, each
    block once; without grad (prefill) once, no checkpoint."""
    tcfg = ref["tcfg"]
    model = _model(ref)
    n = {"m": 0, "s": 0, "ckpt": 0}
    orig = {"m": TX.apply_mlstm_block, "s": TX.apply_slstm_block,
            "ckpt": TBB.checkpoint}

    def counted(key):
        def run(*a, **k):
            n[key] += 1
            return orig[key](*a, **k)
        return run
    monkeypatch.setattr(TX, "apply_mlstm_block", counted("m"))
    monkeypatch.setattr(TX, "apply_slstm_block", counted("s"))
    monkeypatch.setattr(TBB, "checkpoint", counted("ckpt"))
    tb = _tb(ref["batch"])

    def loss_grads():
        n.update(m=0, s=0, ckpt=0)
        with torch.enable_grad():
            loss, _ = TBB.lm_loss(model, tcfg, tb)
            return loss.item(), TTS.param_grads(loss, model)
    loss, grads = loss_grads()
    assert n == {"m": 12, "s": 2, "ckpt": 6}
    with monkeypatch.context() as m:
        m.setattr(TBB, "checkpoint", lambda fn, *a, **k: fn(*a))
        loss0, grads0 = loss_grads()
    assert (n["m"], n["s"]) == (6, 2)
    assert loss == loss0 and sorted(grads) == sorted(grads0)
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k
    n.update(m=0, s=0, ckpt=0)
    steps.make_prefill_step(tcfg)(model, tb)
    assert n == {"m": 6, "s": 2, "ckpt": 0}


def _check_step(before, after, want_before, want, lr, zero_grad):
    """AdamW's moments and the update / lr per group of leaves against
    JAX's; ``zero_grad``: the groups the loss does not reach (zero
    moments, moved by the decoupled decay alone)."""
    assert sorted(after) == sorted(want)
    for mom in ("m", "v"):
        g_got = _groups(after, f"opt/{mom}/")
        g_want = _groups(want, f"opt/{mom}/")
        for g in g_want:
            if g in zero_grad:
                assert not np.any(g_want[g]) and not np.any(g_got[g]), g
                continue
            assert _rel_l2(g_got[g], g_want[g]) <= MOMENT_TOL, (
                mom, g, _rel_l2(g_got[g], g_want[g]))
    if lr == 0:
        return
    p0, p1 = _groups(before, "params/"), _groups(after, "params/")
    q0, q1 = _groups(want_before, "params/"), _groups(want, "params/")
    for g in q1:
        if g in zero_grad:
            for a in (p1[g], q1[g]):
                np.testing.assert_allclose(a, q0[g] * (1 - lr * 0.1),
                                           rtol=1e-6, err_msg=g)
            continue
        u_got, u_want = (p0[g] - p1[g]) / lr, (q0[g] - q1[g]) / lr
        assert np.any(u_want), g
        assert _rel_l2(u_got, u_want) <= UPDATE_TOL, (
            g, _rel_l2(u_got, u_want))


def test_lm_steps_match_jax(ref):
    """Two steps from the init, the first at the warm-up's lr 0 (from
    zero moments AdamW's step is g / (|g| + eps), which moves an entry
    whose gradient sits at f32 rounding by what rounding decides)."""
    tcfg = ref["tcfg"]
    step, opt = steps.make_lm_train_step(tcfg, lr=LR, wd=0.1,
                                         total_steps=TOTAL, device="cpu")
    model = _model(ref)
    state = {"params": model,
             "opt": opt.init({k: p.detach()
                              for k, p in model.named_parameters()}),
             "step": torch.zeros((), dtype=torch.int32)}
    before = port_flat(state)
    _bitwise(before, ref["lm_states"][0])
    for i, b in enumerate(ref["lm_batches"]):
        state, m = step(state, b)
        assert sorted(m) == ["ce", "loss"]
        np.testing.assert_allclose(m["loss"].item(), ref["lm_losses"][i],
                                   rtol=LOSS_RTOL)
        after = port_flat(state)
        _check_step(before, after, ref["lm_states"][i],
                    ref["lm_states"][i + 1], LR * i / 500, UNREACHED["lm"])
        before = after


def test_contrastive_steps_match_jax(ref):
    """Two v3 steps (the fused loss here, JAX's dense), as
    ``test_lm_steps_match_jax``."""
    tcfg = ref["tcfg"]
    ttc = TTS.TrainStepConfig(arch=tcfg, fc=_fc(TFC, "fused"),
                              optimizer=adamw(),
                              lr_fn=lr_warmup_cosine(LR, 500, TOTAL), wd=0.1)
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), ttc, "cpu")
    state = bridge.state_from_tree(ts, unflatten(ref["ctr_states"][0]))
    step = TTS.make_train_step(ttc, "cpu")
    before = port_flat(state)
    _bitwise(before, ref["ctr_states"][0])
    for i, (idx, b) in enumerate(ref["ctr_data"]):
        state, m = step(state, b, idx)
        jm = ref["ctr_metrics"][i]
        for k in ("loss", "loss_value", "tau", "u_mean"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        after = port_flat(state)
        want = ref["ctr_states"][i + 1]
        for u in ("fc/u1", "fc/u2"):
            fin = np.isfinite(want[u])
            assert np.array_equal(fin, np.isfinite(after[u])), u
            np.testing.assert_allclose(after[u][fin], want[u][fin],
                                       rtol=U_TOL, atol=U_TOL, err_msg=u)
        _check_step(before, after, ref["ctr_states"][i], want, LR * i / 500,
                    UNREACHED["contrastive"])
        before = after


def test_lm_train_state_crosses_packages_bitwise(ref, tmp_path):
    """JAX's LM train state (two steps, AdamW's moments in) goes into
    the port's state through the bridge (``state_from_tree``) and back
    (``state_to_tree``) bitwise, and through the port's ``save`` and
    JAX's ``restore`` bitwise."""
    tcfg = ref["tcfg"]
    td = str(tmp_path / "port")
    _, opt = steps.make_lm_train_step(tcfg, device="cpu")
    model = TBB.init_params(tcfg, torch.Generator().manual_seed(7), "cpu")
    state = {"params": model,
             "opt": opt.init({k: p.detach()
                              for k, p in model.named_parameters()}),
             "step": torch.zeros((), dtype=torch.int32)}
    state = bridge.state_from_tree(state, unflatten(ref["lm_states"][2]))
    _bitwise(port_flat(state), ref["lm_states"][2])
    TCK.save(td, bridge.state_to_tree(state), 3, {"arch": ARCH})
    like = jax.tree.map(np.zeros_like, ref["jstate"])
    back, step, _ = JCK.restore(td, like)
    assert step == 3
    _bitwise(jax_flat(back), ref["lm_states"][2])


# ---------------------------------------------------------------------------
# Configs, the full-size tree, the launchers, the mesh
# ---------------------------------------------------------------------------

def test_config_equals_jax_field_by_field():
    j, t = j_get_arch(ARCH), t_get_arch(ARCH)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        assert {f.name for f in dataclasses.fields(jc)} == {
            f.name for f in dataclasses.fields(tc)}
        for f in dataclasses.fields(tc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if dataclasses.is_dataclass(b):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (f.name, a, b)
    r = t.reduced()
    assert (r.n_layers, r.xlstm_pattern[:r.n_layers], r.ssm.chunk) == (
        2, "mm", 64)
    assert TBB.xlstm_groups(r) == ([("m", 1)], 2)
    assert TBB.xlstm_groups(t) == ([("m", 3), ("s", 1)], 3)


def test_full_size_tree_equals_jax_param_shapes():
    """The meta model at full width and depth: JAX's leaf paths and
    shapes (``units/g1/R`` (3, 1, 4, 4, 192, 192)) and its parameter
    count; the bridge splits the tree into the model's parameters and
    stacks them back to the same paths and shapes."""
    cfg = t_get_arch(ARCH)
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(
                   JBB.param_shapes(j_get_arch(ARCH)))[0]}
    tree = TBB.param_shapes(cfg)
    tshapes = {k: tuple(v.shape) for k, v in flatten(tree).items()}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in jshapes.values()) == FULL_PARAMS
    assert jshapes["units/g1/R"] == (3, 1, 4, 4, 192, 192)
    assert jshapes["units/g0/wq"] == (3, 3, 1536, 1536)
    meta = TBB.meta_model(cfg)
    named = bridge.tree_to_named(meta, tree)
    assert sorted(named) == sorted(n for n, _ in meta.named_parameters())
    again = {k: tuple(v.shape) for k, v in flatten(
        bridge.named_to_tree(meta, named)).items()}
    assert again == jshapes


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


@pytest.mark.parametrize("objective", ["lm", "contrastive"])
def test_train_launcher_runs_both_objectives(objective):
    state, out = _run_cli(train.main, [
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--log-every", "1", "--objective", objective, "--seq-len", "16",
        "--global-batch", "2", "--n-samples", "8"])
    lines = [json.loads(ln[ln.index("{"):]) for ln in out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2 and all(np.isfinite(ln["loss"]) for ln in lines)
    assert ("ce" in lines[0]) == (objective == "lm")
    assert ("retrieval accuracy: " in out) == (objective == "contrastive")
    assert isinstance(state["params"], TBB.XLSTMLM)


def test_serve_launcher_prints_its_two_lines(capsys):
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={ARCH} batch=2 generated 4 tokens")
    assert out[1].startswith("sample token ids:")
    assert toks.shape == (2, 9) and int(toks.max()) < 512


@pytest.fixture(scope="module")
def xlstm_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("xlstm_mesh")
    ranks = H.spawn("xlstm", out, nproc=2, timeout=240)
    assert [r.returncode for r in ranks] == [0] * 2, ranks[0].stderr[-3000:]
    with open(out / "xlstm.json") as f:
        return json.load(f)[ARCH]


def test_mesh_contrastive_step_equals_single_device(xlstm_mesh):
    """``data:1,fsdp:2`` (2 gloo ranks): two v3 ZeRO steps of the reduced
    xLSTM at 8 layers against one device's; the 6-dim ``units/g1/R``
    leaf sharded on its contraction dim, as JAX's rule gives."""
    c = xlstm_mesh
    assert c["same_keys"] and c["params_unmoved"] == []
    assert c["dloss"] < 1e-5 and c["dlogu"] < 1e-4
    assert max(c["moment_rel_l2"].values()) <= MOMENT_TOL
    assert max(c["update_rel_l2"].values()) <= UPDATE_TOL
    assert c["zero_moment_leaves"] == ["lm_head"]
    assert c["dims"]["units/g1/R"] == 4
    assert c["gather_backward_calls"] == 2 * (len(c["sharded_leaves"]) - 1)
