"""The LM objective of the port's hybrid backbone (``zamba2-1.2b`` at
``reduced().replace(n_layers=3)``: one super-block of two Mamba2 layers
and the shared block, and one tail layer) against the JAX package on the
CPU, one set of params (the JAX init, through the bridge) in both:

  * ``LMDataset`` batches bitwise;
  * ``layers.cross_entropy`` and ``layers.vocab_parallel_ce`` (tied,
    untied, ``vocab_valid`` below the padded vocab): values rtol 1e-5,
    gradients against ``jax.grad`` rtol 1e-4 / atol 1e-5 (the bounds of
    ``gcl_pair_grads`` in tests/test_kernels.py);
  * ``backbones.lm_loss``: the loss rtol 1e-5, every leaf's gradient
    within 1e-4 relative L2 (tests/test_torch_train.py's step-1 bound);
  * the recompute of ``forward_hidden`` under grad: gradients bitwise
    equal to those without it, the SSD and attention calls it adds;
  * three steps of ``launch.steps.make_lm_train_step`` against JAX's
    (one module-scoped JAX run): losses rtol 1e-5; per group of leaves
    (the top-level module), AdamW's moments and the update divided by lr
    by relative L2 (``MOMENT_TOL``, ``UPDATE_TOL`` below, with their
    reasons); lr 0.5 peak puts steps 1 and 2 at lr 1e-3 and 2e-3 (the
    500-step warm-up), so the params move;
  * the LM train state through both packages' ``save``/``restore``,
    bitwise in both directions, and the stored (uncompressed) npz read
    by JAX's ``restore``;
  * a ``kill@3`` launcher subprocess, then ``--resume``, bitwise equal to
    the uninterrupted run;
  * the plain chunked scan's gradient where a chunk's decay passes f32's
    exp range (the full-width chunk of 256 reaches it): finite, and
    within 1e-4 relative L2 of autograd through the sequential oracle
    (the K4 gradient bound of tests/test_torch_ssd_grad.py), where the
    JAX package's ``ssd_chunked`` gives NaN.
"""
import contextlib
import io
import os
import signal
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.data import LMDataset as JLD
from repro.launch import steps as JST
from repro.models import backbones as JBB
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro_torch import checkpoint as TCK
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.data import LMDataset as TLD
from repro_torch.kernels import ssd_chunk as K4
from repro_torch.launch import steps as TST
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as TA
from repro_torch.models import backbones as TBB
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TSSM
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-1.2b"
B, S = 2, 32
LR, TOTAL = 0.5, 10
# AdamW moments per group of leaves: the gradients' bound
# (tests/test_torch_train.py, step-1 gradients 1e-4 relative L2)
MOMENT_TOL = 1e-4
# the update divided by lr per group: AdamW's m / (sqrt(v) + eps) moves an
# entry by +-1 where f32 rounding decides its gradient's sign (ROADMAP,
# "bounds after AdamW steps"), so 10x the moments' bound
UPDATE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (and in its
    subprocess): the CPU matmuls' bits depend on the thread count, and
    the suite's workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs():
    return (j_get_arch(ARCH).reduced().replace(n_layers=3),
            t_get_arch(ARCH).reduced().replace(n_layers=3))


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


def _port_state(tcfg, jflat_params):
    model = TBB.params_from_tree(tcfg, jflat_params, "cpu")
    opt = adamw()
    return {"params": model,
            "opt": opt.init({k: p.detach()
                             for k, p in model.named_parameters()}),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the init, three batches, the loss and its
    gradients at the init, and three jitted LM steps."""
    jcfg, tcfg = _cfgs()
    params = JBB.init_params(jax.random.PRNGKey(0), jcfg)
    ds = TLD(n=16, seq_len=S, vocab_size=tcfg.vocab_size)
    batches = [ds.batch(np.arange(B * i, B * (i + 1))) for i in range(3)]
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JBB.lm_loss(p, jcfg, jb0), has_aux=True))(params)
    step_fn, opt = JST.make_lm_train_step(jcfg, lr=LR, wd=0.1,
                                          total_steps=TOTAL)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(step_fn)
    states, losses = [jax_flat(state)], []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(jax_flat(state))
        losses.append((float(m["loss"]), float(m["ce"])))
    return dict(jcfg=jcfg, tcfg=tcfg, params=jax_flat(params),
                batches=batches, loss=float(loss), ce=float(metrics["ce"]),
                grads=jax_flat(grads), states=states, losses=losses,
                jstate=jax.device_get(state))


# ---------------------------------------------------------------------------
# Data and the loss functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,idx", [
    (dict(n=64, seq_len=32, vocab_size=512), [0, 5, 63, 17]),
    (dict(n=40, seq_len=7, vocab_size=100, seed=3), [39, 0, 2]),
])
def test_lm_dataset_batches_equal_jax(kw, idx):
    got, want = TLD(**kw).batch(idx), JLD(**kw).batch(idx)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                 want[k])
    # index-addressable: a row does not depend on the others in its batch
    one = TLD(**kw).batch([idx[1]])
    assert np.array_equal(one["tokens"][0], got["tokens"][1])


def _grad_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("vocab_valid", [None, 40, 35])
def test_cross_entropy_matches_jax(vocab_valid):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 35, (2, 5)).astype(np.int32)
    f = lambda lg: JL.cross_entropy(lg, jnp.asarray(labels), vocab_valid)
    jv, jg = jax.value_and_grad(f)(jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    tv = TL.cross_entropy(tl, torch.from_numpy(labels), vocab_valid)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    _grad_close(tl.grad.numpy(), np.asarray(jg), "d logits")


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("vocab_valid", [48, 45])
def test_vocab_parallel_ce_matches_jax(tied, vocab_valid):
    """Tied (the (V, d) table) and untied (a (d, V) head), with and
    without padded vocab entries masked."""
    rng = np.random.default_rng(1)
    V, d = 48, 16
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    table = (rng.standard_normal((V, d) if tied else (d, V)) * 0.5).astype(
        np.float32)
    labels = rng.integers(0, min(V, vocab_valid), (2, 6)).astype(np.int32)
    f = lambda xx, tt: JL.vocab_parallel_ce(
        xx, tt, jnp.asarray(labels), tied=tied, vocab_valid=vocab_valid)
    jv, (jgx, jgt) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    tv = TL.vocab_parallel_ce(tx, tt, torch.from_numpy(labels), tied=tied,
                              vocab_valid=vocab_valid)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    _grad_close(tx.grad.numpy(), np.asarray(jgx), "d x")
    _grad_close(tt.grad.numpy(), np.asarray(jgt), "d table")
    # the same function as the plain CE of the full logits
    full = TL.cross_entropy(TL.unembed(tt, tx, transpose=tied),
                            torch.from_numpy(labels), vocab_valid)
    np.testing.assert_allclose(tv.item(), full.item(), rtol=1e-5)


# ---------------------------------------------------------------------------
# The LM loss through the model, and the recompute
# ---------------------------------------------------------------------------

def _loss_and_grads(tcfg, model, batch):
    model.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.enable_grad():
        loss, metrics = TBB.lm_loss(model, tcfg, tb)
        loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return loss.item(), metrics, flatten(bridge.named_to_tree(model, grads))


def test_lm_loss_and_gradients_match_jax(ref):
    tcfg = ref["tcfg"]
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
    loss, metrics, grads = _loss_and_grads(tcfg, model, ref["batches"][0])
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), ref["ce"], rtol=1e-5)
    assert sorted(grads) == sorted(ref["grads"])
    for k, w in ref["grads"].items():
        g = grads[k].numpy()
        if not np.any(w):           # ctr_proj / pair_proj: no gradient
            assert not np.any(g), k
            continue
        assert _rel_l2(g, w) <= 1e-4, (k, _rel_l2(g, w))


def test_recompute_is_bitwise_and_counted(ref, monkeypatch):
    """Under grad, each Mamba2 layer and each shared-block call is
    recomputed once, so each runs twice.  The gradients equal those
    without the recompute bit for bit; without grad (prefill) nothing is
    recomputed."""
    tcfg = ref["tcfg"]
    calls = {"ssd": 0, "attn": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(TSSM, "ssd_chunk", count("ssd", TSSM.ssd_chunk))
    monkeypatch.setattr(TA, "flash_mha", count("attn", TA.flash_mha))
    every = tcfg.hybrid_attn_every
    n_super = tcfg.n_layers // every
    tail = tcfg.n_layers - n_super * every
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
    got = {}
    for remat in (False, True):
        calls.update(ssd=0, attn=0)
        with monkeypatch.context() as m:
            if not remat:            # the recompute's wrapper, bypassed
                m.setattr(TBB, "checkpoint", lambda fn, *a, **k: fn(*a))
            got[remat] = _loss_and_grads(tcfg, model, ref["batches"][0])
        want = ((n_super * every + tail, n_super) if not remat else
                (2 * (n_super * every + tail), 2 * n_super))
        assert (calls["ssd"], calls["attn"]) == want, remat
    assert got[True][0] == got[False][0]
    _bitwise({k: v.numpy() for k, v in got[True][2].items()},
             {k: v.numpy() for k, v in got[False][2].items()})
    calls.update(ssd=0, attn=0)
    TST.make_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(
        ref["batches"][0]["tokens"])})
    assert (calls["ssd"], calls["attn"]) == (tcfg.n_layers, n_super)


# ---------------------------------------------------------------------------
# Three LM steps against JAX
# ---------------------------------------------------------------------------

def _groups(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            out.setdefault(k[len(prefix):].split("/")[0], []).append(
                np.asarray(v, np.float64).ravel())
    return {g: np.concatenate(v) for g, v in out.items()}


def test_three_lm_steps_match_jax(ref):
    tcfg = ref["tcfg"]
    step, opt = TST.make_lm_train_step(tcfg, lr=LR, wd=0.1,
                                       total_steps=TOTAL, device="cpu")
    assert opt.name == "adamw"
    state = _port_state(tcfg, ref["params"])
    before = port_flat(state)
    _bitwise({k: v for k, v in before.items() if k.startswith("params/")},
             {k: v for k, v in ref["states"][0].items()
              if k.startswith("params/")})
    lrs = [0.0, LR / 500, 2 * LR / 500]
    for i, b in enumerate(ref["batches"]):
        state, m = step(state, b)
        assert sorted(m) == ["ce", "loss"]
        np.testing.assert_allclose(m["loss"].item(), ref["losses"][i][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["ce"].item(), ref["losses"][i][1],
                                   rtol=1e-5)
        after, want = port_flat(state), ref["states"][i + 1]
        assert sorted(after) == sorted(want)
        assert int(after["step"]) == int(want["step"]) == i + 1
        assert int(after["opt/t"]) == int(want["opt/t"]) == i + 1
        for mom in ("m", "v"):
            g_got = _groups(after, f"opt/{mom}/")
            g_want = _groups(want, f"opt/{mom}/")
            for g in g_want:
                if not np.any(g_want[g]):
                    assert not np.any(g_got[g]), (mom, g)
                    continue
                assert _rel_l2(g_got[g], g_want[g]) <= MOMENT_TOL, (
                    i, mom, g, _rel_l2(g_got[g], g_want[g]))
        if lrs[i] > 0:
            p0, p1 = _groups(before, "params/"), _groups(after, "params/")
            q0 = _groups(ref["states"][i], "params/")
            q1 = _groups(want, "params/")
            for g in q1:
                u_got, u_want = (p0[g] - p1[g]) / lrs[i], (
                    q0[g] - q1[g]) / lrs[i]
                assert np.any(u_want), g       # the step moved the params
                assert _rel_l2(u_got, u_want) <= UPDATE_TOL, (
                    i, g, _rel_l2(u_got, u_want))
        before = after


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_lm_checkpoint_crosses_packages_bitwise(ref, tmp_path):
    """JAX's LM train state (after three steps) restores into the port
    bitwise, and the port's into JAX."""
    tcfg = ref["tcfg"]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    JCK.save(jd, ref["jstate"], 3, {"arch": ARCH, "version": "v3"})
    state = _port_state(tcfg, ref["params"])
    got, step, meta = TCK.restore(jd, bridge.state_to_tree(state))
    assert step == 3 and meta == {"arch": ARCH, "version": "v3"}
    state = bridge.state_from_tree(state, got)
    assert sorted(state) == ["opt", "params", "step"]
    _bitwise(port_flat(state), ref["states"][3])
    TCK.save(td, bridge.state_to_tree(state), 5, {"arch": ARCH})
    like = jax.tree.map(np.zeros_like, ref["jstate"])
    back, step, _ = JCK.restore(td, like)
    assert step == 5
    _bitwise(jax_flat(back), ref["states"][3])


def test_port_writes_a_stored_npz_that_jax_restores_bitwise(ref, tmp_path):
    """The port's arrays file is a stored (uncompressed) zip; JAX's
    ``repro.checkpoint.restore`` reads it bitwise."""
    d = str(tmp_path / "ck")
    TCK.save(d, {"params": ref["params"], "step": np.int32(2)}, 2)
    with zipfile.ZipFile(os.path.join(d, "ckpt_00000002.npz")) as z:
        assert z.infolist() and all(i.compress_type == zipfile.ZIP_STORED
                                    for i in z.infolist())
    like = {"params": jax.tree.map(np.zeros_like, JBB.init_params(
        jax.random.PRNGKey(0), ref["jcfg"])), "step": np.int32(0)}
    got, step, _ = JCK.restore(d, like)
    assert step == 2
    _bitwise({k[len("params/"):]: v for k, v in jax_flat(got).items()
              if k.startswith("params/")}, ref["params"])


def _lm_args(steps, *extra):
    return ["--arch", ARCH, "--reduced", "--objective", "lm",
            "--global-batch", "2", "--seq-len", "16", "--n-samples", "16",
            "--steps", str(steps), "--log-every", "1", "--lr", "0.5",
            "--device", "cpu"] + list(extra)


def test_lm_kill_and_resume_is_bitwise(tmp_path):
    """``kill@3`` SIGKILLs a launcher subprocess before step 3 (step 2 is
    saved); ``--resume`` here finishes the run bitwise equal to the
    uninterrupted one, and the step lines carry ``ce``."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_lm_args(4, "--ckpt-dir", ck, "--ckpt-every", "2", "--chaos",
                   "kill@3")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        oracle = port_flat(ttrain.main(_lm_args(4)))
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == -signal.SIGKILL, err[-3000:]
    assert '"ce": ' in out and "step     2" in out
    assert TCK.latest_step(ck) == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        resumed = port_flat(ttrain.main(_lm_args(
            4, "--ckpt-dir", ck, "--ckpt-every", "2", "--resume")))
    assert "resumed from step 2" in buf.getvalue()
    assert "retrieval accuracy" not in buf.getvalue()
    _bitwise(resumed, oracle)


def test_plain_scan_gradient_is_finite_past_the_exp_range():
    """Within one 64-step chunk the decay reaches 2 * 63 = 126 > 88, so
    exp of a masked exponent overflows: JAX's ``ssd_chunked`` (mask after
    the exp) has a NaN gradient for log_a; the port's plain scan (mask
    before the exp) matches autograd through ``ssd_sequential``."""
    rng = np.random.default_rng(3)
    B_, T, H, P, N = 1, 64, 2, 4, 3
    x = rng.standard_normal((B_, T, H, P)).astype(np.float32)
    log_a = np.full((B_, T, H), -2.0, np.float32)
    Bm, Cm = (rng.standard_normal((B_, T, N)).astype(np.float32)
              for _ in range(2))
    gy = rng.standard_normal((B_, T, H, P)).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(JSSM.ssd_chunked(*a, chunk=64)[0] * gy),
                  argnums=1)(*map(jnp.asarray, (x, log_a, Bm, Cm)))
    assert not np.isfinite(np.asarray(jg)).all()
    got, want = [], []
    for fn, out in ((lambda *a: K4.ssd_scan_plain(*a, chunk=64), got),
                    (TSSM.ssd_sequential, want)):
        ins = [torch.tensor(a, requires_grad=True)
               for a in (x, log_a, Bm, Cm)]
        out.extend(torch.autograd.grad(fn(*ins)[0], ins,
                                       torch.from_numpy(gy)))
    for name, g, w in zip(("x", "log_a", "B", "C"), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g.numpy(), w.numpy()) <= 1e-4, name
