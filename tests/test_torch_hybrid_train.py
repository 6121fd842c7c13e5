"""The contrastive objective of the port's hybrid backbone and the
training launcher's edges for it, against the JAX package on the CPU.
The model is ``zamba2-1.2b`` at ``reduced().replace(n_layers=3)`` (one
super-block, one tail layer) with the JAX init carried across by the
bridge:

  * ``PairedEmbeddingDataset`` batches and the loader's index plan
    bitwise;
  * ``backbones.encode_pair`` (the mean-pooled backbone through
    ``ctr_proj`` against ``pair_embeds`` through ``pair_proj``): both
    embeddings rtol 1e-5 with atol 1e-5 of the largest entry (f32 through
    three layers moves entries near zero by ~2e-6, as
    tests/test_torch_train.py allows for gradients), every leaf's
    gradient of a fixed projection of them within 1e-4 relative L2
    (tests/test_torch_train.py's bound);
  * three FastCLIP v3 steps of ``core.train_step.make_train_step`` (the
    launcher's builder) against JAX's ``launch.steps.
    make_contrastive_train_step`` with the same AdamW and warm-up (one
    module-scoped JAX run; the port on the fused loss,
    K1 and K2's plain versions here): loss, loss value and tau rtol
    1e-5, the log-u rows rtol 1e-5 / atol 1e-5 (log domain: absolute 1e-5
    is relative 1e-5 in u, tests/test_torch_train.py; a row's log-u near
    0 is a difference of O(1) terms); AdamW's moments and the update
    divided by lr per group of leaves by relative L2 (the bounds of
    tests/test_torch_lm.py); lr 0.5 peak puts steps 1 and 2 at lr 1e-3
    and 2e-3; the retrieval accuracy after them equal;
  * the launcher: ROADMAP F4's command trains and prints ``retrieval
    accuracy:``; ``--objective lm`` on a CLIP arch trains contrastively;
    ``--eval-every`` is ignored for the hybrid; ``--mesh`` with the LM
    objective is refused as the JAX launcher refuses it, and the
    contrastive one trains; without ``--device`` both objectives need the
    card.
"""
import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.core import fastclip as JFC
from repro.core import train_step as JTS
from repro.data import PairedEmbeddingDataset as JPD
from repro.data import ShardedLoader as JSL
from repro.launch import steps as JST
from repro.models import backbones as JBB
from repro_torch.checkpoint import bridge, flatten, unflatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import fastclip as TFC
from repro_torch.core import train_step as TTS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import PairedEmbeddingDataset as TPD
from repro_torch.data import ShardedLoader as TSL
from repro_torch.launch import train as ttrain
from repro_torch.models import backbones as TBB
from repro_torch.optim import adamw

ARCH = "zamba2-1.2b"
N, GB, S = 16, 4, 32
LR, TOTAL = 0.5, 10
# the bounds of tests/test_torch_lm.py (their reasons there)
MOMENT_TOL, UPDATE_TOL = 1e-4, 1e-3
FCCO_KEYS = ["gamma", "grad_norm", "loss", "loss_value", "lr", "sat_rate",
             "tau", "u_mean"]
LINE = re.compile(r"^step +(\d+) epoch \d+ (\{.*\})$")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(state):
    """Owned numpy copies (the model's parameters change in place)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in flatten(
        bridge.state_to_tree(state)).items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _groups(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            out.setdefault(k[len(prefix):].split("/")[0], []).append(
                np.asarray(v, np.float64).ravel())
    return {g: np.concatenate(v) for g, v in out.items()}


def _fc(mod, loss_impl="dense"):
    return mod.FastCLIPConfig(version="v3", n_samples=N,
                              steps_per_epoch=N // GB, gamma_decay_epochs=1,
                              loss_impl=loss_impl)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the init, three loader steps, ``encode_pair``
    and its gradients at the init, three jitted v3 steps and the
    retrieval accuracy after them."""
    jcfg = j_get_arch(ARCH).reduced().replace(n_layers=3)
    tcfg = t_get_arch(ARCH).reduced().replace(n_layers=3)
    kw = dict(n=N, seq_len=S, vocab_size=tcfg.vocab_size)
    data = []
    for a, b in zip(JSL(JPD(**kw), global_batch=GB, seed=3).steps(3),
                    TSL(TPD(**kw), global_batch=GB, seed=3).steps(3)):
        assert np.array_equal(a[2], b[2])
        assert sorted(a[3]) == sorted(b[3]) == ["labels", "pair_embeds",
                                                "tokens"]
        for k in a[3]:
            assert a[3][k].dtype == b[3][k].dtype
            assert a[3][k].tobytes() == b[3][k].tobytes(), k
        data.append((b[2], b[3]))
    step_fn, jtc = JST.make_contrastive_train_step(
        jcfg, _fc(JFC), lr=LR, wd=0.1, total_steps=TOTAL)
    state = JTS.init_train_state(jax.random.PRNGKey(0), jtc)
    rng = np.random.default_rng(5)
    cts = [rng.standard_normal((GB, TBB.CONTRASTIVE_DIM)).astype(np.float32)
           for _ in range(2)]
    jb0 = {k: jnp.asarray(v) for k, v in data[0][1].items()}

    def proj(params):
        e1, e2 = JBB.encode_pair(params, jcfg, jb0)
        return jnp.sum(e1 * cts[0]) + jnp.sum(e2 * cts[1]), (e1, e2)
    (_, embeds), grads = jax.jit(jax.value_and_grad(proj, has_aux=True))(
        state["params"])
    jstep = jax.jit(step_fn)
    states, metrics = [jax_flat(state)], []
    for idx, b in data:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                         jnp.asarray(idx))
        states.append(jax_flat(state))
        metrics.append({k: float(v) for k, v in m.items()})
    acc = float(JTS.retrieval_accuracy(
        state["params"], jcfg, {k: jnp.asarray(v) for k, v in
                                JPD(**kw).batch(np.arange(N)).items()}))
    return dict(tcfg=tcfg, kw=kw, data=data, cts=cts, states=states,
                metrics=metrics, embeds=[np.asarray(e) for e in embeds],
                grads=jax_flat(grads), acc=acc)


def _port_state(ref, ttc):
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), ttc, "cpu")
    tree = flatten(bridge.state_to_tree(ts))
    assert sorted(tree) == sorted(ref["states"][0])
    return bridge.state_from_tree(ts, unflatten(ref["states"][0]))


@pytest.mark.parametrize("kw,idx", [
    (dict(n=64, seq_len=32, vocab_size=512), [0, 5, 63, 17]),
    (dict(n=40, seq_len=70, vocab_size=100, pair_dim=24, n_classes=5,
          seed=3), [39, 0, 2]),
])
def test_paired_dataset_batches_equal_jax(kw, idx):
    got, want = TPD(**kw).batch(idx), JPD(**kw).batch(idx)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    one = TPD(**kw).batch([idx[1]])
    assert one["pair_embeds"][0].tobytes() == got["pair_embeds"][1].tobytes()


def test_encode_pair_and_gradients_match_jax(ref):
    tcfg = ref["tcfg"]
    model = TBB.params_from_tree(
        tcfg, {k[len("params/"):]: v for k, v in ref["states"][0].items()
               if k.startswith("params/")}, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in ref["data"][0][1].items()}
    with torch.enable_grad():
        e1, e2 = TBB.encode_pair(model, tcfg, tb)
        ((e1 * torch.from_numpy(ref["cts"][0])).sum()
         + (e2 * torch.from_numpy(ref["cts"][1])).sum()).backward()
    assert e1.dtype == e2.dtype == torch.float32
    assert e1.shape == e2.shape == (GB, TBB.CONTRASTIVE_DIM)
    for got, want in zip((e1, e2), ref["embeds"]):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    grads = flatten(bridge.named_to_tree(model, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()}))
    assert sorted(grads) == sorted(ref["grads"])
    for k, w in ref["grads"].items():
        g = grads[k].numpy()
        if not np.any(w):            # lm_head: the towers do not reach it
            assert not np.any(g), k
            continue
        assert _rel_l2(g, w) <= 1e-4, (k, _rel_l2(g, w))


def test_three_contrastive_steps_match_jax(ref):
    tcfg = ref["tcfg"]
    # JAX's make_contrastive_train_step: AdamW under
    # lr_warmup_cosine(lr, 500, total_steps)
    ttc = TTS.TrainStepConfig(arch=tcfg, fc=_fc(TFC, "fused"),
                              optimizer=adamw(),
                              lr_fn=lr_warmup_cosine(LR, 500, TOTAL), wd=0.1)
    step = TTS.make_train_step(ttc, "cpu")
    state = _port_state(ref, ttc)
    before = port_flat(state)
    lrs = [0.0, LR / 500, 2 * LR / 500]
    for i, (idx, b) in enumerate(ref["data"]):
        state, m = step(state, b, idx)
        jm = ref["metrics"][i]
        assert sorted(m) == sorted(jm) == FCCO_KEYS
        for k in ("loss", "loss_value", "tau", "u_mean"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["lr"]), lrs[i], rtol=1e-6)
        after, want = port_flat(state), ref["states"][i + 1]
        assert sorted(after) == sorted(want)
        for u in ("fc/u1", "fc/u2"):
            fin = np.isfinite(want[u])
            assert np.array_equal(fin, np.isfinite(after[u])), u
            assert fin[idx].all()
            np.testing.assert_allclose(after[u][fin], want[u][fin],
                                       rtol=1e-5, atol=1e-5, err_msg=u)
        np.testing.assert_allclose(after["fc/tau"], want["fc/tau"],
                                   rtol=1e-5)
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
                u_got = (p0[g] - p1[g]) / lrs[i]
                u_want = (q0[g] - q1[g]) / lrs[i]
                assert np.any(u_want), g       # the step moved the params
                assert _rel_l2(u_got, u_want) <= UPDATE_TOL, (
                    i, g, _rel_l2(u_got, u_want))
        before = after
    TTS.check_state_dtypes(state)
    acc = TTS.retrieval_accuracy(state["params"], tcfg, {
        k: torch.from_numpy(v) for k, v in
        TPD(**ref["kw"]).batch(np.arange(N)).items()})
    assert float(acc) == ref["acc"]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = ttrain.main(argv)
    lines = buf.getvalue().splitlines()
    steps = [(int(m.group(1)), m.group(2)) for m in map(LINE.match, lines)
             if m]
    return state, lines, steps


def test_f4_command_trains_the_hybrid_contrastively():
    """ROADMAP F4's command (the launcher crashed on it before): two
    contrastive steps on ``PairedEmbeddingDataset`` with the JAX
    launcher's keys, then ``retrieval accuracy:``; ``--eval-every`` does
    nothing for a non-CLIP arch, as in JAX."""
    state, lines, steps = _main(["--arch", ARCH, "--reduced", "--steps",
                                 "2", "--device", "cpu", "--log-every", "1",
                                 "--eval-every", "1"])
    assert [s for s, _ in steps] == [0, 1]
    assert sorted(json.loads(steps[0][1])) == FCCO_KEYS
    assert isinstance(state["params"], TBB.HybridLM)
    assert sorted(state) == ["fc", "opt", "params", "step"]
    assert any(ln.startswith("retrieval accuracy: ") for ln in lines)
    assert not any(ln.startswith("eval ") for ln in lines)


def test_lm_objective_trains_the_lm_and_ends_without_retrieval():
    state, lines, steps = _main(["--arch", ARCH, "--reduced", "--steps",
                                 "2", "--device", "cpu", "--log-every", "1",
                                 "--objective", "lm", "--seq-len", "16",
                                 "--global-batch", "2", "--guard"])
    assert [sorted(json.loads(m)) for _, m in steps] == [["ce", "loss"]] * 2
    assert sorted(state) == ["opt", "params", "step"]
    assert not any(ln.startswith("retrieval accuracy") for ln in lines)


def test_lm_objective_on_a_clip_arch_trains_contrastively():
    """As the JAX launcher (``--objective lm`` applies to LM backbones
    only)."""
    state, lines, steps = _main(["--arch", "clip-vitb32-cc12m", "--reduced",
                                 "--global-batch", "16", "--n-samples",
                                 "32", "--steps", "1", "--device", "cpu",
                                 "--objective", "lm"])
    assert sorted(json.loads(steps[0][1])) == FCCO_KEYS
    assert "fc" in state
    assert any(ln.startswith("retrieval accuracy: ") for ln in lines)


def test_mesh_on_the_hybrid_is_refused(capsys):
    """``--objective lm --mesh`` exits with the JAX launcher's message;
    the contrastive ``--mesh`` run, which JAX runs too, trains (a
    one-rank group here; tests/test_torch_dense_train.py holds the
    two-rank step to the single-device one)."""
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh",
            "data:1,fsdp:1"]
    with pytest.raises(SystemExit) as e:
        ttrain.main(base + ["--objective", "lm"])
    assert "--mesh drives the contrastive trainer" in str(e.value.code)
    state, lines, steps = _main(base + ["--steps", "1", "--log-every", "1",
                                        "--global-batch", "4",
                                        "--n-samples", "8"])
    assert lines[0].startswith("mesh data:1,fsdp:1 backend gloo world 1")
    assert [s for s, _ in steps] == [0]
    assert sorted(json.loads(steps[0][1])) == FCCO_KEYS
    assert sorted(state) == ["fc", "opt", "params", "step"]
    assert "lm_head" in state["params"] and "supers/mambas/w_in" in state[
        "params"]
    assert any(ln.startswith("retrieval accuracy: ") for ln in lines)


@pytest.mark.parametrize("objective", ["contrastive", "lm"])
def test_hybrid_training_needs_the_card(objective):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ttrain.main(["--arch", ARCH, "--reduced", "--steps", "1",
                     "--objective", objective])
