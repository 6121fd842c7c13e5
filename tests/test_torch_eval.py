"""The port's eval engine (``repro_torch.eval``, ``repro_torch.launch.eval``)
on the CPU against the JAX package (``repro.eval``), on numpy inputs from
a seed.

Exact (``==`` / bitwise): the streaming top-k against the dense oracle and
against JAX's scan (quantized embeddings: every f32 dot is exact), the
tie rule, padded columns, the planted known answers, templates and prompt
banks, ragged extraction on the planted towers, and planted checkpoints
crossing between the packages.  With a real tower in the loop: extraction
within 1e-5 (the serving tolerance, tests/test_eval.py), ``eval_loss``
within rtol 1e-5 (tests/test_kernels.py's K1 bound), rank metrics within
1/N.  The no-(N, N) contract is checked on the ops the scan dispatches,
with the dense oracle as the positive control."""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import checkpoint as JCK
from repro.configs import get_arch as j_get_arch
from repro.core import fastclip as JFC
from repro.core import train_step as JTS
from repro.core.schedules import lr_warmup_cosine as j_lr
from repro.data import ZeroShotEvalDataset as JZS
from repro.eval import classifier as JCL
from repro.eval import engine as JEN
from repro.eval import extraction as JEX
from repro.eval import metrics as JM
from repro.eval import planted as JPL
from repro.eval import retrieval as JRT
from repro.eval import templates as JTP
from repro.launch import eval as jeval
from repro.models import backbones as JBB
from repro.optim import adamw as j_adamw
from repro_torch import checkpoint as TCK
from repro_torch.checkpoint import bridge
from repro_torch.configs import get_arch
from repro_torch.core import fastclip as FC
from repro_torch.core import train_step as TS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import ZeroShotEvalDataset as TZS
from repro_torch.eval import classifier as CL
from repro_torch.eval import engine as EN
from repro_torch.eval import extraction as EX
from repro_torch.eval import metrics as M
from repro_torch.eval import planted as PL
from repro_torch.eval import retrieval as RT
from repro_torch.eval import templates as TP
from repro_torch.kernels import gcl_loss as GL
from repro_torch.launch import eval as teval
from repro_torch.models import backbones as BB
from repro_torch.optim import adamw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

ARCH = "clip-vitb32-cc12m"
CPU = "cpu"
RTOL_LOSS = 1e-5     # K1 f32, tests/test_kernels.py
TOL_EMBED = 1e-5     # extraction / serving, tests/test_eval.py


def quantized_emb(n, d, seed):
    """Entries in multiples of 1/64 (tests/test_eval.py): every f32 dot
    product is exact under any summation order."""
    rng = np.random.RandomState(seed)
    return (np.round(rng.randn(n, d) * 16) / 64.0).astype(np.float32)


def normalized(n, d, seed):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# Streaming top-k, tie rule, recall
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 7, 16, 64, 100])
def test_streaming_topk_matches_dense_oracle_and_jax_scan(chunk):
    """Bitwise equal to the port's dense ``lex_topk``, to JAX's dense
    oracle and to JAX's streaming scan, for chunks below, across and
    above N (ragged last chunk), with exact duplicate columns."""
    N, d, k = 53, 24, 10
    e1 = quantized_emb(N, d, 0)
    e2 = quantized_emb(N, d, 1)
    e2[10:13] = e2[3:6]                      # exact ties
    s, i = RT.streaming_topk(t(e1), t(e2), k, chunk=chunk)
    ds, di = M.lex_topk(t(e1) @ t(e2).T, k)
    js, ji = JRT.streaming_topk(jnp.asarray(e1), jnp.asarray(e2), k,
                                chunk=chunk)
    jds, jdi = JM.lex_topk(jnp.asarray(e1) @ jnp.asarray(e2).T, k)
    for got_s, got_i in ((ds, di), (js, ji), (jds, jdi)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(got_i))
        assert s.numpy().tobytes() == np.asarray(got_s).tobytes()


def test_lex_topk_tie_rule_and_signed_zeros_equal_jax():
    for row in ([1.0, 3.0, 3.0, 0.5, 3.0], [0.0, -0.0, 0.0, -0.0],
                [2.0, -0.0, 2.0, 0.0, -1.0, 0.0]):
        x = np.asarray([row], np.float32)
        s, i = M.lex_topk(t(x), 4)
        js, ji = JM.lex_topk(jnp.asarray(x), 4)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
    _, i = M.lex_topk(t(np.asarray([[1.0, 3.0, 3.0, 0.5, 3.0]],
                                   np.float32)), 4)
    assert i[0].tolist() == [1, 2, 4, 0]


def test_streaming_topk_excludes_padded_columns():
    """Columns past n_cols never enter the carry, even with the largest
    similarity; the result equals JAX's scan on the same padding."""
    rows = quantized_emb(8, 16, 2)
    cols = np.concatenate([quantized_emb(20, 16, 3),
                           100.0 * np.ones((12, 16), np.float32)])
    s, i = RT.streaming_topk(t(rows), t(cols), 5, chunk=6, n_cols=20)
    assert int(i.max()) < 20
    _, di = M.lex_topk(t(rows) @ t(cols[:20]).T, 5)
    js, ji = JRT.streaming_topk(jnp.asarray(rows), jnp.asarray(cols), 5,
                                chunk=6, n_cols=20)
    np.testing.assert_array_equal(i.numpy(), di.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()


def test_recall_at_k_valid_mask_equals_jax():
    idx = np.asarray([[0, 1], [5, 3], [9, 9]])
    gold = np.asarray([1, 3, 9])
    valid = np.asarray([True, True, False])
    for v in (None, valid):
        got = M.recall_at_k(t(idx), t(gold), (1, 2),
                            valid=None if v is None else t(v))
        want = JM.recall_at_k(jnp.asarray(idx), jnp.asarray(gold), (1, 2),
                              valid=None if v is None else jnp.asarray(v))
        assert {k: float(x) for k, x in got.items()} == {
            k: float(x) for k, x in want.items()}
    masked = M.recall_at_k(t(idx), t(gold), (1, 2), valid=t(valid))
    assert float(masked["r@1"]) == 0.0 and float(masked["r@2"]) == 1.0


def test_retrieval_recalls_equal_jax_on_quantized_embeddings():
    e1, e2 = quantized_emb(40, 16, 5), quantized_emb(40, 16, 6)
    got = RT.retrieval_recalls(t(e1), t(e2), chunk=16)
    want = JRT.retrieval_recalls(jnp.asarray(e1), jnp.asarray(e2), chunk=16)
    assert {k: float(v) for k, v in got.items()} == {
        k: float(v) for k, v in want.items()}


class _ShapeLog(TorchDispatchMode):
    """Records the shape of every tensor each dispatched op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out


def test_streaming_retrieval_materialises_no_NN_tensor():
    """The counterpart of tests/test_eval.py's HLO check: no op of the
    streaming scan returns a tensor with an (N, N) trailing shape; the
    dense oracle does (positive control)."""
    N, d, k, chunk = 384, 64, 10, 128
    a, b = t(normalized(N, d, 0)), t(normalized(N, d, 1))

    def has_nn(log):
        return any(len(s) >= 2 and s[-2:] == (N, N) for s in log.shapes)

    with _ShapeLog() as dense:
        M.lex_topk(a @ b.T, k)
    assert has_nn(dense)
    with _ShapeLog() as streaming:
        RT.retrieval_topk(a, b, k, chunk=chunk)
    assert streaming.shapes and not has_nn(streaming)
    assert max(s[-1] for s in streaming.shapes if s) <= k + chunk


# ---------------------------------------------------------------------------
# Known answers: the planted split end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,m,flip", [(6, 4, 0.0), (8, 3, 0.25),
                                      (5, 12, 0.4)])
def test_planted_metrics_equal_known_answers_exactly(C, m, flip):
    """Zero-shot top-1/top-5 and R@1/5/10 through the port's engine
    (extraction -> prompt-ensemble head -> streaming retrieval) equal the
    closed forms with ``==``; the port's ``known_answers`` equals JAX's;
    ``eval_loss`` through K1's plain version equals the dense one."""
    kw = dict(n_classes=C, n_per_class=m, label_flip_frac=flip, seed=C + m)
    ds = TZS(**kw)
    want = PL.known_answers(ds)
    assert want == JPL.known_answers(JZS(**kw))
    got = EN.evaluate_planted(PL.planted_params(ds, CPU), ds, chunk=8,
                              batch_size=7, loss_impl="fused", device=CPU)
    for key, w in want.items():
        assert got[key] == w, (key, got[key], w)
    dense = EN.evaluate_planted(PL.planted_params(ds, CPU), ds, chunk=8,
                                batch_size=7, loss_impl="dense", device=CPU)
    assert got["eval_loss"] == pytest.approx(dense["eval_loss"],
                                             rel=RTOL_LOSS)


@pytest.mark.parametrize("C,m,flip", [(192, 16, 0.0), (50, 7, 0.3)])
def test_known_answers_equal_jax(C, m, flip):
    """The closed form at the card's eval shape (192 x 16) and a flipped
    split, port copy against JAX's."""
    kw = dict(n_classes=C, n_per_class=m, label_flip_frac=flip, seed=1)
    assert PL.known_answers(TZS(**kw)) == JPL.known_answers(JZS(**kw))


def test_planted_encoders_are_exact_and_equal_jax():
    ds = TZS(n_classes=5, n_per_class=2, seed=1)
    params = PL.planted_params(ds, CPU)
    jparams = JPL.planted_params(JZS(n_classes=5, n_per_class=2, seed=1))
    batch = ds.batch(np.arange(ds.n))
    protos = ds.protos.reshape(ds.n_classes, -1)
    img = PL.encode_image(params, t(batch["images"])).numpy()
    np.testing.assert_array_equal(img, protos[ds.classes])
    txt = PL.encode_text(params, t(batch["texts"])).numpy()
    np.testing.assert_array_equal(txt, protos[ds.classes])
    assert img.tobytes() == np.asarray(JPL.encode_image(
        jparams, jnp.asarray(batch["images"]))).tobytes()
    prompts = TP.render_prompt_bank(ds.tok_base, TP.DEFAULT_TEMPLATES,
                                    ds.context_length)
    for p in prompts:
        out = PL.encode_text(params, t(p)).numpy()
        np.testing.assert_array_equal(out, protos)
        assert out.tobytes() == np.asarray(JPL.encode_text(
            jparams, jnp.asarray(p))).tobytes()
    assert params["tok_base"].dtype == torch.int32


# ---------------------------------------------------------------------------
# Templates and classifier heads
# ---------------------------------------------------------------------------

def test_templates_and_prompt_banks_bitwise_equal_jax():
    tp = TP.PromptTemplate("x", prefix=(3, 7), suffix=(5,))
    jp = JTP.PromptTemplate("x", prefix=(3, 7), suffix=(5,))
    for ctx in (10, 5):
        out = tp.render(np.asarray([11, 12, 13, 14]), ctx)
        assert out.tobytes() == jp.render(np.asarray([11, 12, 13, 14]),
                                          ctx).tobytes()
    assert tp.render(np.asarray([11, 12, 13, 14]), 5).tolist() == [
        3, 7, 11, 12, 13]
    assert TP.template_bank_signature(TP.DEFAULT_TEMPLATES) == \
        JTP.template_bank_signature(JTP.DEFAULT_TEMPLATES)
    bank = TZS(n_classes=7, n_per_class=1, seed=3).tok_base
    for ctx in (16, 6):
        a = TP.render_prompt_bank(bank, TP.DEFAULT_TEMPLATES, ctx)
        b = JTP.render_prompt_bank(bank, JTP.DEFAULT_TEMPLATES, ctx)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
        assert TP.render_prompt_bank(bank.copy(), TP.DEFAULT_TEMPLATES,
                                     ctx) is a      # memoised per class set
    assert TP.render_prompt_bank(bank + 1, TP.DEFAULT_TEMPLATES, 16) \
        is not TP.render_prompt_bank(bank, TP.DEFAULT_TEMPLATES, 16)


def test_classifier_head_cache_per_params_key_and_equal_jax():
    ds = TZS(n_classes=4, n_per_class=2, seed=5)
    params = PL.planted_params(ds, CPU)
    calls = []

    def enc(toks):
        calls.append(tuple(toks.shape))
        return PL.encode_text(params, toks)

    cache = {}
    kw = dict(context_length=ds.context_length, cache=cache, device=CPU)
    h1 = CL.build_head(enc, ds.tok_base, cache_key=7, **kw)
    h2 = CL.build_head(enc, ds.tok_base, cache_key=7, **kw)
    assert h2 is h1 and calls == [(16, ds.context_length)]   # one call, T*C
    CL.build_head(enc, ds.tok_base, cache_key=8, **kw)
    assert len(calls) == 2                       # a new params key rebuilds
    jparams = JPL.planted_params(JZS(n_classes=4, n_per_class=2, seed=5))
    jh = JCL.build_head(lambda x: JPL.encode_text(jparams, x), ds.tok_base,
                        context_length=ds.context_length)
    assert h1.numpy().tobytes() == np.asarray(jh).tobytes()


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

def test_extraction_ragged_tail_is_exact_on_planted():
    """n = 19, batch 8: two full batches and a padded tail; the pad rows
    are dropped and every row equals the one-batch forward bit for bit."""
    ds = TZS(n_classes=19, n_per_class=1, seed=4)
    params = PL.planted_params(ds, CPU)
    e1a, e2a = EX.extract_pair_embeddings(PL.encode_pair, params, ds,
                                          batch_size=8, device=CPU)
    e1b, e2b = EX.extract_pair_embeddings(PL.encode_pair, params, ds,
                                          batch_size=19, prefetch=0,
                                          device=CPU)
    assert e1a.shape == (19, PL.LATENT) and e1a.dtype == np.float32
    np.testing.assert_array_equal(e1a, e1b)
    np.testing.assert_array_equal(e2a, e2b)


@pytest.fixture(scope="module")
def bridged():
    """The reduced config's JAX params and the port's model holding the
    same values (carried across by ``checkpoint/bridge``)."""
    jcfg = j_get_arch(ARCH).reduced()
    jparams = JBB.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = get_arch(ARCH).reduced()
    model = BB.params_from_tree(tcfg, jax.tree.map(np.asarray, jparams),
                                device=CPU)
    return jcfg, jparams, tcfg, model


def _eval_kw(cfg):
    c = cfg.clip
    return dict(image_size=c.image_size, context_length=c.context_length,
                vocab_size=cfg.vocab_size)


def test_extraction_ragged_matches_full_batch_on_clip_towers(bridged):
    _, _, cfg, model = bridged
    ds = TZS(n_classes=5, n_per_class=2, seed=6, **_eval_kw(cfg))

    def fn(p, b):
        return BB.encode_pair(p, cfg, b, impl="flash")
    e1a, e2a = EX.extract_pair_embeddings(fn, model, ds, batch_size=4,
                                          device=CPU)
    e1b, e2b = EX.extract_pair_embeddings(fn, model, ds, batch_size=10,
                                          prefetch=0, device=CPU)
    np.testing.assert_allclose(e1a, e1b, atol=TOL_EMBED, rtol=0)
    np.testing.assert_allclose(e2a, e2b, atol=TOL_EMBED, rtol=0)


def test_extraction_matches_jax_from_bridged_params(bridged):
    jcfg, jparams, cfg, model = bridged
    kw = dict(n_classes=6, n_per_class=2, seed=7, **_eval_kw(cfg))
    e1, e2 = EX.extract_pair_embeddings(
        lambda p, b: BB.encode_pair(p, cfg, b, impl="flash"), model,
        TZS(**kw), batch_size=5, device=CPU)
    j1, j2 = JEX.extract_pair_embeddings(
        lambda p, b: JBB.encode_pair(p, jcfg, b), jparams, JZS(**kw),
        batch_size=5)
    np.testing.assert_allclose(e1, j1, atol=TOL_EMBED, rtol=0)
    np.testing.assert_allclose(e2, j2, atol=TOL_EMBED, rtol=0)


# ---------------------------------------------------------------------------
# The eval loss (K1 at the square eval shape)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [0.07, 0.01])
def test_contrastive_eval_loss_dense_and_fused_match_jax(tau):
    e1, e2 = normalized(48, 32, 8), normalized(48, 32, 9)
    want = float(JM.contrastive_eval_loss(jnp.asarray(e1), jnp.asarray(e2),
                                          tau, loss_impl="dense"))
    before = GL.gcl_pair_stats.launches
    for impl in ("dense", "fused"):
        got = M.contrastive_eval_loss(t(e1), t(e2), tau, loss_impl=impl)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=RTOL_LOSS)
    assert GL.gcl_pair_stats.launches == before   # CPU: the plain version
    with pytest.raises(ValueError, match="loss_impl"):
        M.contrastive_eval_loss(t(e1), t(e2), tau, loss_impl="bogus")


def test_contrastive_eval_loss_fused_matches_jax_pallas_interpret():
    e1, e2 = normalized(16, 32, 10), normalized(16, 32, 11)
    want = float(JM.contrastive_eval_loss(jnp.asarray(e1), jnp.asarray(e2),
                                          0.05, loss_impl="fused",
                                          interpret=True))
    got = float(M.contrastive_eval_loss(t(e1), t(e2), 0.05,
                                        loss_impl="fused"))
    assert got == pytest.approx(want, rel=RTOL_LOSS)


# ---------------------------------------------------------------------------
# ClipEvaluator against JAX's on a reduced config
# ---------------------------------------------------------------------------

def test_clip_evaluator_matches_jax(bridged):
    jcfg, jparams, cfg, model = bridged
    kw = dict(n_classes=6, n_per_class=3, label_flip_frac=0.2, seed=11,
              **_eval_kw(cfg))
    ev = EN.ClipEvaluator(cfg, TZS(**kw), impl="flash", batch_size=7,
                          chunk=8, loss_impl="fused", device=CPU)
    got = ev.evaluate(model, cache_key=3)
    again = ev.evaluate(model, cache_key=3)          # head from the cache
    assert again == got and len(ev.head_cache) == 1
    jev = JEN.ClipEvaluator(jcfg, JZS(**kw), batch_size=7, chunk=8,
                            loss_impl="dense")
    want = jev.evaluate(jparams, cache_key=3)
    assert set(got) == set(want)
    n = 18
    for key, w in want.items():
        if key == "eval_loss":
            assert got[key] == pytest.approx(w, rel=RTOL_LOSS)
        else:
            assert abs(got[key] - w) <= 1.0 / n + 1e-7, (key, got[key], w)


# ---------------------------------------------------------------------------
# The eval launcher
# ---------------------------------------------------------------------------

PLANTED = ["--planted", "--classes", "5", "--per-class", "3", "--chunk",
           "8", "--expect-known-answers"]


def test_eval_cli_planted_known_answers_write_then_restore(tmp_path, capsys):
    argv = ["--ckpt-dir", str(tmp_path), "--device", CPU, "--loss-impl",
            "fused", *PLANTED]
    metrics = teval.main(argv)            # first run writes the checkpoint
    out = capsys.readouterr().out
    assert "wrote reference planted checkpoint" in out
    assert "KNOWN-ANSWER MATCH (8 metrics exact)" in out
    line = [ln for ln in out.splitlines() if ln.startswith("EVAL ")][0]
    assert json.loads(line[5:])["zs_top1"] == 1.0 == metrics["zs_top1"]
    assert teval.main(argv) == metrics    # the second run restores it
    assert "wrote" not in capsys.readouterr().out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_planted_checkpoint_crosses_between_packages(tmp_path, writer):
    """A planted checkpoint written by one package restores in the other
    (the int32 ``tok_base`` leaf included), and both launchers then
    reproduce the known answers exactly."""
    d = str(tmp_path)
    first, second = ((jeval.main, lambda a: teval.main(a + ["--device",
                                                          CPU]))
                     if writer == "jax" else
                     (lambda a: teval.main(a + ["--device", CPU]),
                      jeval.main))
    m1 = first(["--ckpt-dir", d, *PLANTED])
    m2 = second(["--ckpt-dir", d, *PLANTED])
    assert m1 == m2
    assert TCK.latest_step(d) == 0
    ds = TZS(n_classes=5, n_per_class=3)
    tree, _, meta = TCK.restore(d, PL.planted_params(ds, CPU))
    assert tree["tok_base"].dtype == np.int32 and meta["planted"] is True
    assert tree["tok_base"].tobytes() == ds.tok_base.tobytes()


def _port_train_ckpt(d, cfg):
    tc = TS.TrainStepConfig(arch=cfg, fc=FC.FastCLIPConfig(n_samples=32),
                            optimizer=adamw(),
                            lr_fn=lr_warmup_cosine(1e-3, 2, 10))
    state = TS.init_train_state(torch.Generator().manual_seed(0), tc, CPU)
    TCK.save(d, bridge.state_to_tree(state), 3, {"arch": ARCH})
    return state["params"]


def _jax_train_ckpt(d, cfg):
    fc = JFC.FastCLIPConfig(version="v3", n_samples=32, steps_per_epoch=2,
                            gamma_decay_epochs=2)
    tc = JTS.TrainStepConfig(arch=cfg, fc=fc, optimizer=j_adamw(),
                             lr_fn=j_lr(1e-3, 2, 10))
    state = JTS.init_train_state(jax.random.PRNGKey(0), tc)
    JCK.save(d, jax.device_get(state), 3, metadata={"arch": ARCH})
    return BB.params_from_tree(get_arch(ARCH).reduced(),
                               jax.tree.map(np.asarray, state["params"]),
                               device=CPU)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_eval_cli_restores_params_subtree_of_a_train_ckpt(tmp_path, writer):
    """The real-model path: a full train state written by either package,
    only its ``params`` subtree restored; the metrics equal a
    ``ClipEvaluator`` pass over the same params."""
    d = str(tmp_path)
    if writer == "port":
        model = _port_train_ckpt(d, get_arch(ARCH).reduced())
    else:
        model = _jax_train_ckpt(d, j_get_arch(ARCH).reduced())
    argv = ["--ckpt-dir", d, "--reduced", "--classes", "4", "--per-class",
            "2", "--batch-size", "8", "--loss-impl", "fused", "--device",
            CPU]
    metrics = teval.main(argv)
    assert set(metrics) == {"zs_top1", "zs_top5", "i2t_r@1", "i2t_r@5",
                            "i2t_r@10", "t2i_r@1", "t2i_r@5", "t2i_r@10",
                            "eval_loss"}
    assert all(np.isfinite(v) for v in metrics.values())
    cfg = get_arch(ARCH).reduced()
    ds = teval.build_eval_dataset(argparse.Namespace(
        classes=4, per_class=2, flip_frac=0.0, seed=0), cfg)
    want = EN.ClipEvaluator(cfg, ds, batch_size=8, chunk=512,
                            loss_impl="fused", device=CPU).evaluate(model)
    assert metrics == want


def test_eval_entry_points_need_the_card(tmp_path):
    """Without CUDA the launcher and the engine's entry points raise
    instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    ds = TZS(n_classes=2, n_per_class=2)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        teval.main(["--ckpt-dir", str(tmp_path), *PLANTED])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        PL.planted_params(ds)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        EN.evaluate_embeddings(np.eye(4, dtype=np.float32),
                               np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        EN.ClipEvaluator(get_arch(ARCH).reduced(), ds)
