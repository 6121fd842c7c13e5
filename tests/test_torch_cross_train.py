"""Training the port's cross-attention families on the CPU against the
JAX package: the vlm ``llama-3.2-vision-11b`` (the image projection
computed once, then self and cross blocks, each recomputed on its own
under autograd) and the audio encoder-decoder ``seamless-m4t-large-v2``
(each encoder and decoder layer recomputed on its own; every cross block
reads the encoder's output).  The models are reduced configs; one set of
params (the port's init, through the bridge, with every norm scale
drawn at random so that it counts) and the same numpy-seeded
tokens and stub inputs (standard normal x 0.1, as the JAX launcher and
tests/test_torch_cross.py draw them) go through both packages, JAX at
its default ``impl="chunked"``:

  * K3's gradient at Sq != Sk, non-causal: ``chunked_attention`` (the
    backward of ``_FlashMHA`` on the card) against autograd of
    ``naive_attention`` at the shapes of a cross block, 1e-5;
  * the parameter counts at the card's depths (``VLM_TRAIN_LAYERS``, one
    super-block, and ``VLM_SERVE_LAYERS``) equal JAX's, from shapes;
  * the recompute: gradients bitwise equal to those with it bypassed,
    each block's forward counted (twice under grad, once without), the
    attention calls with it;
  * ``lm_loss`` and ``jax.value_and_grad`` of JAX's, the port at ``impl``
    flash (the kernel wrapper's plain version here) and chunked: loss
    rtol 1e-5, every leaf's gradient within 1e-4 relative L2
    (tests/test_torch_dense_train.py's bounds), ``img_proj`` and every
    encoder leaf among them;
  * ``encode_pair``'s gradients (a fixed random projection of both
    embeddings) against JAX's, per leaf at 1e-4; the audio decoder,
    ``embed``, ``final_norm`` and ``lm_head`` unreached (zero) on both
    sides, as ``encode`` pools the encoder alone;
  * three steps of ``launch.steps.make_lm_train_step`` and three
    FastCLIP v3 steps of ``core.train_step.make_train_step`` against
    JAX's ``make_lm_train_step`` / ``make_contrastive_train_step``, the
    first at the warm-up's lr 0 (AdamW's moments filled), the next two
    moving the params: losses rtol 1e-5; per group of leaves, AdamW's
    moments (1e-4) and the update divided by lr (1e-3) by relative L2; a
    group with a zero gradient keeps zero moments and moves by the
    decoupled decay alone, on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.core import fastclip as JFC
from repro.launch import steps as JST
from repro.models import backbones as JBB
from repro_torch.checkpoint import bridge, flatten, unflatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import fastclip as TFC
from repro_torch.core import train_step as TTS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import LMDataset as TLD
from repro_torch.data import PairedEmbeddingDataset as TPD
from repro_torch.data import ShardedLoader as TSL
from repro_torch.launch import steps as TST
from repro_torch.models import attention as TA
from repro_torch.models import backbones as TBB
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw

VLM, AUDIO = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = [VLM, AUDIO]
# the card's depths (chip_smoke.py): the vlm trains at one super-block
# (4 self blocks and 1 cross block) and serves at two; JAX's counts
VLM_TRAIN_LAYERS, VLM_SERVE_LAYERS = 5, 10
PARAMS = {(VLM, VLM_TRAIN_LAYERS): 2_190_786_560,
          (VLM, VLM_SERVE_LAYERS): 3_323_293_696,
          (AUDIO, 12): 1_280_636_928}
B, S, N = 2, 32, 16
GB = 4                      # the contrastive steps' global batch
LR, TOTAL = 0.5, 10
LOSS_RTOL, GRAD_TOL, MOMENT_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-4, 1e-3
BETA1 = 0.9                 # AdamW's, in both packages
ATTN_GRAD_TOL = 1e-5
# the leaves each objective does not reach
UNREACHED = {
    ("lm", VLM): ["ctr_proj", "pair_proj"],
    ("lm", AUDIO): ["ctr_proj", "pair_proj"],
    ("contrastive", VLM): ["lm_head"],
    ("contrastive", AUDIO): ["dec_blocks", "embed", "final_norm",
                             "lm_head"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the CPU matmuls' bits
    depend on the thread count, and the suite's workers share the host's
    cores."""
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


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


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


def _perturb(tree, seed):
    """Every norm scale away from one (the init sets ones, which would
    hide a swapped norm) and every QKV bias, where a config has them,
    away from zero."""
    rng = np.random.default_rng(seed)

    def one(path, v):
        name = _path_str(path)
        if name.endswith("scale"):
            return v * (1.0 + 0.5 * rng.standard_normal(v.shape,
                                                         dtype=np.float32))
        if name.endswith(("/bq", "/bk", "/bv")):
            return v + 0.1 * rng.standard_normal(v.shape, dtype=np.float32)
        return v
    return jax.tree_util.tree_map_with_path(one, tree)


def _stub(cfg, rows, seed):
    """The family's stub input for ``rows`` rows, numpy-seeded."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": 0.1 * rng.standard_normal(
            (rows, cfg.n_image_tokens, cfg.vision_dim), dtype=np.float32)}
    return {"frames": 0.1 * rng.standard_normal(
        (rows, S // cfg.audio_subsample, cfg.d_model), dtype=np.float32)}


def _jb(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tb(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _fc(mod, loss_impl="dense"):
    return mod.FastCLIPConfig(version="v3", n_samples=N,
                              steps_per_epoch=N // GB, gamma_decay_epochs=1,
                              loss_impl=loss_impl)


def _pair_weights(cfg):
    """Fixed projections of both embeddings: the scalar whose gradient
    ``test_encode_pair_gradients_match_jax`` compares."""
    rng = np.random.default_rng(5)
    return [rng.standard_normal((B, TBB.CONTRASTIVE_DIM), dtype=np.float32)
            for _ in range(2)]


# ---------------------------------------------------------------------------
# K3's gradient at the cross shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Sq,Sk", [(300, 70), (64, 300)])
def test_chunked_attention_gradients_at_sq_ne_sk(Sq, Sk, hd):
    """dq, dk, dv of ``chunked_attention`` (what ``_FlashMHA.backward``
    differentiates) against autograd of ``naive_attention``, non-causal,
    Sq != Sk: at the default chunks (one block here, as at the cards'
    cross shapes' kv) and at small ones (several q and kv blocks)."""
    gen = torch.Generator().manual_seed(Sq + Sk + hd)
    q = torch.randn((2, Sq, 4, hd), generator=gen, requires_grad=True)
    k, v = (torch.randn((2, Sk, 4, hd), generator=gen, requires_grad=True)
            for _ in range(2))
    ct = torch.randn((2, Sq, 4, hd), generator=gen)
    want = torch.autograd.grad(TA.naive_attention(q, k, v, causal=False),
                               (q, k, v), ct)
    for chunks in ({}, {"q_chunk": 128, "kv_chunk": 64}):
        got = torch.autograd.grad(TA.chunked_attention(
            q, k, v, causal=False, **chunks), (q, k, v), ct)
        for name, a, b in zip("qkv", got, want):
            err = (a - b).abs().max().item()
            assert err <= ATTN_GRAD_TOL, (name, chunks, err)


@pytest.mark.parametrize("arch,n_layers", sorted(PARAMS))
def test_param_counts_at_the_cards_depths_equal_jax(arch, n_layers):
    jcfg = j_get_arch(arch).replace(n_layers=n_layers)
    shapes = jax.eval_shape(lambda: JBB.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    tcfg = t_get_arch(arch).replace(n_layers=n_layers)
    n_port = sum(int(np.prod(v.shape)) for v in flatten(
        TBB.param_shapes(tcfg)).values())
    assert n_jax == n_port == PARAMS[arch, n_layers]


# ---------------------------------------------------------------------------
# The recompute
# ---------------------------------------------------------------------------

def _lm_batch(cfg, i=0):
    b = TLD(n=N, seq_len=S, vocab_size=cfg.vocab_size).batch(
        np.arange(B * i, B * (i + 1)))
    return {**b, **_stub(cfg, B, 11 + i)}


def _blocks_and_attention(cfg):
    """(block forwards, attention calls) of one forward: the vlm's self
    and cross blocks (a cross block attends twice), the audio's encoder
    and decoder blocks (a decoder block attends twice)."""
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        return cfg.n_layers, cfg.n_layers + n_cross
    return cfg.enc_layers + cfg.n_layers, cfg.enc_layers + 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_recompute_is_bitwise_and_counted(arch, monkeypatch):
    """Under grad each block is one checkpoint and runs twice (its
    forward and its recompute); with the recompute bypassed the same
    gradients to the bit, each block once; without grad (prefill) once,
    no checkpoint.  The vlm at two super-blocks."""
    cfg = t_get_arch(arch).reduced()
    if cfg.family == "vlm":
        cfg = cfg.replace(n_layers=4)
    model = TBB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _tb(_lm_batch(cfg))
    blocks, attn = _blocks_and_attention(cfg)
    n = {"block": 0, "attn": 0, "ckpt": 0}
    orig_blk, orig_attn, orig_ckpt = (TT.Block.forward, TA.flash_mha,
                                      TBB.checkpoint)

    def counted(key, fn):
        def run(*a, **k):
            n[key] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(TT.Block, "forward", counted("block", orig_blk))
    monkeypatch.setattr(TA, "flash_mha", counted("attn", orig_attn))
    monkeypatch.setattr(TBB, "checkpoint", counted("ckpt", orig_ckpt))

    def loss_grads():
        for k in n:
            n[k] = 0
        with torch.enable_grad():
            loss, _ = TBB.lm_loss(model, cfg, batch)
            return loss.item(), TTS.param_grads(loss, model)
    loss, grads = loss_grads()
    assert n == {"block": 2 * blocks, "attn": 2 * attn, "ckpt": blocks}
    with monkeypatch.context() as m:      # the recompute, bypassed
        m.setattr(TBB, "checkpoint", lambda fn, *a, **k: fn(*a))
        loss0, grads0 = loss_grads()
    assert (n["block"], n["attn"]) == (blocks, attn)
    assert loss == loss0 and sorted(grads) == sorted(grads0)
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k
    for k in n:
        n[k] = 0
    TST.make_prefill_step(cfg)(model, batch)
    assert n == {"block": blocks, "attn": attn, "ckpt": 0}


# ---------------------------------------------------------------------------
# The loss, the LM steps and the contrastive steps against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The JAX side, once per arch: the (perturbed) init of the port,
    carried over by the bridge (JAX's init would cost a compile); three
    jitted LM
    steps (the first at the warm-up's lr 0, which leaves the params as
    they are and gives the loss and its gradient at the init: AdamW's
    first moment is (1 - beta1) g); ``encode_pair``'s gradients; three
    jitted v3 steps."""
    arch = request.param
    jcfg, tcfg = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    init = TBB.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    params = _perturb(jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                                   bridge.model_to_tree(init)), 1)
    lm_batches = [_lm_batch(tcfg, i) for i in range(3)]
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
    w1, w2 = _pair_weights(tcfg)
    pair_batch = {**TPD(n=N, seq_len=S, vocab_size=tcfg.vocab_size).batch(
        np.arange(B)), **_stub(tcfg, B, 21)}
    jpb = _jb(pair_batch)

    def pair_scalar(p):
        e1, e2 = JBB.encode_pair(p, jcfg, jpb)
        return jnp.sum(e1 * w1) + jnp.sum(e2 * w2)
    pair_grads = jax.jit(jax.grad(pair_scalar))(params)
    kw = dict(n=N, seq_len=S, vocab_size=tcfg.vocab_size)
    ctr_data = [(idx, {**b, **_stub(tcfg, GB, 31 + i)})
                for i, (_, _, idx, b) in enumerate(TSL(
                    TPD(**kw), global_batch=GB, seed=3).steps(3))]
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
    return dict(arch=arch, tcfg=tcfg, params=jax_flat(params),
                loss=lm_losses[0], grads=grads, pair_batch=pair_batch,
                pair_grads=jax_flat(pair_grads), lm_batches=lm_batches,
                lm_states=lm_states, lm_losses=lm_losses, ctr_data=ctr_data,
                ctr_states=ctr_states, ctr_metrics=ctr_metrics)


def _hold_grads(grads, want, unreached):
    """Every leaf within GRAD_TOL of JAX's; the unreached groups zero on
    both sides and no other leaf zero."""
    assert sorted(grads) == sorted(want)
    zero = sorted(k for k, w in want.items() if not np.any(w))
    assert zero == sorted(k for k in want
                          if k.split("/")[0] in unreached), zero
    for k, w in want.items():
        if k in zero:
            assert not np.any(grads[k]), k
            continue
        assert _rel_l2(grads[k], w) <= GRAD_TOL, (k, _rel_l2(grads[k], w))


def _named_grads(model, grads):
    return {k: v.numpy() for k, v in flatten(
        bridge.named_to_tree(model, grads)).items()}


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_lm_loss_and_gradients_match_jax(ref, impl):
    tcfg = ref["tcfg"]
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
    with torch.enable_grad():
        loss, _ = TBB.lm_loss(model, tcfg, _tb(ref["lm_batches"][0]),
                              impl=impl)
        grads = TTS.param_grads(loss, model)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    grads = _named_grads(model, grads)
    # the image projection and the encoder are reached through the
    # cross blocks' closures
    reach = "img_proj" if tcfg.family == "vlm" else "enc_blocks/"
    assert any(k.startswith(reach) and np.any(g) for k, g in grads.items())
    _hold_grads(grads, ref["grads"], UNREACHED["lm", ref["arch"]])


def test_encode_pair_gradients_match_jax(ref):
    tcfg = ref["tcfg"]
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
    w1, w2 = (torch.from_numpy(w) for w in _pair_weights(tcfg))
    with torch.enable_grad():
        e1, e2 = TBB.encode_pair(model, tcfg, _tb(ref["pair_batch"]))
        grads = TTS.param_grads((e1 * w1).sum() + (e2 * w2).sum(), model)
    _hold_grads(_named_grads(model, grads), ref["pair_grads"],
                UNREACHED["contrastive", ref["arch"]])


def _check_step(before, after, want_before, want, lr, zero_grad):
    """AdamW's moments and the update / lr per group of leaves against
    JAX's; ``zero_grad``: the groups with a zero gradient (zero moments,
    moved by the decoupled decay alone)."""
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
        if g in zero_grad:      # decoupled decay alone: p (1 - lr wd)
            assert np.any(p1[g] != p0[g]), g
            for a in (p1[g], q1[g]):
                np.testing.assert_allclose(a, q0[g] * (1 - lr * 0.1),
                                           rtol=1e-6, err_msg=g)
            continue
        u_got, u_want = (p0[g] - p1[g]) / lr, (q0[g] - q1[g]) / lr
        assert np.any(u_want), g            # the step moved the params
        assert _rel_l2(u_got, u_want) <= UPDATE_TOL, (
            g, _rel_l2(u_got, u_want))


def _lr(i):
    """The learning rate of step ``i`` (a warm-up of 500 steps)."""
    return LR * i / 500


def test_lm_steps_match_jax(ref):
    """Three steps from the init: the first at lr 0 (its moments held),
    the next two moving the params.  From zero moments AdamW's step is
    g / (|g| + eps): an entry whose gradient is at f32 rounding (~1e-9,
    six orders under its leaf's rms, measured here) moves by a fraction
    of lr that rounding decides, a few per group (1.2e-3 relative L2 of
    the vlm's ``supers`` group between the packages); with moments in,
    such an entry moves by what its earlier gradients say."""
    tcfg = ref["tcfg"]
    step, opt = TST.make_lm_train_step(tcfg, lr=LR, wd=0.1,
                                       total_steps=TOTAL, device="cpu")
    model = TBB.params_from_tree(tcfg, ref["params"], "cpu")
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
                    ref["lm_states"][i + 1], _lr(i),
                    UNREACHED["lm", ref["arch"]])
        before = after


def test_contrastive_steps_match_jax(ref):
    """Three v3 steps from the init, as ``test_lm_steps_match_jax``:
    the first at lr 0, the next two moving the params."""
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
                                       rtol=1e-5, atol=1e-5, err_msg=u)
        _check_step(before, after, ref["ctr_states"][i], want, _lr(i),
                    UNREACHED["contrastive", ref["arch"]])
        before = after
