"""The port's cross-attention and the two families built on it, served on
the CPU against the JAX package: the vlm ``llama-3.2-vision-11b``
(super-blocks of causal self blocks and one cross block over the
projected stub image) and the audio encoder-decoder
``seamless-m4t-large-v2`` (a causal encoder over stub frames, decoder
blocks with cross-attention to it).  One set of params (the JAX init,
through the bridge, with every norm scale drawn at random so that a
swapped norm shows) and the same numpy-seeded tokens, image embeds and
frames go through both packages, at the reduced configs.

Tolerances (f32), those of ``tests/test_torch_dense.py``: one attention
layer or block 1e-5; the whole model's final hidden states, logits and
embeddings 1e-4; decode vs JAX's decode 1e-4; decode vs teacher-forced
forward 5e-3 (``tests/test_decode_equivalence.py``).  The long_500k
decode shape (a sliding window on the self caches, none on the cross
caches) is held to JAX's ``make_serve_step`` with ``LONG_WINDOW`` made
small in both packages' ``launch.steps``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.launch import steps as JST
from repro.models import attention as JA
from repro.models import backbones as JBB
from repro.models import transformer as JT
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as TA
from repro_torch.models import backbones as TBB
from repro_torch.models import transformer as TT


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite's workers
    share the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


VLM, AUDIO = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = [VLM, AUDIO]
FULL_PARAMS = {VLM: 10_118_336_512, AUDIO: 1_280_636_928}
B, T = 2, 24


def _flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(tree, seed):
    """Every norm scale away from one and every QKV bias away from zero
    (JAX's init sets ones and zeros, which would hide a swapped norm)."""
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


def _stub(cfg, seed=9, seq=T):
    """The family's modality input, numpy-seeded, as the JAX launcher
    builds it (standard normal x 0.1)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": 0.1 * rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.vision_dim), dtype=np.float32)}
    return {"frames": 0.1 * rng.standard_normal(
        (B, seq // cfg.audio_subsample, cfg.d_model), dtype=np.float32)}


def _jb(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tb(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, tcfg = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    jparams = _perturb(JBB.init_params(jax.random.PRNGKey(0), jcfg), 3)
    flat = _flat(jparams)
    model = TBB.params_from_tree(tcfg, flat, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    batch = {"tokens": tokens, **_stub(tcfg)}
    jh = JBB.forward_hidden(jparams, jcfg, _jb(batch), impl="naive")[0]
    want = (np.asarray(jh),
            np.asarray(JBB.logits_from_hidden(jparams, jcfg, jh)))
    return jcfg, tcfg, jparams, flat, model, batch, want


@pytest.mark.parametrize("arch", ARCHS + ["xlstm-125m"])
def test_configs_equal_jax_field_by_field(arch):
    """Every field of the port's config (full and reduced) equals the JAX
    config's field of that name, ``is_encdec`` too; the port lacks no
    JAX field (the ssm family's ``xlstm_pattern`` came with the
    xLSTM)."""
    j, t = j_get_arch(arch), t_get_arch(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        for f in dataclasses.fields(tc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if dataclasses.is_dataclass(b):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name, a, b)
        missing = {f.name for f in dataclasses.fields(jc)} - {
            f.name for f in dataclasses.fields(tc)}
        assert missing == set()
        assert tc.is_encdec == jc.is_encdec == (arch == AUDIO)
        assert tc.padded_vocab == jc.padded_vocab
    r = t.reduced()
    if arch == VLM:
        assert (r.cross_attn_every, r.n_image_tokens, r.vision_dim) == (
            2, 16, 64)
    elif arch == AUDIO:
        assert (r.enc_layers, r.n_layers) == (1, 2)
    else:
        assert (r.n_layers, r.xlstm_pattern) == (2, "mmmsmmmsmmms")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_structure_matches_jax_param_shapes(arch):
    """The meta model at full width: JAX's leaf paths and shapes, and
    JAX's parameter count."""
    cfg = t_get_arch(arch)
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(
                   JBB.param_shapes(j_get_arch(arch)))[0]}
    tshapes = flatten(TBB.param_shapes(cfg))
    assert all(v.device.type == "meta" for v in tshapes.values())
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == jshapes
    assert sum(int(np.prod(s)) for s in jshapes.values()) == \
        FULL_PARAMS[arch]
    if arch == VLM:
        n_super = cfg.n_layers // cfg.cross_attn_every
        assert jshapes["supers/selfs/attn/wq"][:2] == (n_super, 4)
        assert jshapes["supers/cross_blk/cross/wk"] == (n_super, 4096, 1024)
        assert jshapes["img_proj"] == (1280, 4096)
    else:
        assert jshapes["enc_blocks/attn/wq"][0] == 12
        assert jshapes["dec_blocks/cross/wv"] == (12, 1024, 1024)
        assert jshapes["enc_norm/scale"] == (1024,)


def _cross_spec_kw(hd, n_kv, qk):
    return dict(d_model=64, n_heads=4, n_kv_heads=n_kv, head_dim=hd,
                qk_norm=qk, qkv_bias=qk, rope_theta=1e6, causal=True,
                sliding_window=16 if qk else 0, q_chunk=8, kv_chunk=16)


@pytest.mark.parametrize("hd,n_kv,qk", [(64, 2, False), (128, 1, True)])
@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_cross_attention_matches_jax(impl, hd, n_kv, qk):
    """One cross-attention layer (GQA; kv_dim 48 != d_model 64; with
    qk-norm, QKV bias and a window in the spec, which a cross call
    ignores) against ``A.attention(kv_x=...)`` (naive), its cross cache
    against ``init_cross_cache`` and five one-token steps against
    ``decode_cross_attention`` and the forward, 1e-5."""
    kw = _cross_spec_kw(hd, n_kv, qk)
    spec_j, spec_t = JA.AttnSpec(**kw), TA.AttnSpec(**kw)
    params = _perturb({"c": JA.init_attention(jax.random.PRNGKey(5), spec_j,
                                              kv_dim=48)}, 9)["c"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 33, 64), dtype=np.float32) * 0.5
    kv = rng.standard_normal((2, 21, 48), dtype=np.float32) * 0.5
    mod = TA.Attention(spec_t, kv_dim=48)
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v))
                         for k, v in _flat(params).items()})
    want = np.asarray(JA.attention(params, spec_j, jnp.asarray(x),
                                   kv_x=jnp.asarray(kv), impl="naive"))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x), kv_x=torch.from_numpy(kv), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    jc = JA.init_cross_cache(params, spec_j, jnp.asarray(kv))
    with torch.inference_mode():
        tc = mod.init_cross_cache(torch.from_numpy(kv))
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == (2, 21, n_kv, hd)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=0)
    for pos in range(5):
        xt = x[:, pos:pos + 1]
        jout = JA.decode_cross_attention(params, spec_j, jc, jnp.asarray(xt))
        with torch.inference_mode():
            out = mod.decode_cross(tc, torch.from_numpy(xt))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out.numpy(), want[:, pos:pos + 1],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_cross_block_matches_jax(impl):
    """The reduced vlm's cross block at head dim 128 (self-attention,
    cross-attention over the projected image, MLP) against
    ``apply_block(kv_x=...)`` (naive), and decode through its self cache
    and a filled cross cache against ``decode_block``, 1e-5."""
    jcfg = j_get_arch(VLM).reduced().replace(head_dim=128)
    tcfg = t_get_arch(VLM).reduced().replace(head_dim=128)
    params = _perturb({"b": JT.init_block(jax.random.PRNGKey(2), jcfg,
                                          cross=True)}, 4)["b"]
    blk = TT.Block(tcfg, TT.attn_spec(tcfg), mlp="swiglu", cross=True)
    flat = _flat(params)
    assert {"n_cross/scale", "cross/wq", "cross/wk"} <= set(flat)
    blk.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v))
                         for k, v in flat.items()})
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 20, tcfg.d_model), dtype=np.float32) * 0.5
    kv = rng.standard_normal((B, 16, tcfg.d_model), dtype=np.float32) * 0.5
    want = np.asarray(JT.apply_block(params, jcfg, jnp.asarray(x),
                                     kv_x=jnp.asarray(kv), impl="naive"))
    with torch.inference_mode():
        got = blk(torch.from_numpy(x), kv_x=torch.from_numpy(kv), impl=impl)
        plain = blk(torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert np.abs(plain.numpy() - want).max() > 1e-2   # the cross counts
    spec_j = JT.attn_spec(jcfg)
    jcache = {"kv": JA.init_kv_cache(spec_j, B, 8, jnp.float32),
              "cross": JA.init_cross_cache(params["cross"],
                                           JT.attn_spec(jcfg, causal=False),
                                           jnp.asarray(kv))}
    cache = TA.init_kv_cache(TT.attn_spec(tcfg), B, 8, torch.float32)
    with torch.inference_mode():
        cross = blk.cross.init_cross_cache(torch.from_numpy(kv))
    for pos in range(4):
        xt = x[:, pos:pos + 1]
        jout, jcache = JT.decode_block(params, jcfg, jcache, jnp.asarray(xt),
                                       jnp.int32(pos))
        with torch.inference_mode():
            out, cache = blk.decode(cache, torch.from_numpy(xt), pos,
                                    cross_cache=cross)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out.numpy(), want[:, pos:pos + 1],
                                   atol=1e-5, rtol=0)


def test_bridge_roundtrip_bitwise_both_ways(setup):
    """JAX tree -> port model -> JAX tree, and a port-initialised model
    -> tree -> model, bit for bit; the tree has JAX's paths (the vlm's
    ``supers/selfs`` with two leading axes)."""
    _, tcfg, _, flat, model, _, _ = setup
    back = {k: v.numpy() for k, v in
            flatten(bridge.model_to_tree(model)).items()}
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        assert back[k].tobytes() == flat[k].tobytes(), k
    if tcfg.family == "vlm":
        assert flat["supers/selfs/attn/wq"].shape[:2] == (1, 1)
        np.testing.assert_array_equal(
            model.supers[0].cross_blk.cross.wk.detach().numpy(),
            flat["supers/cross_blk/cross/wk"][0])
    else:
        np.testing.assert_array_equal(
            model.dec_blocks[1].cross.wv.detach().numpy(),
            flat["dec_blocks/cross/wv"][1])
    own = TBB.init_params(tcfg, torch.Generator().manual_seed(4), "cpu")
    tree = {k: v.numpy() for k, v in
            flatten(bridge.model_to_tree(own)).items()}
    assert {k: v.shape for k, v in tree.items()} == \
        {k: v.shape for k, v in flat.items()}
    again = TBB.params_from_tree(tcfg, tree, "cpu")
    for (n, p), (n2, p2) in zip(own.named_parameters(),
                                again.named_parameters()):
        assert n == n2 and p.detach().numpy().tobytes() == \
            p2.detach().numpy().tobytes(), n


@pytest.mark.parametrize("impl", ["flash", "chunked", "naive"])
def test_forward_and_prefill_match_jax(setup, impl):
    """``forward_hidden`` and the prefill step (last-position logits)
    against JAX's naive forward, 1e-4."""
    _, tcfg, _, _, model, batch, (jh, jlogits) = setup
    tb = _tb(batch)
    with torch.inference_mode():
        th, aux = TBB.forward_hidden(model, tcfg, tb, impl=impl)
    got = steps.make_prefill_step(tcfg, impl=impl)(model, tb)
    assert aux == {} and got.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(th.numpy(), jh, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), jlogits[:, -1:], atol=1e-4,
                               rtol=0)


def test_encode_matches_jax(setup):
    """The contrastive tower (``encode``; for audio the encoder alone)
    and, for audio, ``encode_frames``, against JAX's, 1e-4."""
    jcfg, tcfg, jparams, _, model, batch, _ = setup
    want = np.asarray(JBB.encode(jparams, jcfg, _jb(batch), impl="naive"))
    with torch.inference_mode():
        got = TBB.encode(model, tcfg, _tb(batch), impl="flash")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if tcfg.family == "audio":
        jenc = JBB.encode_frames(jparams, jcfg, jnp.asarray(batch["frames"]),
                                 impl="naive")
        with torch.inference_mode():
            enc = TBB.encode_frames(model, tcfg,
                                    torch.from_numpy(batch["frames"]))
        assert tuple(enc.shape) == (B, T // 4, tcfg.d_model)
        np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=1e-4,
                                   rtol=0)


def _want_calls(cfg):
    """{((Sq, Sk), causal): calls} of one prefill at (B, T)."""
    if cfg.family == "vlm":
        return {((T, T), True): cfg.n_layers,
                ((T, cfg.n_image_tokens), False):
                    cfg.n_layers // cfg.cross_attn_every}
    S_enc = T // cfg.audio_subsample
    return {((S_enc, S_enc), True): cfg.enc_layers,
            ((T, T), True): cfg.n_layers,
            ((T, S_enc), False): cfg.n_layers}


def test_flash_routes_every_attention_through_the_kernel_wrapper(
        setup, monkeypatch):
    """impl="flash" sends each self- and cross-attention to the K3
    wrapper exactly once, at the shapes listed (cross non-causal, no
    window); the plain impls, ``prepare_decode_state`` and decode never
    reach it."""
    _, tcfg, _, _, model, batch, _ = setup
    calls = []

    def count(q, k, v, **kw):
        assert kw["window"] == 0
        assert q.shape[2:] == k.shape[2:] == v.shape[2:] == (
            tcfg.n_heads, tcfg.resolved_head_dim)
        calls.append(((q.shape[1], k.shape[1]), kw["causal"]))
        return FA.flash_mha(q, k, v, **kw)
    monkeypatch.setattr("repro_torch.models.attention.flash_mha", count)
    tb = _tb(batch)
    for impl, want in (("flash", _want_calls(tcfg)), ("chunked", {}),
                       ("naive", {})):
        calls.clear()
        steps.make_prefill_step(tcfg, impl=impl)(model, tb)
        got = {c: calls.count(c) for c in set(calls)}
        assert got == want, impl
    calls.clear()
    state = TBB.prepare_decode_state(model, tcfg, tb, B, T)
    step = steps.make_serve_step(tcfg, INPUT_SHAPES["decode_32k"])
    for t in range(3):
        step(model, state, tb["tokens"][:, t:t + 1], t)
    assert calls == []


def test_decode_step_matches_jax_and_forward(setup):
    """``prepare_decode_state`` (the cross caches filled once, stored
    before the GQA repeat) against JAX's, then ``decode_step`` over the
    prompt against JAX's (1e-4) and against the forward logits (5e-3)."""
    jcfg, tcfg, jparams, _, model, batch, (_, jlogits) = setup
    jstate = JBB.prepare_decode_state(jparams, jcfg, _jb(batch), B, T,
                                      dtype=jnp.float32)
    state = TBB.prepare_decode_state(model, tcfg, _tb(batch), B, T)
    assert sorted(state) == sorted(jstate)
    hd = tcfg.resolved_head_dim
    n_cross = (tcfg.n_layers // tcfg.cross_attn_every
               if tcfg.family == "vlm" else tcfg.n_layers)
    n_kv = (tcfg.n_image_tokens if tcfg.family == "vlm"
            else T // tcfg.audio_subsample)
    assert sorted(state["cross_kv"]) == ["k", "v"]
    for name in ("k", "v"):
        assert tuple(state["cross_kv"][name].shape) == (
            n_cross, B, n_kv, tcfg.n_kv_heads, hd)
        np.testing.assert_allclose(state["cross_kv"][name].numpy(),
                                   np.asarray(jstate["cross_kv"][name]),
                                   atol=1e-5, rtol=0)
    for key in state:
        if key != "cross_kv":
            assert tuple(state[key]["k"].shape) == jstate[key]["k"].shape
    step = steps.make_serve_step(tcfg, INPUT_SHAPES["decode_32k"])
    jstep = jax.jit(lambda st, tok, pos: JBB.decode_step(jparams, jcfg, st,
                                                         tok, pos))
    tokens, outs = batch["tokens"], []
    for t in range(T):
        tok = tokens[:, t:t + 1]
        lg, state = step(model, state, torch.from_numpy(tok), t)
        jlg, jstate = jstep(jstate, jnp.asarray(tok), jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), jlogits,
                               atol=5e-3, rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", VLM])
def test_long_500k_decode_matches_jax_past_the_window(arch, monkeypatch):
    """``make_serve_step(cfg, INPUT_SHAPES["long_500k"])`` against JAX's
    with ``LONG_WINDOW`` = 8 in both packages, over 24 tokens: the self
    caches are rings of 8 slots that wrap, the vlm's cross caches keep
    all 16 image tokens; logits 1e-4 of JAX's at every step, and apart
    from the unwindowed decode once past the window."""
    W = 8
    monkeypatch.setattr(JST, "LONG_WINDOW", W)
    monkeypatch.setattr(steps, "LONG_WINDOW", W)
    shape = INPUT_SHAPES["long_500k"]
    jcfg, tcfg = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    assert steps.decode_window(tcfg, shape) == W == JST.decode_window(
        jcfg, shape)
    jparams = _perturb(JBB.init_params(jax.random.PRNGKey(0), jcfg), 3)
    model = TBB.params_from_tree(tcfg, _flat(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    stub = _stub(tcfg) if tcfg.family == "vlm" else {}
    jstate = JBB.prepare_decode_state(jparams, jcfg, _jb(stub), B, T,
                                      dtype=jnp.float32, window_override=W)
    state = TBB.prepare_decode_state(model, tcfg, _tb(stub), B, T,
                                     window_override=W)
    full = TBB.prepare_decode_state(model, tcfg, _tb(stub), B, T)
    selfs = [k for k in state if k != "cross_kv"]
    for key in selfs:
        assert state[key]["k"].shape[-3] == W
        assert tuple(state[key]["slot_pos"].shape[-1:]) == (W,)
    if tcfg.family == "vlm":
        assert state["cross_kv"]["k"].shape[2] == tcfg.n_image_tokens
    step = steps.make_serve_step(tcfg, shape)
    plain_step = steps.make_serve_step(tcfg, INPUT_SHAPES["decode_32k"])
    jstep = jax.jit(JST.make_serve_step(jcfg, shape), static_argnums=())
    apart = 0.0
    for t in range(T):
        tok = tokens[:, t:t + 1]
        lg, state = step(model, state, torch.from_numpy(tok), t)
        jlg, jstate = jstep(jparams, jstate, jnp.asarray(tok), jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        lf, full = plain_step(model, full, torch.from_numpy(tok), t)
        if t < W:
            np.testing.assert_allclose(lg.numpy(), lf.numpy(), atol=1e-5,
                                       rtol=0)
        else:
            apart = max(apart, float((lg - lf).abs().max()))
    assert apart > 1e-3
    for key in selfs:      # the rings wrapped: slot t % W holds t
        sp = state[key]["slot_pos"].reshape(-1, W)
        assert (sp == torch.arange(T - W, T).roll(T % W)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_generates_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} batch=2 generated 4 tokens")
    assert out[1].startswith("sample token ids:")
    cfg = t_get_arch(arch).reduced()
    assert toks.shape == (2, 9) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


@pytest.mark.parametrize("objective", ["contrastive", "lm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_refuses_the_family(arch, objective, capsys):
    """Both families train through the step functions
    (tests/test_torch_cross_train.py), but the launcher cannot feed them:
    its datasets carry no stub inputs, as JAX's carry none (ROADMAP F6).
    Exit 2, naming F6 and the step functions."""
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--objective", objective, "--steps", "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "F6" in err and "make_lm_train_step" in err
    assert "not ported" not in err and "next slice" not in err
