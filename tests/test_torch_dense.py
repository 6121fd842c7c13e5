"""The port's dense LMs (``qwen3-1.7b``, ``yi-6b``, ``granite-3-8b``,
``qwen1.5-32b``) on the CPU against the JAX package.  One set of params
(the JAX init, through the bridge, with the qk-norm scales and the QKV
biases drawn at random so that both count) and the same numpy-seeded
tokens go through both packages, at three small configs: reduced
qwen3-1.7b (qk-norm, GQA, tied embeddings), reduced qwen1.5-32b (QKV
bias, untied head) and reduced qwen3-1.7b at head dim 128 (the head dim
of every full-width dense config; the JAX flash kernel takes any head
dim, and the port's kernel wrapper runs its plain version here).
Tolerances (f32): one attention layer 1e-5; the whole model's final
hidden states and logits 1e-4 (as ``tests/test_torch_hybrid.py``);
decode vs teacher-forced forward 5e-3 (``tests/test_decode_equivalence.py``);
K3's plain version against the Pallas kernel in interpret mode 1e-5
(``tests/test_precision_flash.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.kernels import flash_attention as JFA
from repro.models import attention as JA
from repro.models import backbones as JBB
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as TA
from repro_torch.models import backbones as TBB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ["qwen3-1.7b", "yi-6b", "granite-3-8b", "qwen1.5-32b"]
FULL_PARAMS = {"qwen3-1.7b": 1_722_147_840, "yi-6b": 6_063_394_816,
               "granite-3-8b": 8_174_243_840,
               "qwen1.5-32b": 35_199_980_544}
B, T = 2, 24
CASES = ["qwen3", "qwen1p5", "qwen3_hd128"]


def _cfgs(case):
    arch = "qwen1.5-32b" if case == "qwen1p5" else "qwen3-1.7b"
    j, t = j_get_arch(arch).reduced(), t_get_arch(arch).reduced()
    if case == "qwen3_hd128":
        j, t = j.replace(head_dim=128), t.replace(head_dim=128)
    return j, t


def _flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(tree, seed):
    """Non-unit qk-norm scales and non-zero QKV biases (JAX's init sets
    ones and zeros, which would hide both)."""
    rng = np.random.default_rng(seed)

    def one(path, v):
        name = _path_str(path)
        if name.endswith(("q_norm/scale", "k_norm/scale")):
            return v * (1.0 + 0.5 * rng.standard_normal(v.shape,
                                                         dtype=np.float32))
        if name.endswith(("attn/bq", "attn/bk", "attn/bv")):
            return v + 0.1 * rng.standard_normal(v.shape, dtype=np.float32)
        return v
    return jax.tree_util.tree_map_with_path(one, tree)


@pytest.fixture(scope="module", params=CASES)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = _perturb(JBB.init_params(jax.random.PRNGKey(0), jcfg), 3)
    flat = _flat(jparams)
    model = TBB.params_from_tree(tcfg, flat, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    want = (np.asarray(JBB.forward_hidden(jparams, jcfg, jb, impl="naive")[0]),
            np.asarray(JBB.prefill_logits(jparams, jcfg, jb, impl="naive")))
    return jcfg, tcfg, jparams, flat, model, tokens, want


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    """Every field of the port's config (full and reduced) equals the JAX
    config's field of that name; the JAX fields the port lacks are those
    of families it does not port (all at their defaults here)."""
    j, t = j_get_arch(arch), t_get_arch(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        for f in dataclasses.fields(tc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if dataclasses.is_dataclass(b):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name, a, b)
        assert tc.family == "dense" and tc.resolved_head_dim == \
            jc.resolved_head_dim
        assert tc.padded_vocab == jc.padded_vocab
    assert t.resolved_head_dim == 128


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_structure_matches_jax_param_shapes(arch):
    """The meta model at full width: JAX's leaf paths and shapes, and
    JAX's parameter count."""
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(
                   JBB.param_shapes(j_get_arch(arch)))[0]}
    tshapes = flatten(TBB.param_shapes(t_get_arch(arch)))
    assert all(v.device.type == "meta" for v in tshapes.values())
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == jshapes
    assert sum(int(np.prod(s)) for s in jshapes.values()) == \
        FULL_PARAMS[arch]
    cfg = t_get_arch(arch)
    assert ("blocks/attn/q_norm/scale" in jshapes) == cfg.qk_norm
    assert ("blocks/attn/bq" in jshapes) == cfg.qkv_bias
    assert ("lm_head" in jshapes) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("hd,n_kv", [(128, 2), (16, 4)])
@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_attention_with_qk_norm_and_bias_matches_jax(impl, hd, n_kv):
    """One layer with qk-norm and QKV bias, its norm scales and biases
    drawn at random: the forward against ``A.attention`` (naive) and
    five decode steps against ``decode_attention``, 1e-5."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=n_kv, head_dim=hd,
              qk_norm=True, qkv_bias=True, rope_theta=1e6, causal=True,
              q_chunk=8, kv_chunk=16)
    spec_j, spec_t = JA.AttnSpec(**kw), TA.AttnSpec(**kw)
    params = _perturb({"attn": JA.init_attention(jax.random.PRNGKey(5),
                                                 spec_j)}, 9)["attn"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 33, 64), dtype=np.float32) * 0.5
    mod = TA.Attention(spec_t)
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v))
                         for k, v in _flat(params).items()})
    assert float(mod.q_norm.scale.detach().std()) > 0.1 and float(
        mod.bq.detach().abs().max()) > 0.1
    want = JA.attention(params, spec_j, jnp.asarray(x), impl="naive")
    with torch.inference_mode():
        got = mod(torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if impl != "naive":
        return
    jcache = JA.init_kv_cache(spec_j, 2, 8, jnp.float32)
    cache = TA.init_kv_cache(spec_t, 2, 8, torch.float32)
    for pos in range(5):
        xt = x[:, pos:pos + 1]
        jout, jcache = JA.decode_attention(params, spec_j, jcache,
                                           jnp.asarray(xt), jnp.int32(pos))
        with torch.inference_mode():
            out, cache = mod.decode(cache, torch.from_numpy(xt), pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out.numpy(), np.asarray(want)[:, pos:pos
                                                                 + 1],
                                   atol=1e-5, rtol=0)


def test_bridge_roundtrip_bitwise_both_ways(setup):
    """JAX tree -> port model -> JAX tree, and a port-initialised model
    -> tree -> model, bit for bit; the tree has JAX's paths."""
    _, tcfg, _, flat, model, _, _ = setup
    back = {k: v.numpy() for k, v in
            flatten(bridge.model_to_tree(model)).items()}
    assert sorted(back) == sorted(flat)
    assert flat["blocks/attn/wq"].shape[0] == tcfg.n_layers
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        assert back[k].tobytes() == flat[k].tobytes(), k
    np.testing.assert_array_equal(model.blocks[1].attn.wk.detach().numpy(),
                                  flat["blocks/attn/wk"][1])
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
    _, tcfg, _, _, model, tokens, (jh, want) = setup
    tb = {"tokens": torch.from_numpy(tokens)}
    with torch.inference_mode():
        th, aux = TBB.forward_hidden(model, tcfg, tb, impl=impl)
        got = steps.make_prefill_step(tcfg, impl=impl)(model, tb)
    assert aux == {} and got.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(th.numpy(), jh, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_flash_routes_every_layer_through_the_kernel_wrapper(setup,
                                                             monkeypatch):
    """impl="flash" sends each layer's attention to the K3 wrapper exactly
    once (on the CPU the wrapper runs its plain version); the plain
    impls never reach it."""
    _, tcfg, _, _, model, tokens, _ = setup
    calls = []

    def count(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return FA.flash_mha(q, k, v, **kw)
    monkeypatch.setattr("repro_torch.models.attention.flash_mha", count)
    tb = {"tokens": torch.from_numpy(tokens)}
    hd = tcfg.resolved_head_dim
    for impl, want in (("flash", tcfg.n_layers), ("chunked", 0),
                       ("naive", 0)):
        calls.clear()
        steps.make_prefill_step(tcfg, impl=impl)(model, tb)
        assert len(calls) == want, impl
        assert set(calls) <= {(B, T, tcfg.n_heads, hd)}


def test_decode_step_matches_jax_and_forward(setup):
    jcfg, tcfg, jparams, _, model, tokens, _ = setup
    jstate = JBB.prepare_decode_state(jparams, jcfg, {}, B, T,
                                      dtype=jnp.float32)
    state = TBB.prepare_decode_state(model, tcfg, {}, B, T)
    assert tuple(state["kv"]["k"].shape) == (
        tcfg.n_layers, B, T, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    step = steps.make_serve_step(tcfg, INPUT_SHAPES["decode_32k"])
    jstep = jax.jit(lambda st, tok, pos: JBB.decode_step(jparams, jcfg, st,
                                                         tok, pos))
    outs = []
    for t in range(T):
        tok = tokens[:, t:t + 1]
        lg, state = step(model, state, torch.from_numpy(tok), t)
        jlg, jstate = jstep(jstate, jnp.asarray(tok), jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        outs.append(lg)
    with torch.inference_mode():
        h, _ = TBB.forward_hidden(model, tcfg,
                                  {"tokens": torch.from_numpy(tokens)})
        fwd = TBB.logits_from_hidden(model, tcfg, h)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               atol=5e-3, rtol=0)


def test_serve_cli_default_arch_generates_on_cpu(capsys):
    """No ``--arch``: qwen3-1.7b, as the JAX launcher's default."""
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-1.7b batch=2 generated 4 tokens")
    assert out[1].startswith("sample token ids:")
    cfg = t_get_arch("qwen3-1.7b").reduced()
    assert toks.shape == (2, 9) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


@pytest.mark.parametrize("objective", ["contrastive", "lm"])
def test_train_launcher_refuses_a_dense_arch(objective, capsys):
    """The launcher refused a dense arch until dense training was ported;
    it now trains reduced qwen3-1.7b for one step under either objective
    (tests/test_torch_dense_train.py holds the training to JAX's)."""
    state = train.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                        "cpu", "--objective", objective, "--steps", "1",
                        "--log-every", "1", "--seq-len", "16",
                        "--global-batch", "2", "--n-samples", "4"])
    out = capsys.readouterr().out
    assert isinstance(state["params"], TBB.DenseLM)
    assert int(state["step"]) == 1
    assert out.count("step     0 epoch 0 {") == 1
    assert ("retrieval accuracy: " in out) == (objective == "contrastive")
    assert sorted(state) == (["opt", "params", "step"] if objective == "lm"
                             else ["fc", "opt", "params", "step"])


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (80, 80, True, 0),      # causal, ragged against the 64-key tile
    (100, 100, True, 30),   # sliding window across tiles
    (37, 77, False, 0),     # Sq != Sk, both ragged
])
def test_flash_plain_at_head_dim_128_matches_jax_kernel(Sq, Sk, causal,
                                                        window):
    """K3's plain version at hd 128 against the Pallas kernel (interpret
    mode) and the naive oracle, f32, 1e-5."""
    rng = np.random.default_rng(Sq + Sk + window)
    q, k, v = (rng.standard_normal((1, 2, S, 128), dtype=np.float32)
               for S in (Sq, Sk, Sk))
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, window=window)
    want = JFA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    naive = JA.naive_attention(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                                 for a in (q, k, v)), causal=causal,
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(naive).transpose(
        0, 2, 1, 3), atol=1e-5, rtol=0)
    FA.check_inputs(*(torch.from_numpy(a) for a in (q, k, v, q)))
