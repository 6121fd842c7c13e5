"""The port's MoE LMs (``qwen3-moe-30b-a3b``: 128 experts top-8 in every
layer; ``llama4-scout-17b-a16e``: 16 experts top-1 and a shared expert
every other layer, a dense block between) served on the CPU against the
JAX package.  One set of params (the JAX init, through the bridge, with
the qk-norm scales drawn at random so that they count) and the same
numpy-seeded tokens go through both, at the reduced configs.
Tolerances (f32): the final hidden states and logits 1e-4 (as
``tests/test_torch_dense.py``), the aux losses rtol 1e-5 (as
``tests/test_torch_moe.py``); decode vs JAX's decode 1e-4; decode vs
teacher-forced forward 5e-3 at capacity factor 64, where nothing is
dropped (``tests/test_decode_equivalence.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.models import backbones as JBB
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve, steps
from repro_torch.models import backbones as TBB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite's workers
    share the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
FULL_PARAMS = {"qwen3-moe-30b-a3b": 30_534_055_936,
               "llama4-scout-17b-a16e": 59_454_485_504}
B, T = 2, 24


def _flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(tree, seed):
    """Non-unit qk-norm scales (JAX's init sets ones, which would hide
    them)."""
    rng = np.random.default_rng(seed)

    def one(path, v):
        if _path_str(path).endswith(("q_norm/scale", "k_norm/scale")):
            return v * (1.0 + 0.5 * rng.standard_normal(v.shape,
                                                         dtype=np.float32))
        return v
    return jax.tree_util.tree_map_with_path(one, tree)


def _no_drops(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=64.0))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = j_get_arch(request.param).reduced()
    tcfg = t_get_arch(request.param).reduced()
    jparams = _perturb(JBB.init_params(jax.random.PRNGKey(0), jcfg), 3)
    flat = _flat(jparams)
    model = TBB.params_from_tree(tcfg, flat, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    jh, jaux = JBB.forward_hidden(jparams, jcfg, jb, impl="naive")
    want = (np.asarray(jh), {k: float(v) for k, v in jaux.items()},
            np.asarray(JBB.prefill_logits(jparams, jcfg, jb, impl="naive")))
    return jcfg, tcfg, jparams, flat, model, tokens, want


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    """Every field of the port's config (full and reduced) equals the JAX
    config's field of that name, ``moe`` included; the JAX fields the
    port lacks are those of families it does not port."""
    j, t = j_get_arch(arch), t_get_arch(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        for f in dataclasses.fields(tc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if dataclasses.is_dataclass(b):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name, a, b)
        assert tc.family == "moe" and tc.padded_vocab == jc.padded_vocab
    assert t.resolved_head_dim == 128


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_structure_matches_jax_param_shapes(arch):
    """The meta model at full width: JAX's leaf paths and shapes (the
    expert stacks (n_super, E, in, out)), and JAX's parameter count."""
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(
                   JBB.param_shapes(j_get_arch(arch)))[0]}
    tshapes = flatten(TBB.param_shapes(t_get_arch(arch)))
    assert all(v.device.type == "meta" for v in tshapes.values())
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == jshapes
    assert sum(int(np.prod(s)) for s in jshapes.values()) == \
        FULL_PARAMS[arch]
    cfg = t_get_arch(arch)
    n_super, m = cfg.n_layers // cfg.moe.every, cfg.moe
    assert jshapes["supers/moe/w_gate"] == (n_super, m.n_experts,
                                            cfg.d_model, m.d_ff)
    assert ("supers/dense_blk/mlp/w_up" in jshapes) == (m.every == 2)
    assert ("supers/moe/shared/w_up" in jshapes) == m.shared_expert
    assert "supers/attn_blk/n2/scale" in jshapes
    assert not any(k.startswith("supers/attn_blk/mlp") for k in jshapes)


def test_bridge_roundtrip_bitwise_both_ways(setup):
    """JAX tree -> port model -> JAX tree, and a port-initialised model
    -> tree -> model, bit for bit; the nested stacks keep JAX's paths."""
    _, tcfg, _, flat, model, _, _ = setup
    back = {k: v.numpy() for k, v in
            flatten(bridge.model_to_tree(model)).items()}
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        assert back[k].tobytes() == flat[k].tobytes(), k
    np.testing.assert_array_equal(
        model.supers[0].moe.w_down.detach().numpy(),
        flat["supers/moe/w_down"][0])
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
    _, tcfg, _, _, model, tokens, (jh, jaux, want) = setup
    tb = {"tokens": torch.from_numpy(tokens)}
    with torch.inference_mode():
        th, aux = TBB.forward_hidden(model, tcfg, tb, impl=impl)
        got = steps.make_prefill_step(tcfg, impl=impl)(model, tb)
    assert sorted(aux) == ["moe_lb", "moe_z"]
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), jaux[k], rtol=1e-5)
    assert got.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(th.numpy(), jh, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_flash_routes_every_attention_block_through_the_kernel_wrapper(
        setup, monkeypatch):
    """impl="flash" sends each attention block (the dense block's too)
    to the K3 wrapper exactly once per prefill; the plain impls never
    reach it."""
    _, tcfg, _, _, model, tokens, _ = setup
    calls = []

    def count(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return FA.flash_mha(q, k, v, **kw)
    monkeypatch.setattr("repro_torch.models.attention.flash_mha", count)
    tb = {"tokens": torch.from_numpy(tokens)}
    n_super = tcfg.n_layers // tcfg.moe.every
    blocks = n_super * (2 if tcfg.moe.every == 2 else 1)
    for impl, want in (("flash", blocks), ("chunked", 0), ("naive", 0)):
        calls.clear()
        steps.make_prefill_step(tcfg, impl=impl)(model, tb)
        assert len(calls) == want, impl
        assert set(calls) <= {(B, T, tcfg.n_heads, tcfg.resolved_head_dim)}


def test_decode_step_matches_jax_and_forward(setup):
    """Decode against JAX's decode at the config's capacity (decode's
    capacity is 1 whatever the factor), then against the teacher-forced
    forward at capacity factor 64 (no drops)."""
    jcfg, tcfg, jparams, _, model, tokens, _ = setup
    jstate = JBB.prepare_decode_state(jparams, jcfg, {}, B, T,
                                      dtype=jnp.float32)
    state = TBB.prepare_decode_state(model, tcfg, {}, B, T)
    n_super = tcfg.n_layers // tcfg.moe.every
    assert sorted(state) == sorted(jstate)
    assert tuple(state["moe_kv"]["k"].shape) == (
        n_super, B, T, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    step = steps.make_serve_step(tcfg, INPUT_SHAPES["decode_32k"])
    jstep = jax.jit(lambda st, tok, pos: JBB.decode_step(jparams, jcfg, st,
                                                         tok, pos))
    for t in range(T):
        tok = tokens[:, t:t + 1]
        lg, state = step(model, state, torch.from_numpy(tok), t)
        jlg, jstate = jstep(jstate, jnp.asarray(tok), jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
    wide = _no_drops(tcfg)
    state = TBB.prepare_decode_state(model, wide, {}, B, T)
    outs = []
    with torch.inference_mode():
        for t in range(T):
            lg, state = TBB.decode_step(model, wide, state,
                                        torch.from_numpy(tokens[:, t:t + 1]),
                                        t)
            outs.append(lg)
        h, _ = TBB.forward_hidden(model, wide,
                                  {"tokens": torch.from_numpy(tokens)})
        fwd = TBB.logits_from_hidden(model, wide, h)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               atol=5e-3, rtol=0)


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
