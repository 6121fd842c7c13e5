"""The port's hybrid LM (``zamba2-1.2b``: Mamba2 layers plus one shared
attention block) on the CPU against the JAX package: one set of params
(the JAX init, through the bridge) and the same numpy-seeded tokens go
through both, at the reduced config and at ``reduced().replace(n_layers=
3)`` (the only small config with a ``tail``).  Tolerances (f32): the
whole model's final hidden states and logits 1e-4 (each module alone is
held to 1e-5 in ``tests/test_torch_ssm.py``); decode vs teacher-forced
forward 5e-3 (``tests/test_decode_equivalence.py``)."""
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
from repro_torch.kernels import ssd_chunk as K4
from repro_torch.launch import serve, steps
from repro_torch.models import backbones as TBB
from repro_torch.models import ssm as TS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

ARCH = "zamba2-1.2b"
B, T = 2, 24
CASES = ["reduced", "tail"]


def _cfgs(case):
    j, t = j_get_arch(ARCH).reduced(), t_get_arch(ARCH).reduced()
    if case == "tail":
        j, t = j.replace(n_layers=3), t.replace(n_layers=3)
    return j, t


def _flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=CASES)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = JBB.init_params(jax.random.PRNGKey(0), jcfg)
    flat = _flat(jparams)
    model = TBB.params_from_tree(tcfg, flat, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    want = (np.asarray(JBB.forward_hidden(jparams, jcfg, jb, impl="naive")[0]),
            np.asarray(JBB.prefill_logits(jparams, jcfg, jb, impl="naive")))
    return jcfg, tcfg, jparams, flat, model, tokens, want


def test_bridge_roundtrip_bitwise_nested_stacks(setup):
    jcfg, tcfg, _, flat, model, _, _ = setup
    back = {k: v.numpy() for k, v in
            flatten(bridge.model_to_tree(model)).items()}
    assert sorted(back) == sorted(flat)
    assert flat["supers/mambas/w_in"].shape[:2] == (1, 2)
    assert ("tail/w_in" in flat) == (tcfg.n_layers == 3)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        assert back[k].tobytes() == flat[k].tobytes(), k
    # each layer's leaf is its slice of the stacked array
    np.testing.assert_array_equal(
        model.supers[0].mambas[1].w_in.detach().numpy(),
        flat["supers/mambas/w_in"][0, 1])


def test_full_width_structure_matches_jax_param_shapes():
    """zamba2-1.2b at full width on the meta device: the JAX leaf paths
    and shapes, 1,171,784,576 parameters."""
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(
                   JBB.param_shapes(j_get_arch(ARCH)))[0]}
    tshapes = flatten(TBB.param_shapes(t_get_arch(ARCH)))
    assert all(v.device.type == "meta" for v in tshapes.values())
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == jshapes
    assert jshapes["supers/mambas/w_in"] == (6, 6, 2048, 8384)
    assert jshapes["tail/w_in"] == (2, 2048, 8384)
    assert sum(int(np.prod(s)) for s in jshapes.values()) == 1_171_784_576


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


def test_flash_routes_every_layer_through_the_kernel_wrappers(setup,
                                                              monkeypatch):
    """impl="flash" sends each Mamba2 layer to the K4 wrapper and each
    shared-block call to the K3 wrapper (on the CPU the wrappers run
    their plain versions); the plain impls reach neither."""
    _, tcfg, _, _, model, tokens, _ = setup
    calls = {"ssd": 0, "attn": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(TS, "ssd_chunk", count("ssd", K4.ssd_chunk))
    monkeypatch.setattr("repro_torch.models.attention.flash_mha",
                        count("attn", FA.flash_mha))
    n_super = tcfg.n_layers // tcfg.hybrid_attn_every
    tb = {"tokens": torch.from_numpy(tokens)}
    for impl, want in (("flash", (tcfg.n_layers, n_super)),
                       ("chunked", (0, 0))):
        calls.update(ssd=0, attn=0)
        steps.make_prefill_step(tcfg, impl=impl)(model, tb)
        assert (calls["ssd"], calls["attn"]) == want, impl


def test_decode_step_matches_jax_and_forward(setup):
    jcfg, tcfg, jparams, _, model, tokens, _ = setup
    jstate = JBB.prepare_decode_state(jparams, jcfg, {}, B, T,
                                      dtype=jnp.float32)
    state = TBB.prepare_decode_state(model, tcfg, {}, B, T)
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


def test_serve_cli_generates_on_cpu(capsys):
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=zamba2-1.2b batch=2 generated 4 tokens")
    assert out[1].startswith("sample token ids:")
    cfg = t_get_arch(ARCH).reduced()
    assert toks.shape == (2, 9) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ["clip-vitb32-cc12m"])
def test_serve_cli_refuses_other_families(arch, capsys):
    """A CLIP setting, the one family without a decode path, exits 2
    naming the embedding service (the xLSTM decodes since it was ported:
    tests/test_torch_xlstm.py)."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert e.value.code == 2
    assert "serve_embed" in capsys.readouterr().err


def test_other_families_and_missing_card_raise():
    cfg = t_get_arch("clip-vitb32-cc12m")
    with pytest.raises(NotImplementedError, match="has no such path"):
        TBB.init_decode_state(cfg, 1, 8, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TBB.init_decode_state(t_get_arch(ARCH).reduced(), 1, 8)
