"""The port's CLIP towers (``repro_torch.models``) against the JAX
package: one set of params (the JAX init, through the bridge) and the
same numpy-seeded inputs go through both, at the reduced config.
Tolerances: f32 1e-5, bf16 1e-2 (the latter on L2-normalised embeddings,
where bf16 rounding lands at different places in the two frameworks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.models import backbones as JBB
from repro.models import clip as JC
from repro.models import layers as JL
from repro.models import precision as JPR
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.models import backbones as TBB
from repro_torch.models import clip as TC
from repro_torch.models import layers as TL
from repro_torch.models import precision as TPR


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


def jax_flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_arch(ARCH).reduced()
    tcfg = t_get_arch(ARCH).reduced()
    jparams = JBB.init_params(jax.random.PRNGKey(0), jcfg)
    flat = jax_flat(jparams)
    model = TBB.params_from_tree(tcfg, {k: v for k, v in flat.items()},
                                 "cpu")
    rng = np.random.default_rng(0)
    c = tcfg.clip
    batch = {"images": rng.standard_normal(
                 (4, c.image_size, c.image_size, 3), dtype=np.float32),
             "texts": rng.integers(0, tcfg.vocab_size,
                                   (4, c.context_length)).astype(np.int32)}
    return jcfg, tcfg, jparams, flat, model, batch


def test_reduced_config_matches_jax():
    for arch in (ARCH,):
        for full in (False, True):
            j, t = j_get_arch(arch), t_get_arch(arch)
            if not full:
                j, t = j.reduced(), t.reduced()
            jd = dataclasses.asdict(j)
            for k, v in dataclasses.asdict(t).items():
                assert jd[k] == v, k


def test_bridge_roundtrip_bitwise_and_shapes(setup):
    jcfg, tcfg, _, flat, model, _ = setup
    back = {k: v.numpy() for k, v in
            flatten(bridge.model_to_tree(model)).items()}
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        assert back[k].tobytes() == flat[k].tobytes(), k
    # param_shapes: meta tensors, same keys and shapes as the JAX one
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(
                   JBB.param_shapes(jcfg))[0]}
    tshapes = flatten(TBB.param_shapes(tcfg))
    assert all(v.device.type == "meta" for v in tshapes.values())
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == jshapes


def _encode_both(setup, fn_name, impl, prec):
    jcfg, _, jparams, _, model, batch = setup
    jp = {"f32": JPR.F32, "bf16": JPR.BF16}[prec]
    tp = {"f32": TPR.F32, "bf16": TPR.BF16}[prec]
    key = "images" if fn_name == "encode_image" else "texts"
    want = getattr(JC, fn_name)(jparams, jcfg, jnp.asarray(batch[key]),
                                impl="naive", precision=jp)
    with torch.inference_mode():
        got = getattr(TC, fn_name)(model, torch.from_numpy(batch[key]),
                                   impl=impl, precision=tp)
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("fn_name", ["encode_image", "encode_text"])
def test_towers_f32_match_jax(setup, fn_name, impl):
    got, want = _encode_both(setup, fn_name, impl, "f32")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fn_name", ["encode_image", "encode_text"])
def test_towers_bf16_match_jax(setup, fn_name):
    got, want = _encode_both(setup, fn_name, "flash", "bf16")
    n = lambda e: e / np.linalg.norm(e, axis=-1, keepdims=True)  # noqa: E731
    np.testing.assert_allclose(n(got), n(want), atol=1e-2, rtol=0)


def test_encode_pair_matches_jax_flash_kernel(setup):
    """Both towers through the JAX Pallas kernel (interpret mode) and the
    port's flash path."""
    jcfg, tcfg, jparams, _, model, batch = setup
    je1, je2 = JBB.encode_pair(jparams, jcfg, {k: jnp.asarray(v) for k, v
                                               in batch.items()},
                               impl="flash")
    with torch.inference_mode():
        te1, te2 = TBB.encode_pair(model, tcfg,
                                   {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                                   impl="flash")
    np.testing.assert_allclose(te1.numpy(), np.asarray(je1), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(te2.numpy(), np.asarray(je2), atol=1e-5,
                               rtol=1e-5)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; the erf form is ~1e-3 away
    at these inputs, far outside 1e-5, so this fails if the port's MLP
    used torch's default gelu."""
    rng = np.random.default_rng(1)
    params = JL.init_gelu_mlp(jax.random.PRNGKey(2), 16, 32)
    x = rng.standard_normal((3, 16), dtype=np.float32) * 3.0
    want = np.asarray(JL.gelu_mlp(params, jnp.asarray(x)))
    mlp = TL.GeluMLP(16, 32)
    mlp.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in params.items()})
    with torch.inference_mode():
        got = mlp(torch.from_numpy(x)).numpy()
        h = torch.from_numpy(x) @ mlp.w_in + mlp.b_in
        erf_gap = (F.gelu(h) - F.gelu(h, approximate="tanh")).abs().max()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert erf_gap > 1e-4          # the two forms really differ here


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32) * 2 + 0.5
    scale = rng.standard_normal(16, dtype=np.float32)
    bias = rng.standard_normal(16, dtype=np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pos = np.tile(np.arange(5), (2, 1))
    tol = 1e-5 if dtype == "float32" else 1e-2
    pairs = [
        (JL.rmsnorm({"scale": jnp.asarray(scale)}, jx),
         TL.rmsnorm(torch.from_numpy(scale), tx)),
        (JL.layernorm({"scale": jnp.asarray(scale),
                       "bias": jnp.asarray(bias)}, jx),
         TL.layernorm(torch.from_numpy(scale), torch.from_numpy(bias), tx)),
        (JL.apply_rope(jx, jnp.asarray(pos), 1e4),
         TL.apply_rope(tx, torch.from_numpy(pos), 1e4)),
    ]
    for want, got in pairs:
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_port_init_is_seeded_and_follows_the_recipe():
    cfg = t_get_arch(ARCH).reduced()
    a = TBB.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    b = TBB.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    assert torch.all(a.text_norm.scale == 1)
    assert torch.all(a.vision.blocks[0].mlp.b_in == 0)
    w = a.vision.blocks[0].attn.wq
    assert abs(w.std().item() - w.shape[0] ** -0.5) < 0.2 * w.shape[0] ** -0.5
