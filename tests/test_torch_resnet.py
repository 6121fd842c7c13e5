"""The port's ResNet-50 tower (``repro_torch.models.resnet``) against the
JAX package's (``repro.models.resnet``), on the CPU at a narrow width:
the reduced ``clip-rn50-cc3m`` text tower with ``vision_width=16,
image_size=32, embed_dim=64`` (the stage depths (3, 4, 6, 3) stay; the
stem's GroupNorm sees C = 16 < 32 groups).  One set of params (the JAX
init, through the bridge) and the same numpy-seeded inputs go through
both.  Tolerances, those of tests/test_torch_towers.py where the depth
allows: f32 1e-5 for GroupNorm and a bottleneck, bf16 1e-2 (on
L2-normalised embeddings for the tower); XLA's ``"SAME"`` conv within
1e-6 and the max-pool exactly; a bottleneck's gradients 1e-4 relative L2
per leaf; the whole tower's f32 embeddings 1e-4 of their scale and its
gradients 1e-3 (see those tests).  Also the bridge and the checkpoints
of the ResNet CLIP under JAX's keys (``vision/stage{s}/{i}/...``), both
ways, bitwise, and the port's device policy."""
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
from repro.models import backbones as JBB
from repro.models import clip as JC
from repro.models import precision as JPR
from repro.models import resnet as JR
from repro_torch import checkpoint as TCK
from repro_torch import device as D
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.models import backbones as TBB
from repro_torch.models import clip as TC
from repro_torch.models import precision as TPR
from repro_torch.models import resnet as TR

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "helpers"))
import torch_mesh_check as H  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCH = "clip-rn50-cc3m"


def jax_flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = H.narrow_rn50(j_get_arch), H.narrow_rn50(t_get_arch)
    jparams = jax.jit(lambda k: JBB.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    flat = jax_flat(jparams)
    model = TBB.params_from_tree(tcfg, dict(flat), "cpu")
    images = np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3), dtype=np.float32)
    return jcfg, tcfg, jparams, flat, model, images


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_same_padding_matches_lax(k, stride, n):
    rng = np.random.default_rng(k * 100 + stride * 10 + n)
    x = rng.standard_normal((2, n, n, 5), dtype=np.float32)
    w = (rng.standard_normal((k, k, 5, 4), dtype=np.float32)
         / np.sqrt(k * k * 5)).astype(np.float32)
    want = np.asarray(JR.conv(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = nhwc(TR.conv(nchw(x), torch.from_numpy(w), stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_stem_padding_is_asymmetric():
    """The cases XLA pads asymmetrically, where ``padding=k//2`` differs."""
    assert TR.same_pads(224, 7, 2) == (2, 3)
    assert TR.same_pads(112, 3, 2) == (0, 1)
    assert TR.same_pads(56, 3, 1) == (1, 1)
    assert TR.same_pads(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("n", [8, 9, 16])
def test_max_pool_matches_lax_reduce_window(n):
    x = np.random.default_rng(n).standard_normal((2, n, n, 3),
                                                 dtype=np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = nhwc(TR.max_pool(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_max_pool_pads_with_minus_inf():
    """All-negative input: zero padding would put 0 in the edge windows."""
    x = -1.0 - np.random.default_rng(1).random((1, 4, 4, 2),
                                               dtype=np.float32)
    got = nhwc(TR.max_pool(nchw(x)))
    assert (got < 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 64, 256])
def test_groupnorm_matches_jax(c, dtype):
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((2, 5, 6, c), dtype=np.float32) * 3 + 1)
    scale = rng.standard_normal(c, dtype=np.float32)
    bias = rng.standard_normal(c, dtype=np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JR.groupnorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)},
                        jnp.asarray(x).astype(jdt))
    got = TR.groupnorm(torch.from_numpy(scale), torch.from_numpy(bias),
                       nchw(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("cin,cmid,stride", [(64, 16, 1), (16, 16, 2)])
def test_bottleneck_matches_jax(cin, cmid, stride):
    """(64, 16, 1): the identity shortcut; (16, 16, 2): ``down``."""
    jp = JR.init_bottleneck(jax.random.PRNGKey(cin + stride), cin, cmid,
                            stride)
    blk = TR.Bottleneck(cin, cmid, stride)
    assert blk.project == ("down" in jp)
    blk.load_state_dict({k.replace("/", "."): torch.tensor(v)
                         for k, v in jax_flat(jp).items()}, strict=True)
    x = np.random.default_rng(cin).standard_normal((2, 8, 8, cin),
                                                   dtype=np.float32)
    want = np.asarray(JR.apply_bottleneck(jp, jnp.asarray(x), stride))
    with torch.no_grad():
        got = nhwc(blk(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The tower
# ---------------------------------------------------------------------------

def test_tower_f32_matches_jax(setup):
    """Within 1e-4 of the embeddings' largest entry, not the 2-layer
    ViT's 1e-5: each of the 16 bottlenecks (three GroupNorms each) adds
    ~1e-6 of relative f32 rounding drift, and JAX's own f32 tower lands
    2.4e-5 to 7.3e-5 of that scale from a float64 evaluation of the same
    params (three seeds), so no two f32 evaluations of the full depth
    agree to 1e-5.  The pieces hold 1e-6 / 1e-5 above."""
    jcfg, _, jparams, _, model, images = setup
    want = np.asarray(jax.jit(lambda p, x: JC.encode_image(p, jcfg, x))(
        jparams, jnp.asarray(images)))
    with torch.no_grad():
        got = TC.encode_image(model, torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_tower_bf16_matches_jax(setup):
    jcfg, _, jparams, _, model, images = setup
    # eagerly: under jit, XLA's CPU backend keeps some of the bf16
    # intermediates in f32, which lands 8e-2 away on this depth
    want = np.asarray(JC.encode_image(jparams, jcfg, jnp.asarray(images),
                                      precision=JPR.BF16))
    with torch.no_grad():
        got = TC.encode_image(model, torch.from_numpy(images),
                              precision=TPR.BF16)
    assert got.dtype == torch.float32
    n = lambda e: e / np.linalg.norm(e, axis=-1, keepdims=True)  # noqa: E731
    np.testing.assert_allclose(n(got.numpy()), n(want), atol=1e-2, rtol=0)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_tower_gradients_match_jax(setup):
    """Every leaf within 1e-3 relative L2, not 1e-4: JAX's own f32
    gradients of this tower are 3.0e-4 to 4.1e-4 (worst leaf) from a
    float64 evaluation of the same function over three seeds, the port's
    1.6e-4 to 3.1e-4; the f32 drift grows with depth (16 bottlenecks).
    One bottleneck's gradients hold 1e-4 (the next test)."""
    jcfg, _, jparams, _, model, images = setup
    r = np.random.default_rng(5).standard_normal((3, 64), dtype=np.float32)

    def loss(vision):
        p = {**jparams, "vision": vision}
        return jnp.sum(JC.encode_image(p, jcfg, jnp.asarray(images))
                       * jnp.asarray(r))

    want = jax_flat(jax.jit(jax.grad(loss))(jparams["vision"]))
    model.zero_grad()
    (TC.encode_image(model, torch.from_numpy(images))
     * torch.from_numpy(r)).sum().backward()
    got = {k: v.numpy() for k, v in flatten(bridge.named_to_tree(
        model.vision, {n: p.grad for n, p in
                       model.vision.named_parameters()})).items()}
    model.zero_grad()
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= 1e-3, (k, _rel_l2(got[k],
                                                             want[k]))


@pytest.mark.parametrize("cin,cmid,stride", [(64, 16, 1), (16, 16, 2)])
def test_bottleneck_gradients_match_jax(cin, cmid, stride):
    """Gradients of every leaf of one block and of its input, 1e-4
    relative L2."""
    jp = JR.init_bottleneck(jax.random.PRNGKey(cin + stride), cin, cmid,
                            stride)
    blk = TR.Bottleneck(cin, cmid, stride)
    blk.load_state_dict({k.replace("/", "."): torch.tensor(v)
                         for k, v in jax_flat(jp).items()}, strict=True)
    rng = np.random.default_rng(cin + 1)
    x = rng.standard_normal((2, 8, 8, cin), dtype=np.float32)
    out_hw = 8 // stride
    r = rng.standard_normal((2, out_hw, out_hw, 4 * cmid), dtype=np.float32)
    gp, gx = jax.grad(lambda p, x: jnp.sum(JR.apply_bottleneck(p, x, stride)
                                           * jnp.asarray(r)),
                      argnums=(0, 1))(jp, jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    (blk(xt) * nchw(r)).sum().backward()
    assert _rel_l2(nhwc(xt.grad), np.asarray(gx)) <= 1e-4
    got = {n.replace(".", "/"): p.grad.numpy()
           for n, p in blk.named_parameters()}
    want = jax_flat(gp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= 1e-4, k


def test_impl_does_not_reach_the_resnet(setup):
    _, _, _, _, model, images = setup
    with torch.no_grad():
        outs = [TC.encode_image(model, torch.from_numpy(images), impl=impl)
                for impl in ("flash", "naive", "chunked")]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


# ---------------------------------------------------------------------------
# Bridge and checkpoints under JAX's keys
# ---------------------------------------------------------------------------

def test_flatten_unflatten_keep_lists_in_jax_order():
    """Lists flatten under their indices in index order (JAX's tree
    order, ``_path_str``) and come back as lists."""
    tree = {"b": [np.zeros(1), {"x": np.ones(2)}] + [np.full(1, i)
                                                      for i in range(10)],
            "a": {"0": np.zeros(3), "k": np.zeros(1)}}
    flat = TCK.flatten(tree)
    want = [_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        tree)[0]]
    assert list(flat) == want
    back = TCK.unflatten(flat)
    assert isinstance(back["b"], list) and len(back["b"]) == 12
    assert isinstance(back["a"], dict)       # keys other than 0..n-1
    assert back["b"][11][0] == 9


def test_bridge_keeps_stages_as_lists(setup):
    jcfg, tcfg, jparams, flat, model, _ = setup
    tree = bridge.model_to_tree(model)
    assert isinstance(tree["vision"]["stage2"], list)
    assert len(tree["vision"]["stage2"]) == 6
    assert "down" in tree["vision"]["stage0"][0]
    assert "down" not in tree["vision"]["stage0"][1]
    back = {k: v.numpy() for k, v in flatten(tree).items()}
    assert list(back) == list(flat)          # JAX's key order too
    for k in flat:
        assert back[k].tobytes() == flat[k].tobytes(), k
    shapes = flatten(TBB.param_shapes(tcfg))
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(
                   JBB.param_shapes(jcfg))[0]}
    assert {k: tuple(v.shape) for k, v in shapes.items()} == jshapes
    # the JAX tree itself (lists, not dicts of indices) loads as is
    m2 = TBB.params_from_tree(tcfg, jax.tree.map(np.asarray, jparams),
                              "cpu")
    assert all(torch.equal(a, b) for a, b in zip(m2.parameters(),
                                                 model.parameters()))


def test_jax_checkpoint_restores_in_port_and_back(tmp_path, setup):
    jcfg, tcfg, jparams, flat, _, _ = setup
    JCK.save(str(tmp_path / "j"), {"params": jax.tree.map(
        np.asarray, jparams)}, 4, {"arch": ARCH})
    got, step, _ = TCK.restore_subtree(str(tmp_path / "j"),
                                       TBB.param_shapes(tcfg), "params")
    assert step == 4 and isinstance(got["vision"]["stage1"], list)
    model = TBB.params_from_tree(tcfg, got, "cpu")
    assert torch.equal(model.vision.stage1[0].down,
                       torch.tensor(flat["vision/stage1/0/down"]))
    TCK.save(str(tmp_path / "t"), {"params": bridge.model_to_tree(model)},
             5, {"arch": ARCH})
    back, step, _ = JCK.restore_subtree(str(tmp_path / "t"),
                                        JBB.param_shapes(jcfg), "params")
    assert step == 5
    back = jax_flat(back)
    assert list(back) == list(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        assert back[k].tobytes() == flat[k].tobytes(), k


def test_train_state_round_trips_bitwise(setup):
    """The AdamW state of the ResNet CLIP: the JAX init's tree into the
    port's state and back out, every leaf bitwise."""
    from repro.core import fastclip as JFC
    from repro.core import train_step as JTS
    from repro.core.schedules import lr_warmup_cosine as j_lr
    from repro.optim import adamw as j_adamw
    from repro_torch.core import fastclip as TFC
    from repro_torch.core import train_step as TTS
    from repro_torch.core.schedules import lr_warmup_cosine as t_lr
    from repro_torch.optim import adamw as t_adamw
    jcfg, tcfg = setup[:2]
    jtc = JTS.TrainStepConfig(arch=jcfg, fc=JFC.FastCLIPConfig(n_samples=8),
                              optimizer=j_adamw(), lr_fn=j_lr(1e-3, 1, 4))
    ttc = TTS.TrainStepConfig(arch=tcfg, fc=TFC.FastCLIPConfig(n_samples=8),
                              optimizer=t_adamw(), lr_fn=t_lr(1e-3, 1, 4))
    js = jax.tree.map(np.asarray, jax.jit(
        lambda k: JTS.init_train_state(k, jtc))(jax.random.PRNGKey(3)))
    # distinct moments, so that a swapped leaf shows
    rng = np.random.default_rng(0)
    js["opt"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype)
        if a.ndim else a, js["opt"])
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), ttc, "cpu")
    ts = bridge.state_from_tree(ts, js)
    want = jax_flat(js)
    got = {k: np.asarray(v) for k, v in flatten(
        bridge.state_to_tree(ts)).items()}
    assert sorted(got) == sorted(want)
    assert any(k.startswith("opt/m/vision/stage3/2/") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# The device policy
# ---------------------------------------------------------------------------

def test_numerics_policy_sets_the_four_flags():
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (
        torch.backends.cudnn, "allow_tf32"), (
        torch.backends.cudnn, "deterministic"), (
        torch.backends.cudnn, "benchmark")
    before = [getattr(m, a) for m, a in flags]
    try:
        for m, a in flags:        # the opposite of the policy
            setattr(m, a, a in ("allow_tf32", "benchmark"))
        D.set_numerics_policy()
        assert [getattr(m, a) for m, a in flags] == [False, False, True,
                                                     False]
    finally:
        for (m, a), v in zip(flags, before):
            setattr(m, a, v)
