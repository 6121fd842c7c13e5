"""The port's training step (``repro_torch.core.train_step``) against the
JAX package's at the reduced ``clip-vitb32-cc12m``: the same initial
state (the JAX init through the bridge), the same ``ContrastiveDataset``
batches and indices.  The port runs ``impl="flash"``/``loss_impl=
"fused"`` on CPU tensors (the kernels' plain versions); JAX its default
chunked/dense path.  Step-1 gradients of every leaf: relative L2 error
<= 1e-4, and elementwise rtol 1e-4 with atol 1e-5 times the leaf's
largest entry (f32 summation order moves entries near zero of a leaf
with O(1) gradients by a few 1e-6 of its scale); loss, loss value and
tau over 3 steps rtol 1e-4, the touched log-u rows rtol 1e-4 / atol 1e-5
(log domain: absolute 1e-5 is relative 1e-5 in u); params after 3 steps atol 5e-5 (same math, other summation order).
Also: the bitwise no-op of a NaN step under the guard and f32 masters
under bf16.  The mesh step is tested in tests/test_torch_mesh*.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.core import fastclip as JFC
from repro.core import losses as JLS
from repro.core import train_step as JTS
from repro.core.schedules import lr_warmup_cosine as j_lr
from repro.data import ContrastiveDataset as JCD
from repro.data import ShardedLoader as JSL
from repro.models import backbones as JBB
from repro.optim import get_optimizer as j_opt
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import fastclip as TFC
from repro_torch.core import train_step as TTS
from repro_torch.core.schedules import lr_warmup_cosine as t_lr
from repro_torch.data import ContrastiveDataset as TCD
from repro_torch.data import ShardedLoader as TSL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gcl_loss as GL
from repro_torch.optim import get_optimizer as t_opt


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
N, GB = 32, 16


def jax_flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def configs(version, optimizer="adamw", precision=None, guard=False):
    kw = dict(version=version, n_samples=N, steps_per_epoch=N // GB,
              gamma_decay_epochs=1, tau_init=0.07 if version == "v3" else
              0.03, lr_tau=2e-4 if version == "v3" else 1e-2, rho=6.5)
    jc, tc = j_get_arch(ARCH).reduced(), t_get_arch(ARCH).reduced()
    jtc = JTS.TrainStepConfig(arch=jc, fc=JFC.FastCLIPConfig(**kw),
                              optimizer=j_opt(optimizer),
                              lr_fn=j_lr(1e-3, 2, 10), wd=0.1,
                              precision=precision, guard=guard)
    ttc = TTS.TrainStepConfig(arch=tc, fc=TFC.FastCLIPConfig(**kw),
                              optimizer=t_opt(optimizer),
                              lr_fn=t_lr(1e-3, 2, 10), wd=0.1,
                              impl="flash", loss_impl="fused",
                              precision=precision, guard=guard)
    return jtc, ttc


def states(jtc, ttc):
    """The JAX init and the port state holding the same values."""
    js = JTS.init_train_state(jax.random.PRNGKey(0), jtc)
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), ttc, "cpu")
    tree = jax.tree.map(np.asarray, js)
    return js, bridge.state_from_tree(ts, tree)


def batches(steps):
    c = j_get_arch(ARCH).reduced()
    kw = dict(n=N, image_size=c.clip.image_size,
              context_length=c.clip.context_length, vocab_size=c.vocab_size)
    jl = JSL(JCD(**kw), global_batch=GB, seed=3)
    tl = TSL(TCD(**kw), global_batch=GB, seed=3)
    out = []
    for a, b in zip(jl.steps(steps), tl.steps(steps)):
        assert a[2].tobytes() == b[2].tobytes()
        for k in a[3]:
            assert a[3][k].tobytes() == b[3][k].tobytes()
        out.append((a[2], a[3]))
    return out


def jax_grads(jtc, state, batch, idx):
    """Step-1 gradients of the JAX step's loss (its own loss_fn, rebuilt
    here because the step does not return them)."""
    fc = jtc.fc
    fcs = state["fc"]
    gamma = fc.gamma_fn()(state["step"])
    core = (None if fc.version == "openclip"
            else JTS.make_loss_core(fc, None, "fastclip", "dense"))

    def loss_fn(params, tau_diff):
        e1, e2 = JBB.encode_pair(params, jtc.arch, batch, impl=jtc.impl,
                                 precision=jtc.resolved_precision)
        e1n, e2n = JLS.l2_normalize(e1), JLS.l2_normalize(e2)
        if fc.version == "openclip":
            return JLS.mbcl_loss(e1n, e2n, tau_diff)
        t1 = fcs["tau1"] if fc.individual_tau else tau_diff
        t2 = fcs["tau2"] if fc.individual_tau else tau_diff
        return core(e1n, e2n, fcs["u1"], fcs["u2"], t1, t2, idx, gamma)[0]

    tau = 0.0 if fc.individual_tau else fcs["tau"]
    return jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(state["params"], tau)


@pytest.mark.parametrize("version", ["openclip", "v1", "v2", "v3"])
def test_three_steps_match_jax(version):
    jtc, ttc = configs(version)
    js, ts = states(jtc, ttc)
    data = batches(3)
    # step-1 gradients of every leaf
    idx0, b0 = data[0]
    jb0 = {k: jnp.asarray(v) for k, v in b0.items()}
    jg, jgtau = jax_grads(jtc, js, jb0, jnp.asarray(idx0))
    core = (None if ttc.fc.version == "openclip"
            else TTS.make_loss_core(ttc.fc, "fused"))
    gamma = ttc.fc.gamma_fn()(ts["step"])
    _, _, tg, tgtau = TTS.step_grads(
        ttc, core, ts, {k: torch.from_numpy(v) for k, v in b0.items()},
        torch.from_numpy(idx0), gamma)
    tgf = {k: v.numpy() for k, v in flatten(bridge.named_to_tree(
        ts["params"], tg)).items()}
    jgf = jax_flat(jg)
    assert sorted(tgf) == sorted(jgf)
    for k in jgf:
        scale = np.abs(jgf[k]).max()
        assert np.linalg.norm(tgf[k] - jgf[k]) <= 1e-4 * np.linalg.norm(
            jgf[k]), k
        np.testing.assert_allclose(tgf[k], jgf[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    if version == "openclip":
        np.testing.assert_allclose(float(tgtau), float(jgtau), rtol=1e-4)
    # three steps
    jstep = jax.jit(JTS.make_train_step(jtc))
    tstep = TTS.make_train_step(ttc, "cpu")
    for idx, b in data:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.asarray(idx))
        ts, tm = tstep(ts, b, idx)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        if ttc.fc.uses_fcco:
            for u in ("u1", "u2"):
                np.testing.assert_allclose(ts["fc"][u][idx].numpy(),
                                           np.asarray(js["fc"][u])[idx],
                                           rtol=1e-4, atol=1e-5)
    want = jax_flat(js)
    got = {k: np.asarray(v) for k, v in flatten(
        bridge.state_to_tree(ts)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-5,
                                       err_msg=k)
        elif np.issubdtype(want[k].dtype, np.integer):
            assert np.array_equal(got[k], want[k]), k
        elif k.startswith("fc/"):
            fin = np.isfinite(want[k])
            assert np.array_equal(fin, np.isfinite(got[k])), k
            np.testing.assert_allclose(got[k][fin], want[k][fin], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_step_runs_the_kernel_paths_plain_on_cpu():
    """On CPU tensors the default impls take the plain versions: no
    kernel launch is counted, and the fused step equals the dense one
    within 1e-5."""
    before = (FA.flash_attention.launches, GL.gcl_pair_stats.launches,
              GL.gcl_pair_grads.launches)
    jtc, ttc = configs("v3")
    data = batches(1)
    out = {}
    for impl in ("fused", "dense"):
        _, ts = states(jtc, ttc)
        tc = TTS.TrainStepConfig(**{**ttc.__dict__, "loss_impl": impl})
        ts, m = TTS.make_train_step(tc, "cpu")(ts, data[0][1], data[0][0])
        out[impl] = (m, ts)
    assert (FA.flash_attention.launches, GL.gcl_pair_stats.launches,
            GL.gcl_pair_grads.launches) == before
    for k in out["dense"][0]:
        np.testing.assert_allclose(float(out["fused"][0][k]),
                                   float(out["dense"][0][k]), rtol=1e-5)


def test_nan_batch_under_guard_is_a_bitwise_noop():
    jtc, ttc = configs("v2", guard=True)
    _, ts = states(jtc, ttc)
    step = TTS.make_train_step(ttc, "cpu")
    (idx, b), (idx2, b2) = batches(2)
    ts, m = step(ts, b, idx)
    assert float(m["skipped"]) == 0.0
    before = {k: v.numpy().tobytes() for k, v in flatten(
        bridge.state_to_tree(ts)).items()}
    bad = dict(b2)
    bad["images"] = np.full_like(b2["images"], np.nan)
    ts, m = step(ts, bad, idx2)
    assert float(m["skipped"]) == 1.0 and float(m["nonfinite_rate"]) > 0
    after = {k: v.numpy().tobytes() for k, v in flatten(
        bridge.state_to_tree(ts)).items()}
    assert after.keys() == before.keys()
    assert [k for k in before if after[k] != before[k]] == []


@pytest.mark.parametrize("optimizer", ["lamb", "sgdm", "lion"])
def test_bf16_policy_keeps_f32_masters(optimizer):
    jtc, ttc = configs("v3", optimizer=optimizer, precision="bf16")
    _, ts = states(jtc, ttc)
    step = TTS.make_train_step(ttc, "cpu")
    for idx, b in batches(2):
        ts, m = step(ts, b, idx)
        assert np.isfinite(float(m["loss"]))
    TTS.check_state_dtypes(ts)
    ts["opt"]["m"]["text_proj"] = ts["opt"]["m"]["text_proj"].bfloat16()
    with pytest.raises(AssertionError, match="text_proj"):
        TTS.check_state_dtypes(ts)


def test_retrieval_accuracy_matches_jax():
    jtc, ttc = configs("v3")
    js, ts = states(jtc, ttc)
    (idx, b), = batches(1)
    classes = np.arange(GB) % 5
    for cls in (None, classes):
        want = JTS.retrieval_accuracy(js["params"], jtc.arch,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()}, classes=cls)
        got = TTS.retrieval_accuracy(
            ts["params"], ttc.arch,
            {k: torch.from_numpy(v) for k, v in b.items()}, classes=cls)
        assert float(got) == float(want)


def test_state_bridge_roundtrip_is_bitwise():
    for version in ("v2", "openclip"):
        jtc, ttc = configs(version, optimizer="lamb")
        js, ts = states(jtc, ttc)
        want = jax_flat(js)
        got = {k: v.numpy() for k, v in flatten(
            bridge.state_to_tree(ts)).items()}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
