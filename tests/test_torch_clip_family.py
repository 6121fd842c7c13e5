"""The paper's other two CLIP settings in the port, ``clip-rn50-cc3m``
(the ResNet-50 tower) and ``clip-vitb16-laion``, against the JAX package
on the CPU: the configs; three FastCLIP v3 steps of the single-device
train step against JAX's ``make_train_step`` (the narrow ResNet-50 of
tests/test_torch_resnet.py, and the reduced ViT-B/16 at patch 16 on 64
px, so that the /16 grid is the one the test holds), loss and tau within
1e-5, params 5e-5, log-u 1e-4; one ZeRO step of the narrow ResNet-50 on
a 2-rank ``data:1,fsdp:2`` gloo group against the single-device step at
the same bounds; ``fsdp_leaf_dim`` against JAX's on every leaf of the
full-width ResNet-50 CLIP; the launchers at ``--reduced`` on the CPU,
on one device and on a 2-rank mesh, and without ``--device cpu`` their
refusal on a machine without CUDA."""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.core import fastclip as JFC
from repro.core import shard_state as JSS
from repro.core import train_step as JTS
from repro.core.schedules import lr_warmup_cosine as j_lr
from repro.data import ContrastiveDataset as JCD
from repro.data import ShardedLoader as JSL
from repro.launch import mesh as JM
from repro.models import backbones as JBB
from repro.optim import get_optimizer as j_opt
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import fastclip as TFC
from repro_torch.core import shard_state as SS
from repro_torch.core import train_step as TTS
from repro_torch.core.schedules import lr_warmup_cosine as t_lr
from repro_torch.launch import eval as teval
from repro_torch.launch import mesh as MS
from repro_torch.launch import serve_embed as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import backbones as TBB
from repro_torch.models import clip as TC
from repro_torch.optim import get_optimizer as t_opt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
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


NEW_ARCHS = ("clip-rn50-cc3m", "clip-vitb16-laion")
N, GB = 32, 16


def small(get_arch, arch):
    """The narrow ResNet-50 at 64 px (its stage-3 GroupNorms then see
    2 x 2 positions, not one), or the reduced ViT-B/16 at patch 16 / 64
    px."""
    if arch == "clip-rn50-cc3m":
        cfg = H.narrow_rn50(get_arch)
        return cfg.replace(clip=dataclasses.replace(cfg.clip, image_size=64))
    cfg = get_arch(arch).reduced()
    return cfg.replace(clip=dataclasses.replace(cfg.clip, patch_size=16,
                                                image_size=64))


def jax_flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_jax_and_build(arch):
    for full in (False, True):
        j, t = j_get_arch(arch), t_get_arch(arch)
        if not full:
            j, t = j.reduced(), t.reduced()
        jd = dataclasses.asdict(j)
        for k, v in dataclasses.asdict(t).items():
            assert jd[k] == v, k
    with torch.device("meta"):
        model = TC.CLIP(t_get_arch(arch))
    jn = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(
        JBB.param_shapes(j_get_arch(arch))))
    assert sum(p.numel() for p in model.parameters()) == jn


def _assert_states_close(ts, js):
    want = jax_flat(js)
    got = {k: np.asarray(v) for k, v in flatten(
        bridge.state_to_tree(ts)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-5,
                                       err_msg=k)
        elif k.startswith(("fc/u1", "fc/u2")):
            fin = np.isfinite(want[k])
            assert np.array_equal(fin, np.isfinite(got[k])), k
            np.testing.assert_allclose(got[k][fin], want[k][fin], rtol=0,
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_three_steps_match_jax(arch):
    """ViT-B/16: three AdamW steps in a row.  The narrow ResNet-50: each
    of three steps from the same state (JAX's trajectory), with SGD
    momentum, at 64 px.  In f32 its trajectory is chaotic: JAX's jitted
    step and JAX's own eager step end 1.7e-3 apart in params after three
    AdamW steps at 32 px (the port: 1.8e-3), and 2.0e-3 at 64 px; 1.5e-4
    after three SGD-momentum steps at 64 px (the port: 6.8e-5).
    GroupNorm's shift invariance leaves gradient directions that are
    zero up to rounding, which AdamW scales to +-lr, and the tower turns
    a 1e-6 change of params into 1e-4 of loss a step later.  At 32 px
    one step's log-u already differs by 1.2e-4 (the towers' f32 drift,
    tests/test_torch_resnet.py), at 64 px by 2.6e-5."""
    rn50 = arch == "clip-rn50-cc3m"
    kw = dict(version="v3", n_samples=N, steps_per_epoch=N // GB,
              gamma_decay_epochs=1, tau_init=0.07, lr_tau=2e-4, rho=6.5)
    opt = "sgdm" if rn50 else "adamw"
    jc, tc = small(j_get_arch, arch), small(t_get_arch, arch)
    jtc = JTS.TrainStepConfig(arch=jc, fc=JFC.FastCLIPConfig(**kw),
                              optimizer=j_opt(opt), lr_fn=j_lr(1e-3, 2, 10),
                              wd=0.1)
    ttc = TTS.TrainStepConfig(arch=tc, fc=TFC.FastCLIPConfig(**kw),
                              optimizer=t_opt(opt), lr_fn=t_lr(1e-3, 2, 10),
                              wd=0.1, impl="flash", loss_impl="fused")
    js = jax.jit(lambda k: JTS.init_train_state(k, jtc))(
        jax.random.PRNGKey(0))
    ts = TTS.init_train_state(torch.Generator().manual_seed(0), ttc, "cpu")
    ts = bridge.state_from_tree(ts, jax.tree.map(np.asarray, js))
    dkw = dict(n=N, image_size=tc.clip.image_size,
               context_length=tc.clip.context_length,
               vocab_size=tc.vocab_size)
    jstep = jax.jit(JTS.make_train_step(jtc))
    tstep = TTS.make_train_step(ttc, "cpu")
    for (_, _, idx, b) in JSL(JCD(**dkw), global_batch=GB,
                              seed=3).steps(3):
        if rn50:
            ts = bridge.state_from_tree(ts, jax.tree.map(np.asarray, js))
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.asarray(idx))
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                       torch.from_numpy(idx))
        for k in ("loss", "tau"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, k
        if rn50:
            _assert_states_close(ts, js)
    _assert_states_close(ts, js)


@pytest.mark.parametrize("size", [2, 4])
def test_fsdp_dims_equal_jax_on_every_rn50_leaf(size):
    """Shapes only: the full-width tree, 4-D HWIO convs included."""
    jshapes = JBB.param_shapes(j_get_arch("clip-rn50-cc3m"))
    want = {_path_str(p): d for p, d in jax.tree_util.tree_flatten_with_path(
        JSS.param_fsdp_dims(jshapes, size),
        is_leaf=lambda d: d is None)[0]}
    tshapes = TBB.param_shapes(t_get_arch("clip-rn50-cc3m"))
    assert SS.param_fsdp_dims(tshapes, size) == want
    flat = flatten(tshapes)
    assert flat["vision/stem"].shape == (7, 7, 3, 64)
    assert want["vision/stem"] == 3          # cin 3 does not divide: cout
    assert want["vision/stage0/0/c2"] == 2   # HWIO's -2 is cin
    assert want["vision/stage0/0/n1/scale"] is None
    for path, leaf in flat.items():
        assert MS.fsdp_leaf_dim(path, tuple(leaf.shape), size) == \
            JM.fsdp_leaf_dim(path, tuple(leaf.shape), size), path


def test_rn50_zero_step_on_two_ranks_equals_single_device(tmp_path):
    ranks = H.spawn("rn50", tmp_path, nproc=2, timeout=240)
    assert [r.returncode for r in ranks] == [0] * 2, ranks[0].stderr[-3000:]
    with open(tmp_path / "rn50.json") as f:
        c = json.load(f)
    assert c["same_keys"]
    assert c["params_unmoved"] == []
    assert c["dloss"] < 1e-5
    assert c["dparam"] < 5e-5
    assert c["dlogu"] < 1e-4
    assert c["moment_rel_l2"] < 1e-4
    assert "vision/stage3/2/c3" in c["sharded_conv_leaves"]


@pytest.mark.parametrize("arch,extra", [
    ("clip-rn50-cc3m", ["--steps", "1", "--global-batch", "2",
                        "--n-samples", "4", "--image-size-schedule",
                        "0:16"]),
    ("clip-vitb16-laion", ["--steps", "2", "--global-batch", "4",
                           "--n-samples", "8", "--image-size-schedule",
                           "0:16,1:32"]),
])
def test_train_launcher_runs_reduced_on_cpu(arch, extra, capsys):
    """The launcher at ``--reduced`` (ResNet-50: stem width 128, about
    95M tower params, hence one step at batch 2), with the image
    curriculum."""
    record = []
    state = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--log-every", "1"] + extra, record=record)
    steps = int(extra[1])
    assert len(record) == steps
    assert all(np.isfinite(r["loss"]) for r in record)
    TTS.check_state_dtypes(state)
    out = capsys.readouterr().out
    assert sum(ln.startswith("step ") for ln in out.splitlines()) == steps


@pytest.mark.parametrize("arch,batch", [("clip-rn50-cc3m", "2"),
                                        ("clip-vitb16-laion", "4")])
def test_train_launcher_runs_on_a_two_rank_mesh(arch, batch):
    """``--mesh data:1,fsdp:2`` through the multi-process launcher, one
    step at ``--reduced``: both ranks finish and log the same line."""
    from repro_torch.launch import multiprocess as MP
    ranks = MP.run_train_multiprocess(
        ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
         "--global-batch", batch, "--n-samples", batch, "--log-every", "1",
         "--mesh", "data:1,fsdp:2"], num_processes=2, timeout=240,
        env_extra={"OMP_NUM_THREADS": "1"})
    assert [r.returncode for r in ranks] == [0, 0], ranks[0].stderr[-3000:]
    lines = [[ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
             for r in ranks]
    assert len(lines[0]) == 1 and lines[0] == lines[1]
    line = lines[0][0]
    assert np.isfinite(json.loads(line[line.index("{"):])["loss"])


def test_launchers_need_the_card_for_the_new_archs(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    for arch in NEW_ARCHS:
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            ttrain.main(["--arch", arch, "--reduced", "--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            teval.main(["--arch", arch, "--reduced", "--ckpt-dir",
                        str(tmp_path)])
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            tserve.main(["--arch", arch, "--reduced", "--ckpt-dir",
                         str(tmp_path)])
