"""The port's (data, fsdp) mesh against the JAX package, on the CPU: the
layout rules (``fsdp_leaf_dim`` and ``param_fsdp_dims`` for every leaf of
clip-vitb32-cc12m and zamba2-1.2b, ``parse_mesh_arg``), the loader's
sharded parts bit for bit, the sharded loss ops of a 4-rank gloo group
against ``repro.core.distributed`` under ``shard_map`` on 4 forced host
devices (tests/helpers/torch_mesh_jax.py), and the one-rank mesh step
against the single-device step."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import ContrastiveDataset as JCD
from repro.data import ShardedLoader as JSL
from repro.launch import mesh as JM
from repro.models import backbones as JBB
from repro_torch.checkpoint import bridge, flatten, unflatten
from repro_torch.configs import get_arch
from repro_torch.core import fastclip as FC
from repro_torch.core import shard_state as SS
from repro_torch.core import train_step as TS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import ContrastiveDataset as TCD
from repro_torch.data import ShardedLoader as TSL
from repro_torch.launch import mesh as MS
from repro_torch.models import backbones as BB
from repro_torch.optim import adamw

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


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["clip-vitb32-cc12m", "zamba2-1.2b"])
@pytest.mark.parametrize("size", [2, 4, 8])
def test_fsdp_dims_equal_jax_for_every_leaf(arch, size):
    import jax
    from repro.checkpoint.checkpoint import _path_str
    from repro.core import shard_state as JSS
    jshapes = JBB.param_shapes(jget_arch(arch))
    want = {_path_str(p): d for p, d in jax.tree_util.tree_flatten_with_path(
        JSS.param_fsdp_dims(jshapes, size),
        is_leaf=lambda d: d is None)[0]}
    tshapes = BB.param_shapes(get_arch(arch))
    got = SS.param_fsdp_dims(tshapes, size)
    assert got == want
    assert any(d is not None for d in got.values())
    for path, leaf in flatten(tshapes).items():
        assert MS.fsdp_leaf_dim(path, tuple(leaf.shape), size) == \
            JM.fsdp_leaf_dim(path, tuple(leaf.shape), size), path


def test_parse_mesh_arg_equals_jax():
    for spec in ("data:2", "data:2,fsdp:2", "fsdp:4,data:1", "data:8"):
        assert MS.parse_mesh_arg(spec) == JM.parse_mesh_arg(spec)
    for bad in ("data", "model:2", "fsdp:2", "data:0", "data:2,fsdp:0"):
        with pytest.raises(ValueError):
            JM.parse_mesh_arg(bad)
        with pytest.raises(ValueError):
            MS.parse_mesh_arg(bad)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        MS.validate_mesh_devices(2, 2, 1)


@pytest.mark.parametrize("hosts,want,local", [
    # two hosts of 8 cards, 8 ranks each: every rank has a card
    ([(h, 8) for h in ("a", "b") for _ in range(8)], "nccl",
     list(range(8)) * 2),
    # 16 ranks on one host of 8 cards: two ranks per card
    ([("a", 8)] * 16, "gloo", list(range(16))),
    # the one-card machine: 4 ranks on its card, or one rank alone
    ([("a", 1)] * 4, "gloo", [0, 1, 2, 3]),
    ([("a", 1)], "nccl", [0]),
    # ranks on the CPU (no card)
    ([("a", 0)] * 2, "gloo", [0, 1]),
    # interleaved hosts: a rank's card is its index on its own host
    ([("a", 2), ("b", 2), ("a", 2), ("b", 2)], "nccl", [0, 0, 1, 1]),
])
def test_backend_rule(hosts, want, local):
    assert MS.choose_backend(hosts) == want
    assert [MS.local_rank(hosts, r) for r in range(len(hosts))] == local
    assert MS.rank_device(torch.device("cpu"), 3) == torch.device("cpu")


@pytest.mark.parametrize("owned,start", [((0,), 0), ((3,), 5), ((1, 2), 2)])
def test_sharded_loader_parts_equal_jax_bitwise(owned, start):
    kw = dict(n=64, image_size=16, context_length=12, vocab_size=100)
    jl = JSL(JCD(**kw), global_batch=16, n_shards=4, seed=3,
             owned_shards=owned)
    tl = TSL(TCD(**kw), global_batch=16, n_shards=4, seed=3,
             owned_shards=owned)
    for (ji, jb), (ti, tb) in zip(jl.epoch(1), tl.epoch(1)):
        assert ti.tobytes() == ji.tobytes()
        assert all(tb[k].tobytes() == jb[k].tobytes() for k in jb)
        assert tl._owned_rows(ti).tobytes() == jl._owned_rows(ji).tobytes()
    want = list(jl._index_steps(11, start))
    got = list(tl._index_steps(11, start))
    assert len(got) == len(want) == 11 - start
    assert all(g[:2] == w[:2] and g[2].tobytes() == w[2].tobytes()
               for g, w in zip(got, want))
    for (e, s, i, b), (we, ws, wi, wb) in zip(tl.steps(6, start=start),
                                              jl.steps(6, start=start)):
        assert (e, s) == (we, ws) and i.tobytes() == wi.tobytes()
        assert len(b["images"]) == 4 * len(owned)
        assert all(b[k].tobytes() == wb[k].tobytes() for k in wb)
    with pytest.raises(ValueError, match="owned_shards"):
        TSL(TCD(**kw), global_batch=16, n_shards=4, owned_shards=(4,))


# ---------------------------------------------------------------------------
# The 4-rank loss ops against JAX's shard_map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_loss")
    inp = d / "in.npz"
    np.savez(inp, **H.loss_inputs())
    jax_out = d / "jax.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    jproc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "helpers",
                                      "torch_mesh_jax.py"), "loss",
         str(inp), str(jax_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ranks = H.spawn("loss", d, inp, timeout=180)
    _, err = jproc.communicate(timeout=240)
    assert jproc.returncode == 0, err[-3000:]
    assert [r.returncode for r in ranks] == [0] * 4, ranks[0].stderr[-3000:]
    return dict(np.load(d / "loss.npz")), dict(np.load(jax_out))


@pytest.mark.parametrize("case", H.LOSS_CASES)
def test_sharded_loss_op_equals_jax_shard_map(loss_results, case):
    """Stats, log-u rows and sat within 1e-5; the loss within 1e-5; the
    gradients of the global mean loss within rtol 1e-4 / atol 1e-5 (of
    the gradients' scale)."""
    got, want = loss_results
    keys = sorted(k for k in want if k.startswith(case + "/"))
    assert keys and keys == sorted(k for k in got if k.startswith(case + "/"))
    for k in keys:
        g, w = got[k].reshape(want[k].shape), want[k]
        fin = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), fin), k
        if k.endswith(("/de1", "/de2")):
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=k)
        else:
            scale = max(float(np.abs(w[fin]).max()), 1.0) if fin.any() \
                else 1.0
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# A one-rank mesh in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version,reduction", [
    ("v3", "fastclip"), ("v2", "fastclip"), ("openclip", "fastclip"),
    ("v3", "allgather_ad")])
def test_one_rank_mesh_step_equals_single_device(version, reduction):
    """``--mesh data:1,fsdp:1`` without collectives: three steps of the
    mesh step (either reduction) against the single-device step from the
    same state."""
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    fc = FC.FastCLIPConfig(version=version, n_samples=32, steps_per_epoch=2,
                           gamma_decay_epochs=2)
    kw = dict(arch=cfg, fc=fc, optimizer=adamw(),
              lr_fn=lr_warmup_cosine(1e-3, 2, 10), impl="chunked",
              loss_impl="fused")
    st = TS.init_train_state(torch.Generator().manual_seed(1),
                             TS.TrainStepConfig(**kw), "cpu")
    tree = unflatten({k: v.clone() for k, v in flatten(
        bridge.state_to_tree(st)).items()})
    ds = TCD(n=32, image_size=cfg.clip.image_size,
             context_length=cfg.clip.context_length,
             vocab_size=cfg.vocab_size, n_classes=4)
    batches = [(torch.from_numpy(i), {k: torch.from_numpy(v)
                                      for k, v in b.items()})
               for _, _, i, b in TSL(ds, global_batch=16).steps(3)]
    single = TS.make_train_step(TS.TrainStepConfig(**kw), "cpu")
    mesh = MS.make_train_mesh(1, 1)
    try:
        step = TS.make_train_step(TS.TrainStepConfig(
            **kw, fsdp=True, mesh_axes=MS.TRAIN_AXES, reduction=reduction))
        sm = SS.shard_train_state(tree, mesh)
        for idx, b in batches:
            st, m1 = single(st, b, idx)
            sm, mm = step(sm, b, idx)
            assert abs(float(m1["loss"]) - float(mm["loss"])) <= 1e-6
        full = flatten(SS.gather_train_state(sm, mesh, step.param_dims))
    finally:
        MS.set_mesh(None)
    want = flatten(bridge.state_to_tree(st))
    assert sorted(full) == sorted(want)
    for k in want:
        np.testing.assert_allclose(full[k].detach().numpy(),
                                   want[k].numpy(), rtol=0, atol=5e-6,
                                   err_msg=k)
