"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: one on-disk format, so each restores what the other saved,
bit for bit; digests catch damage; an fsdp-sharded JAX save merges."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.checkpoint.checkpoint import _path_str, _write_step
from repro.configs import get_arch as j_get_arch
from repro.models import backbones as JBB
from repro_torch import checkpoint as TCK
from repro_torch.configs import get_arch as t_get_arch
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

ARCH = "clip-vitb32-cc12m"


@pytest.fixture(scope="module")
def params():
    """JAX init of the reduced config: (nested numpy tree, flat dict)."""
    jparams = JBB.init_params(jax.random.PRNGKey(1),
                              j_get_arch(ARCH).reduced())
    tree = jax.tree.map(np.asarray, jparams)
    flat = {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    return tree, flat


def _assert_bitwise(flat_a, flat_b):
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        a, b = np.asarray(flat_a[k]), np.asarray(flat_b[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_jax_save_restores_in_port_bitwise(tmp_path, params):
    tree, flat = params
    JCK.save(str(tmp_path), {"params": tree, "step": np.int32(7)}, 7,
             {"arch": ARCH})
    like = TBB.param_shapes(t_get_arch(ARCH).reduced())
    got, step, meta = TCK.restore_subtree(str(tmp_path), like, "params")
    assert step == 7 and meta == {"arch": ARCH}
    _assert_bitwise(TCK.flatten(got), flat)
    # and into a model, through the bridge
    model = TBB.params_from_tree(t_get_arch(ARCH).reduced(), got, "cpu")
    assert torch.equal(model.vision.blocks[1].attn.wq,
                       torch.tensor(flat["vision/blocks/attn/wq"][1]))


def test_port_save_restores_in_jax_bitwise(tmp_path, params):
    _, flat = params
    cfg = t_get_arch(ARCH).reduced()
    model = TBB.params_from_tree(cfg, TCK.unflatten(dict(flat)), "cpu")
    from repro_torch.checkpoint import bridge
    TCK.save(str(tmp_path), {"params": bridge.model_to_tree(model)}, 3,
             {"arch": ARCH})
    got, step, meta = JCK.restore_subtree(
        str(tmp_path), JBB.param_shapes(j_get_arch(ARCH).reduced()),
        "params")
    assert step == 3 and meta == {"arch": ARCH}
    _assert_bitwise({_path_str(p): v for p, v in
                     jax.tree_util.tree_flatten_with_path(got)[0]}, flat)
    # the sidecars agree on order (JAX sorts dict keys) and digests
    with open(tmp_path / "ckpt_00000003.json") as f:
        side = json.load(f)
    assert side["order"] == ["params/" + k for k in sorted(flat)]
    assert JCK.latest_step(str(tmp_path)) == 3


def _rewrite_one_value(path, key):
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    a = arrays[key].copy()
    a.reshape(-1)[0] = np.nextafter(a.reshape(-1)[0], np.float32(np.inf))
    arrays[key] = a
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def test_damage_is_rejected_and_restore_falls_back(tmp_path, params):
    tree, flat = params
    d = str(tmp_path)
    TCK.save(d, {"params": tree}, 1)
    TCK.save(d, {"params": tree}, 2)
    assert TCK.available_steps(d) == [1, 2] and TCK.latest_step(d) == 2
    # one value one ulp off, valid zip: only the per-leaf digest sees it
    _rewrite_one_value(os.path.join(d, "ckpt_00000002.npz"),
                       "params/text_proj")
    with pytest.raises(ValueError, match="digest mismatch"):
        TCK.restore(d, {"params": tree}, step=2)
    assert not TCK.verify_step(d, 2)
    assert TCK.latest_step(d) == 1
    got, step, _ = TCK.restore(d, {"params": tree})
    assert step == 1
    _assert_bitwise({k[len("params/"):]: v
                     for k, v in TCK.flatten(got).items()}, flat)
    # a flipped byte in the file itself (zip layer or digest catches it)
    p1 = os.path.join(d, "ckpt_00000001.npz")
    raw = bytearray(open(p1, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(p1, "wb").write(bytes(raw))
    assert TCK.latest_step(d) is None
    with pytest.raises(FileNotFoundError, match="no restorable"):
        TCK.restore(d, {"params": tree})


def test_shape_mismatch_is_an_error(tmp_path, params):
    tree, _ = params
    TCK.save(str(tmp_path), {"params": tree}, 0)
    like = {"params": dict(tree, text_proj=np.zeros((3, 3), np.float32))}
    with pytest.raises(ValueError, match="shape mismatch"):
        TCK.restore(str(tmp_path), like)


def test_fsdp_sharded_jax_save_merges_in_port(tmp_path, params):
    """A JAX save split into 2 fsdp shards (per-shard npz files plus the
    concat dims in the sidecar) restores merged, bit for bit."""
    _, flat = params
    pieces, dims = {}, {}
    for k, a in flat.items():
        key = "params/" + k
        if a.ndim and a.shape[0] % 2 == 0 and a.shape[0] > 1:
            pieces[key], dims[key] = np.split(a, 2, axis=0), 0
        else:
            pieces[key] = [a]
    _write_step(str(tmp_path), 5, pieces, dims, sorted(pieces), {})
    assert os.path.exists(tmp_path / "ckpt_00000005.shard01of02.npz")
    like = TBB.param_shapes(t_get_arch(ARCH).reduced())
    got, step, _ = TCK.restore_subtree(str(tmp_path), like, "params")
    assert step == 5
    _assert_bitwise(TCK.flatten(got), flat)


def test_rank_tagged_checkpoints_are_refused(tmp_path, params):
    tree, _ = params
    TCK.save(str(tmp_path), {"params": tree}, 0)
    side = tmp_path / "ckpt_00000000.json"
    meta = json.loads(side.read_text())
    meta["ranks"] = {"count": 2, "arrays": {}}
    side.write_text(json.dumps(meta))
    # a rank-tagged step whose rank files are missing is incomplete: no
    # restore, and no latest step (the readers of the rank-tagged format
    # are tested in tests/test_torch_mesh_ckpt.py)
    with pytest.raises(FileNotFoundError):
        TCK.restore(str(tmp_path), {"params": tree}, step=0)
    assert TCK.available_steps(str(tmp_path)) == []
    assert TCK.latest_step(str(tmp_path)) is None
