"""Sharded checkpoints between the packages, bit for bit, on the CPU: a
JAX ``save_sharded`` at fsdp=4 (4 forced host devices,
tests/helpers/torch_mesh_jax.py) restores in the port merged on one
device and as the shards of each rank of a data:1,fsdp:4 gloo group;
that group's ``save_sharded`` (shard files + rank-tagged blocks)
restores in ``repro.checkpoint`` and in the port."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import checkpoint as JCK
from repro_torch import checkpoint as TCK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_mesh_check as H  # noqa: E402


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ckpt")
    jdir = d / "jax"
    jdir.mkdir()
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "helpers",
                                      "torch_mesh_jax.py"), "ckpt",
         str(jdir)], env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    ranks = H.spawn("ckpt", d, jdir, timeout=120)
    assert [r.returncode for r in ranks] == [0] * 4, ranks[0].stderr[-3000:]
    with open(d / "ckpt.json") as f:
        checks = json.load(f)
    ref = dict(np.load(jdir / "ref.npz"))
    return str(jdir), str(d / "port_ckpt"), ref, checks


def _bitwise(flat, ref):
    return sorted(flat) == sorted(ref) and all(
        np.asarray(flat[k]).dtype == ref[k].dtype
        and np.asarray(flat[k]).tobytes() == ref[k].tobytes() for k in ref)


def test_jax_fsdp4_checkpoint_restores_merged_in_the_port(ckpts):
    jdir, _, ref, _ = ckpts
    assert len([f for f in os.listdir(jdir) if ".shard" in f]) == 4
    tree, step, meta = TCK.restore(jdir, TCK.unflatten(dict(ref)))
    assert step == 1 and meta == {"mesh": "1x4"}
    assert _bitwise(TCK.flatten(tree), ref)


def test_jax_fsdp4_checkpoint_restores_as_four_rank_shards(ckpts):
    checks = ckpts[3]
    assert checks["restored_bitwise"] and checks["step"] == 1
    assert checks["shards_bitwise_all_ranks"]
    assert checks["sharded_leaves"] > 0


def test_port_four_rank_checkpoint_restores_in_jax(ckpts):
    _, pdir, ref, _ = ckpts
    names = os.listdir(pdir)
    assert len([f for f in names if ".shard" in f]) == 4
    assert len([f for f in names if f.endswith(".npz") and ".rank" in f]) \
        == 4
    with open(os.path.join(pdir, "ckpt_00000001.json")) as f:
        meta = json.load(f)
    assert meta["ranks"]["count"] == 4
    assert sorted(meta["ranks"]["arrays"]) == ["fc/u1", "fc/u2"]
    assert JCK.latest_step(pdir) == 1
    like = jax.tree.map(np.zeros_like, TCK.unflatten(dict(ref)))
    tree, step, meta = JCK.restore(pdir, like)
    assert step == 1 and meta == {"mesh": "1x4"}
    assert _bitwise(TCK.flatten(tree), ref)


def test_port_four_rank_checkpoint_restores_in_the_port(ckpts):
    _, pdir, ref, _ = ckpts
    assert TCK.latest_step(pdir) == 1
    tree, step, meta = TCK.restore(pdir, TCK.unflatten(dict(ref)))
    assert step == 1 and meta == {"mesh": "1x4"}
    assert _bitwise(TCK.flatten(tree), ref)
