"""The port's (data, fsdp) mesh step on the CPU (the battery of
tests/helpers/fsdp_check.py, run by tests/helpers/torch_mesh_check.py in
one 4-rank gloo group): the ZeRO-sharded step bitwise equal to the
replicated layout at data:2,fsdp:2, both against the single-device step
(loss 1e-5, params 5e-5, log-u 1e-4), microbatch 2 and 4 against 1
(5e-5), the per-rank bytes of params and moments, the exact-reduction
properties; and the refusal of LAMB at fsdp > 1."""
import json
import os
import sys

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import fastclip as FC
from repro_torch.core import train_step as TS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.launch import mesh as MS
from repro_torch.optim import adamw, get_optimizer

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


@pytest.fixture(scope="module")
def step_checks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_step")
    ranks = H.spawn("step", d, timeout=200)
    assert [r.returncode for r in ranks] == [0] * 4, ranks[0].stderr[-3000:]
    with open(d / "step.json") as f:
        return json.load(f)


@pytest.mark.parametrize("version", ["v3", "v2"])
def test_sharded_equals_replicated_layout_bitwise(step_checks, version):
    c = step_checks
    assert c[f"{version}/bit_loss"] == [True] * 3
    for part in ("params", "opt", "fc/u1", "fc/u2", "fc/tau", "step"):
        assert c[f"{version}/bit_{part}"], part
    # the axis-aware norm of the shards is the whole tree's
    gn_sh, gn_rep, _ = c[f"{version}/grad_norm"]
    assert gn_sh > 0 and abs(gn_sh - gn_rep) < 1e-5 * max(gn_rep, 1.0)


@pytest.mark.parametrize("version", ["v3", "v2"])
def test_sharded_step_equals_single_device(step_checks, version):
    c = step_checks
    assert c[f"{version}/dloss"] < 1e-5
    assert c[f"{version}/dparam"] < 5e-5
    assert c[f"{version}/dlogu"] < 1e-4
    gn_sh, _, gn_1 = c[f"{version}/grad_norm"]
    assert abs(gn_sh - gn_1) < 1e-4 * max(gn_1, 1.0)


@pytest.mark.parametrize("nmb", [2, 4])
def test_microbatch_equals_unpipelined(step_checks, nmb):
    c = step_checks
    assert c[f"mb{nmb}/dloss"] < 5e-5
    assert c[f"mb{nmb}/dparam"] < 5e-5
    assert c[f"mb{nmb}/dlogu"] < 5e-5
    assert c[f"mb{nmb}/bit_step"]


def test_params_and_moments_per_rank_shrink(step_checks):
    per_rank, full = step_checks["memory"]
    # ~1/fsdp at fsdp=2: all but the small norm/bias/position leaves shard
    assert per_rank / full < 0.62


def test_exact_reductions_property(step_checks):
    pytest.importorskip("hypothesis")
    assert step_checks["props"] == 25


def test_lamb_is_refused_at_fsdp_above_one():
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    fc = FC.FastCLIPConfig(n_samples=16)
    kw = dict(arch=cfg, fc=fc, lr_fn=lr_warmup_cosine(1e-3, 1, 4),
              fsdp=True)
    MS.set_mesh(MS.Mesh(1, 2, 0, torch.device("cpu"), None,
                        {"data": None, "fsdp": None}))
    try:
        with pytest.raises(ValueError, match="not shard-safe"):
            TS.make_train_step(TS.TrainStepConfig(
                optimizer=get_optimizer("lamb"), **kw))
        # at fsdp 1 every leaf is whole, and LAMB is fine
        MS.set_mesh(MS.Mesh(2, 1, 0, torch.device("cpu"), None,
                            {"data": None, "fsdp": None}))
        TS.make_train_step(TS.TrainStepConfig(
            optimizer=get_optimizer("lamb"), **kw))
        with pytest.raises(ValueError, match="microbatch"):
            TS.make_train_step(TS.TrainStepConfig(
                optimizer=adamw(), arch=cfg, fc=fc,
                lr_fn=lr_warmup_cosine(1e-3, 1, 4), microbatch=2))
    finally:
        MS.set_mesh(None)
