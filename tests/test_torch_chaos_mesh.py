"""The crash-recovery battery on the (data, fsdp) mesh: ``--mesh
data:2,fsdp:2`` as 4-rank gloo groups on the CPU
(``repro_torch.launch.multiprocess.run_train_multiprocess``), every state
compared as the merged sharded checkpoint, bit for bit, with a clean
4-rank run: a kill at the first save's second npz file
(``kill_save@mid_npz:2``: rank 0's shard file in a tmp file, its peers
waiting in the filesystem barrier), then a resume killed before step 3
(``kill@3``), then a resume to the end; a NaN batch under ``--guard``; and
one run through the streaming loader that rolls back two bad steps with
async saves and retention, every rank taking the decision at the same
step (ranks that disagreed would wait for each other in the next
collective)."""
import os
import threading

import numpy as np
import pytest

from repro_torch import checkpoint as TCK
from repro_torch.configs import get_arch
from repro_torch.data import ContrastiveDataset, write_contrastive_shards
from repro_torch.launch import multiprocess as MP

ARGS = ["--arch", "clip-vitb32-cc12m", "--reduced", "--global-batch", "16",
        "--n-samples", "32", "--log-every", "1", "--mesh", "data:2,fsdp:2",
        "--device", "cpu"]
# one intra-op thread per rank: every group computes the same bits
ENV = {"OMP_NUM_THREADS": "1"}


def _group(extra, steps=4):
    return MP.run_train_multiprocess(ARGS + ["--steps", str(steps)] + extra,
                                     num_processes=4, timeout=180,
                                     env_extra=ENV)


def _concurrently(**jobs):
    """Run the groups ``jobs`` (name -> train args) at once; returns name
    -> the ranks' results."""
    out = {}

    def one(name, extra):
        out[name] = _group(*extra)

    threads = [threading.Thread(target=one, args=item)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def _state(d, step):
    return TCK.checkpoint._load_verified(d, step)[0]


def _bitwise(got, want):
    return sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and got[k].tobytes() ==
        want[k].tobytes() for k in want)


def _ok(ranks):
    return [r.returncode for r in ranks] == [0] * 4


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos_mesh")
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    shards = str(d / "shards")
    write_contrastive_shards(ContrastiveDataset(
        n=32, image_size=cfg.clip.image_size,
        context_length=cfg.clip.context_length, vocab_size=cfg.vocab_size,
        n_classes=64), shards, samples_per_shard=8)
    dirs = {k: str(d / k) for k in ("ref", "kill", "nan", "stream")}
    runs = _concurrently(
        ref=(["--guard", "--ckpt-dir", dirs["ref"], "--ckpt-every", "2"],),
        kill_save=(["--ckpt-dir", dirs["kill"], "--ckpt-every", "2",
                    "--chaos", "kill_save@mid_npz:2"],),
        nan=(["--guard", "--chaos", "nan_batch@2", "--ckpt-dir",
              dirs["nan"]], 3))
    runs["kill_save_latest"] = TCK.latest_step(dirs["kill"])
    runs.update(_concurrently(
        kill=(["--ckpt-dir", dirs["kill"], "--ckpt-every", "2", "--resume",
               "--chaos", "kill@3"],),
        stream=(["--data", f"streaming:{shards}", "--decode-workers", "2",
                 "--rollback-after", "2", "--chaos",
                 "nan_batch@2,nan_batch@3", "--ckpt-dir", dirs["stream"],
                 "--ckpt-every", "2", "--ckpt-async", "--ckpt-keep", "1"],)))
    runs["kill_latest"] = TCK.latest_step(dirs["kill"])
    runs["resume"] = _group(["--ckpt-dir", dirs["kill"], "--resume"])
    runs["dirs"] = dirs
    return runs


def test_reference_group_runs(mesh_runs):
    assert _ok(mesh_runs["ref"]), mesh_runs["ref"][0].stderr[-3000:]
    assert TCK.available_steps(mesh_runs["dirs"]["ref"]) == [2, 4]


def test_killed_mid_save_then_before_a_step_resumes_bitwise(mesh_runs):
    """``kill_save@mid_npz:2`` kills rank 0 inside the step-2 save and
    the harness kills its peers: no step is durable.  The resume starts
    afresh, saves step 2 and dies before step 3 (``kill@3``, every
    rank).  The second resume ends on the reference's state."""
    for key in ("kill_save", "kill"):
        rcs = [r.returncode for r in mesh_runs[key]]
        assert rcs[0] == -9 and all(rc != 0 for rc in rcs), (key, rcs)
    assert mesh_runs["kill_save_latest"] is None
    assert all(rc == -9 for rc in (r.returncode for r in mesh_runs["kill"]))
    assert "resumed from step" not in mesh_runs["kill"][0].stdout
    d = mesh_runs["dirs"]["kill"]
    assert mesh_runs["kill_latest"] == 2
    resumed = mesh_runs["resume"]
    assert _ok(resumed), resumed[0].stderr[-3000:]
    assert all("resumed from step 2" in r.stdout for r in resumed)
    assert _bitwise(_state(d, 4), _state(mesh_runs["dirs"]["ref"], 4))


def test_nan_batch_is_a_bitwise_noop_on_every_rank(mesh_runs):
    runs = mesh_runs["nan"]
    assert _ok(runs), runs[0].stderr[-3000:]
    for r in runs:
        assert r.stdout.count('"skipped": 1.0') == 1
        assert r.stdout.count('"skipped": 0.0') == 2
    assert _bitwise(_state(mesh_runs["dirs"]["nan"], 3),
                    _state(mesh_runs["dirs"]["ref"], 2))


def test_streaming_rollback_with_async_saves_is_bitwise(mesh_runs):
    runs = mesh_runs["stream"]
    assert _ok(runs), runs[0].stderr[-3000:]
    lines = [[ln for ln in r.stdout.splitlines()
              if ln.startswith(("step ", "rollback:"))] for r in runs]
    assert all(ls == lines[0] for ls in lines)
    assert [ln.split()[1] if ln.startswith("step") else "rollback"
            for ln in lines[0]] == ["0", "1", "2", "3", "rollback", "2",
                                    "3"]
    assert "restored verified step 2" in lines[0][4]
    d = mesh_runs["dirs"]["stream"]
    assert TCK.available_steps(d) == [4]
    assert len([n for n in os.listdir(d) if n.startswith("ckpt_00000004.")
                and ".rank" in n and n.endswith(".npz")]) == 4
    assert _bitwise(_state(d, 4), _state(mesh_runs["dirs"]["ref"], 4))
    for k, v in _state(d, 4).items():
        if v.dtype.kind == "f" and not k.startswith("fc/u"):
            assert np.isfinite(v).all(), k
