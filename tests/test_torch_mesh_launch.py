"""The port's launcher on the (data, fsdp) mesh, on the CPU: ``--mesh
data:2,fsdp:2`` as a 4-rank gloo group (``repro_torch.launch.
multiprocess``) against the JAX launcher's single-process ``--mesh
data:2,fsdp:2`` on 4 forced host devices, through each other's sharded
checkpoints (the next step from the same state within the tolerances of
tests/test_torch_launch.py), every rank's log lines equal, and a group
killed after a checkpoint resuming from the rank-tagged files to the
uninterrupted run's state bit for bit."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import checkpoint as TCK
from repro_torch.launch import multiprocess as MP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "clip-vitb32-cc12m", "--reduced", "--global-batch", "16",
        "--n-samples", "32", "--log-every", "1", "--lr", "2e-3",
        "--mesh", "data:2,fsdp:2", "--steps", "3"]
PORT = ["--device", "cpu"]
ENV = {"OMP_NUM_THREADS": "1"}


def jax_run(extra):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *ARGS, *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def port_run(extra, **kw):
    ranks = MP.run_train_multiprocess(ARGS + PORT + extra, num_processes=4,
                                      timeout=180, env_extra=ENV, **kw)
    return ranks


def wait(p):
    out, err = p.communicate(timeout=240)
    assert p.returncode == 0, err[-3000:]
    return out


def copy_step(src, dst, step):
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.startswith(f"ckpt_{step:08d}."):
            shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(dst, "latest"), "w") as f:
        f.write(str(step))


def state(d, step):
    return TCK.checkpoint._load_verified(d, step)[0]


def close_states(got, want):
    """params atol 5e-5, FCCO state rtol 1e-4 / atol 1e-5, moments rtol
    1e-4 with atol 1e-5 of the leaf's scale, counters exact (those of
    tests/test_torch_launch.py)."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), k
        elif k.startswith("params/"):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5, err_msg=k)
        else:
            fin = np.isfinite(w)
            assert np.array_equal(fin, np.isfinite(g)), k
            scale = np.abs(w[fin]).max() if fin.any() else 0.0
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-4,
                                       atol=1e-5 * max(scale, 1.0),
                                       err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_launch")
    dj, dq = str(d / "jax"), str(d / "port")
    j1 = jax_run(["--ckpt-every", "2", "--ckpt-dir", dj])
    fresh = port_run(["--ckpt-every", "2", "--ckpt-dir", dq,
                      "--eval-every", "3", "--eval-classes", "4",
                      "--eval-per-class", "2"])
    assert [r.returncode for r in fresh] == [0] * 4, fresh[0].stderr[-3000:]
    wait(j1)
    dp, dk = str(d / "port_from_jax"), str(d / "jax_from_port")
    copy_step(dj, dp, 2)
    copy_step(dq, dk, 2)
    j2 = jax_run(["--ckpt-dir", dk, "--resume"])
    resumed = port_run(["--ckpt-dir", dp, "--resume"])
    assert [r.returncode for r in resumed] == [0] * 4, \
        resumed[0].stderr[-3000:]
    wait(j2)
    return dict(dj=dj, dq=dq, dp=dp, dk=dk, fresh=fresh, resumed=resumed,
                tmp=d)


def test_every_rank_logs_the_same_lines(runs):
    outs = [r.stdout.splitlines() for r in runs["fresh"]]
    first = [ln.split(" rank ")[0] for ln in (o[0] for o in outs)]
    assert first == ["mesh data:2,fsdp:2 backend gloo world 4"] * 4
    assert all(o[0].endswith(f"rank {i} device cpu")
               for i, o in enumerate(outs))
    body = [[ln for ln in o if ln.startswith(("step ", "eval "))]
            for o in outs]
    assert len([ln for ln in body[0] if ln.startswith("step ")]) == 3
    assert len([ln for ln in body[0] if ln.startswith("eval ")]) == 1
    assert all(b == body[0] for b in body)
    assert re.fullmatch(r"retrieval accuracy: [01]\.\d{4}", outs[0][-1])


def test_jax_mesh_checkpoint_resumes_in_the_port_four_ranks(runs):
    """JAX's step 3 from its step-2 checkpoint against the port's."""
    assert "resumed from step 2" in runs["resumed"][0].stdout
    close_states(state(runs["dp"], 3), state(runs["dj"], 3))


def test_port_mesh_checkpoint_resumes_in_jax(runs):
    names = os.listdir(runs["dq"])
    assert len([n for n in names if n.startswith("ckpt_00000002.rank")
                and n.endswith(".npz")]) == 4
    close_states(state(runs["dk"], 3), state(runs["dq"], 3))


def test_killed_group_resumes_from_rank_tagged_checkpoint(runs):
    """SIGKILL of every rank once the step-1 checkpoint is committed,
    then ``--resume``: the final state equals the uninterrupted run's
    bit for bit."""
    d = str(runs["tmp"] / "killed")
    latest = os.path.join(d, "latest")
    killed = port_run(["--ckpt-every", "1", "--ckpt-dir", d],
                      kill_when=lambda: os.path.exists(latest))
    assert any(r.returncode == -9 for r in killed), \
        [r.returncode for r in killed]
    step = TCK.latest_step(d)
    assert step is not None and step < 3
    resumed = port_run(["--ckpt-dir", d, "--resume"])
    assert [r.returncode for r in resumed] == [0] * 4, \
        resumed[0].stderr[-3000:]
    assert f"resumed from step {step}" in resumed[0].stdout
    got, want = state(d, 3), state(runs["dq"], 3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
