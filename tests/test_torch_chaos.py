"""The crash-recovery battery of tests/helpers/chaos_check.py, driving
the port's launcher (``repro_torch.launch.train``) on one CPU device:
SIGKILL of a real subprocess before a step and at mid-checkpoint-write
fault points, then ``--resume`` bitwise equal to the uninterrupted run;
an injected NaN batch under ``--guard`` a bitwise no-op, with prefetch 2
and 0 giving the same state; two bad steps rolled back and replayed
bitwise; SIGTERM with a final synchronous checkpoint and a bitwise
resume; async checkpoints with retention and the heartbeat; a loader
exception surfacing; and the streaming path bitwise equal to the
in-memory one, through a kill and a resume, with a decode-worker
exception surfacing."""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as TCK
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import get_arch
from repro_torch.data import ContrastiveDataset, write_contrastive_shards
from repro_torch.launch import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KILLS = ["kill@5", "kill_save@mid_npz", "kill_save@mid_sidecar"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the subprocesses: the CPU matmuls'
    bits depend on the thread count, and the killed subprocess's
    checkpoint must resume to the in-process run's bits (many threads in
    five processes would also oversubscribe the host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _args(steps, *extra):
    return ["--arch", "clip-vitb32-cc12m", "--reduced", "--global-batch",
            "16", "--n-samples", "64", "--steps", str(steps), "--log-every",
            "1", "--ckpt-every", "2", "--device", "cpu"] + list(extra)


def _flat(state):
    return {k: np.asarray(v) for k, v in flatten(
        bridge.state_to_tree(state)).items()}


def _bitwise(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        for k in a)


def _run(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = ttrain.main(args)
    return _flat(state), buf.getvalue()


def _spawn(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    """The clean 8-step run (under ``--guard``, a no-op on finite steps),
    the shards of its dataset, and the killed subprocesses, all started
    at once: three kill points in memory, ``kill@5`` streaming."""
    d = tmp_path_factory.mktemp("chaos")
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    shards = str(d / "shards")
    write_contrastive_shards(ContrastiveDataset(
        n=64, image_size=cfg.clip.image_size,
        context_length=cfg.clip.context_length, vocab_size=cfg.vocab_size,
        n_classes=64), shards, samples_per_shard=16)
    stream = ["--data", f"streaming:{shards}"]
    killed = {}
    for name, extra in [(spec, []) for spec in KILLS] + [
            ("streaming", stream)]:
        ck = str(d / name.replace("@", "_").replace(":", "_"))
        spec = "kill@5" if name == "streaming" else name
        killed[name] = (ck, extra, _spawn(_args(8, "--ckpt-dir", ck,
                                                "--chaos", spec, *extra)))
    oracle, _ = _run(_args(8, "--guard"))
    procs = {}
    for name, (ck, extra, p) in killed.items():
        out, err = p.communicate(timeout=240)
        procs[name] = dict(ck=ck, extra=extra, rc=p.returncode, out=out,
                           err=err)
    return dict(oracle=oracle, stream=stream, procs=procs, tmp=d)


@pytest.mark.parametrize("name,latest", [("kill@5", 4),
                                         ("kill_save@mid_npz", None),
                                         ("kill_save@mid_sidecar", None),
                                         ("streaming", 4)])
def test_kill_and_resume_is_bitwise(battery, name, latest):
    """``kill@5`` dies between checkpoints (step 4 is the newest); the
    ``kill_save`` points kill the first save (step 2) with its npz or its
    sidecar in a tmp file, so nothing is durable and the resume replays
    from the start."""
    p = battery["procs"][name]
    assert p["rc"] == -signal.SIGKILL, p["err"][-3000:]
    got = TCK.latest_step(p["ck"])
    assert got == latest
    if got is not None:
        assert TCK.verify_step(p["ck"], got)
    resumed, out = _run(_args(8, "--ckpt-dir", p["ck"], "--resume",
                              "--ckpt-every", "100", *p["extra"]))
    assert (f"resumed from step {latest}" in out) == (latest is not None)
    assert _bitwise(resumed, battery["oracle"])


def test_nan_batch_is_a_bitwise_noop(battery):
    ref, _ = _run(_args(2, "--guard"))
    poisoned, out = _run(_args(3, "--guard", "--chaos", "nan_batch@2"))
    assert _bitwise(ref, poisoned)
    assert out.count('"skipped": 1.0') == 1
    assert out.count('"skipped": 0.0') == 2


def test_skipped_step_keeps_the_prefetch_stream_in_sync(battery):
    a, _ = _run(_args(4, "--guard", "--chaos", "nan_batch@1", "--prefetch",
                      "2"))
    b, _ = _run(_args(4, "--guard", "--chaos", "nan_batch@1", "--prefetch",
                      "0"))
    assert _bitwise(a, b)


def test_rollback_replays_bitwise(battery):
    d = str(battery["tmp"] / "rollback")
    got, out = _run(_args(8, "--rollback-after", "2", "--ckpt-dir", d,
                          "--chaos", "nan_batch@4,nan_batch@5"))
    assert out.count("rollback: 2 consecutive bad steps; restored verified "
                     "step 4") == 1
    assert _bitwise(got, battery["oracle"])


def test_preemption_saves_and_resumes_bitwise(battery):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signals need the main thread")
    d = str(battery["tmp"] / "preempt")
    _, out = _run(_args(8, "--ckpt-dir", d, "--chaos", "sigterm@5"))
    assert "preempted (signal 15): saved synchronous checkpoint at step 6" \
        in out
    assert TCK.latest_step(d) == 6
    resumed, out = _run(_args(8, "--ckpt-dir", d, "--resume"))
    assert "resumed from step 6" in out
    assert _bitwise(resumed, battery["oracle"])


def test_async_checkpoints_retention_and_heartbeat(battery):
    d = str(battery["tmp"] / "async")
    got, _ = _run(_args(8, "--ckpt-dir", d, "--ckpt-async", "--ckpt-keep",
                        "2", "--ckpt-keep-every", "8"))
    assert _bitwise(got, battery["oracle"])
    assert TCK.available_steps(d) == [6, 8] and TCK.latest_step(d) == 8
    tree, at, meta = TCK.restore(d, TCK.unflatten(got))
    assert at == 8 and meta == {"arch": "clip-vitb32-cc12m",
                                "version": "v3"}
    assert _bitwise(flatten(tree), got)
    with open(os.path.join(d, "heartbeat.json")) as f:
        hb = json.load(f)
    assert hb["step"] == 7 and hb["pid"] == os.getpid()


def test_loader_exception_surfaces(battery):
    with pytest.raises(RuntimeError,
                       match="chaos: injected loader failure at step 3"):
        _run(_args(6, "--chaos", "loader_raise@3"))


def test_streaming_trains_as_in_memory(battery):
    got, _ = _run(_args(8, "--guard", "--decode-workers", "3",
                        *battery["stream"]))
    assert _bitwise(got, battery["oracle"])


def test_decode_worker_exception_surfaces(battery):
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(RuntimeError,
                       match="chaos: injected decode failure at step 2"):
        _run(_args(6, "--chaos", "decode_raise@2", *battery["stream"]))
    for t in threading.enumerate():
        if t.ident not in before and t.name.startswith("decode"):
            t.join(timeout=10.0)
            assert not t.is_alive(), t.name
