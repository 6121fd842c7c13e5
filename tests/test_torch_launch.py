"""The port's training launcher (``repro_torch.launch.train``) and data
pipeline on the CPU: the JAX launcher's line format, SIGTERM with a final
checkpoint and a bitwise resume, train-state checkpoints exchanged with
``repro.launch.train`` in both directions (the next step matches within
the tolerances of tests/test_torch_train.py), refusals of what is not
ported (the resilience flags' bad values: tests/test_torch_resilience.py),
the default device, and batches and index plans equal to the JAX
package's bit for bit."""
import json
import os
import re
import shutil
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.data import ContrastiveDataset as JCD
from repro.data import ShardedLoader as JSL
from repro.launch import train as jtrain
from repro_torch import checkpoint as TCK
from repro_torch.checkpoint import bridge, flatten
from repro_torch.configs import get_arch
from repro_torch.core import fastclip as FC
from repro_torch.core import train_step as TS
from repro_torch.core.schedules import lr_warmup_cosine
from repro_torch.data import ContrastiveDataset as TCD
from repro_torch.data import DevicePrefetcher
from repro_torch.data import ShardedLoader as TSL
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

BASE = ["--arch", "clip-vitb32-cc12m", "--reduced", "--global-batch", "16",
        "--n-samples", "32", "--log-every", "1", "--lr", "2e-3"]
CPU = ["--device", "cpu"]
KEYS = ["gamma", "grad_norm", "loss", "loss_value", "lr", "sat_rate", "tau",
        "u_mean"]


def flat(state):
    return {k: np.asarray(v) for k, v in flatten(
        bridge.state_to_tree(state)).items()}


def jflat(state):
    from repro.checkpoint.checkpoint import _path_str
    return {_path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def copy_step(src, dst, step):
    os.makedirs(dst)
    for ext in ("npz", "json"):
        name = f"ckpt_{step:08d}.{ext}"
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(dst, "latest"), "w") as f:
        f.write(str(step))


def close_states(got, want):
    """The next step from the same state in both packages: params atol
    5e-5, FCCO state rtol 1e-4 / atol 1e-5, moments rtol 1e-4 with atol
    1e-5 of the leaf's scale, counters exact."""
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


def test_launcher_prints_the_jax_line_format(capsys):
    state = ttrain.main(BASE + CPU + ["--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    steps = [ln for ln in out if ln.startswith("step ")]
    assert len(steps) == 4
    for i, ln in enumerate(steps):
        m = re.fullmatch(r"step +(\d+) epoch (\d+) (\{.*\})", ln)
        assert m and int(m.group(1)) == i and int(m.group(2)) == i // 2
        msg = json.loads(m.group(3))
        assert list(msg) == KEYS
        assert all(np.isfinite(v) for v in msg.values())
    assert re.fullmatch(r"trained 4 steps in [0-9.]+s \([0-9.]+ steps/s\)",
                        out[-2])
    assert re.fullmatch(r"retrieval accuracy: [01]\.\d{4}", out[-1])
    assert int(state["step"]) == 4
    TS.check_state_dtypes(state)


class _SigtermAt(list):
    """A record list that sends this process SIGTERM after step ``at``."""

    def __init__(self, at):
        super().__init__()
        self.at = at

    def append(self, item):
        super().append(item)
        if item["step"] == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_checkpoint_and_resume_are_bitwise(tmp_path, capsys):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signals need the main thread")
    args = BASE + CPU + ["--steps", "4", "--ckpt-every", "100"]
    full = flat(ttrain.main(args))
    d = str(tmp_path / "ck")
    rec = _SigtermAt(1)
    ttrain.main(args + ["--ckpt-dir", d], record=rec)
    assert "preempted (signal 15): saved synchronous checkpoint at step 2" \
        in capsys.readouterr().out
    assert TCK.latest_step(d) == 2 and [r["step"] for r in rec] == [0, 1]
    resumed = flat(ttrain.main(args + ["--ckpt-dir", d, "--resume"]))
    assert "resumed from step 2" in capsys.readouterr().out
    assert sorted(resumed) == sorted(full)
    for k in full:
        assert resumed[k].tobytes() == full[k].tobytes(), k
    assert TCK.latest_step(d) == 4
    with open(os.path.join(d, "heartbeat.json")) as f:
        assert json.load(f)["step"] == 3


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX train state at step 2 resumes in the port, and the port's in
    JAX: the third step of each matches the other package's third step
    from the same state."""
    args = BASE + ["--steps", "3", "--ckpt-every", "2"]
    # JAX -> port
    dj = str(tmp_path / "jax")
    jstate = jtrain.main(args + ["--ckpt-dir", dj])
    dp = str(tmp_path / "port_from_jax")
    copy_step(dj, dp, 2)
    tstate = ttrain.main(args + CPU + ["--ckpt-dir", dp, "--resume"])
    close_states(flat(tstate), jflat(jstate))
    # port -> JAX
    dq = str(tmp_path / "port")
    tstate = ttrain.main(args + CPU + ["--ckpt-dir", dq])
    dk = str(tmp_path / "jax_from_port")
    copy_step(dq, dk, 2)
    jstate = jtrain.main(args + ["--ckpt-dir", dk, "--resume"])
    close_states(flat(tstate), jflat(jstate))
    # and the checkpoint itself restores in JAX's own reader
    like = jax.tree.map(np.zeros_like, jstate)
    tree, step, meta = JCK.restore(dq, like)
    assert step == 3 and meta == {"arch": "clip-vitb32-cc12m",
                                  "version": "v3"}


@pytest.mark.parametrize("flag", [["--arch", "llama-3.2-vision-11b",
                                   "--mesh", "data:1,fsdp:1"]])
def test_unported_flags_are_refused(flag, capsys):
    """An edge the launcher refuses: the vlm on the mesh.  The vlm and
    audio families train through the step functions, but no launcher
    can feed them (ROADMAP F6: the datasets carry no stub inputs, in
    JAX's launcher too), with ``--mesh`` as without (``--mesh`` with an
    LM backbone's contrastive objective and the moe family, the edges
    this case held before, are ported)."""
    with pytest.raises(SystemExit) as e:
        ttrain.main(BASE + CPU + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "F6" in err and "image_embeds" in err and "not ported" not in err


@pytest.mark.parametrize("flag,why", [
    (["--local-devices", "2"], "one process with one device"),
    (["--num-processes", "2"], "require --mesh"),
    (["--microbatch", "2"], "needs --mesh"),
])
def test_flags_without_meaning_here_are_refused(flag, why, capsys):
    """``--local-devices`` (JAX's forced CPU devices per process) has no
    counterpart; the rank flags and ``--microbatch`` need ``--mesh``."""
    with pytest.raises(SystemExit) as e:
        ttrain.main(BASE + CPU + flag)
    assert e.value.code == 2
    assert why in capsys.readouterr().err


def test_resume_metadata_mismatch_is_refused(tmp_path):
    d = str(tmp_path / "ck")
    ttrain.main(BASE + CPU + ["--steps", "2", "--ckpt-dir", d])
    with pytest.raises(SystemExit, match="version"):
        ttrain.main(BASE + CPU + ["--steps", "3", "--ckpt-dir", d,
                                  "--resume", "--version", "v2"])


def test_training_entry_points_need_the_card():
    """Without CUDA the launcher, ``init_train_state`` and
    ``make_train_step`` raise instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    tc = TS.TrainStepConfig(arch=cfg, fc=FC.FastCLIPConfig(n_samples=8),
                            optimizer=adamw(),
                            lr_fn=lr_warmup_cosine(1e-3, 1, 4))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ttrain.main(BASE + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TS.init_train_state(torch.Generator().manual_seed(0), tc)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TS.make_train_step(tc)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,n_shards,start", [
    (dict(n=48, image_size=16, context_length=12, vocab_size=100), 1, 0),
    (dict(n=64, image_size=32, context_length=16, vocab_size=512,
          n_classes=5, noise=0.1, seed=3), 2, 5),
])
def test_batches_and_index_plans_equal_jax(kw, n_shards, start):
    j, t = JCD(**kw), TCD(**kw)
    idx = np.arange(j.n)[::-3]
    for k, v in j.batch(idx).items():
        w = t.batch(idx)[k]
        assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), k
    jl = JSL(j, global_batch=16, n_shards=n_shards, seed=7)
    tl = TSL(t, global_batch=16, n_shards=n_shards, seed=7)
    assert tl.steps_per_epoch == jl.steps_per_epoch
    got = list(tl.steps(9, start=start))
    want = list(jl.steps(9, start=start))
    assert len(got) == len(want) == 9 - start
    for (e, s, i, b), (we, ws, wi, wb) in zip(got, want):
        assert (e, s) == (we, ws) and i.tobytes() == wi.tobytes()
        assert all(b[k].tobytes() == wb[k].tobytes() for k in wb)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        TSL(t, global_batch=2 * t.n)


def test_prefetcher_order_errors_and_close():
    out = list(DevicePrefetcher(iter(range(20)), depth=3,
                                transform=lambda x: x * 2))
    assert out == [2 * i for i in range(20)]

    def boom():
        yield 1
        yield 2
        raise KeyError("at 3")

    it = DevicePrefetcher(boom(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="at 3"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it = DevicePrefetcher(iter(range(10 ** 6)), depth=2)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
