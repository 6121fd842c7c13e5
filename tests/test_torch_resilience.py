"""The port's resilience modules on the CPU, held to the JAX package:
``SpikeDetector``, the checkpoint writer's fault events, the async
checkpointer and retention (checkpoints restore across the packages
bitwise), the damaged-step fallback for every kill point, the chaos
training hooks, the prefetcher's contracts and the loader's
fast-forward; the default device of ``multiprocess.initialize``; the
refusal of the new flags' bad values; and the slice as a whole: both
launchers resume one step-2 state and run to step 8 over JAX-written
shards with both curricula, a rollback, async saves and retention."""
import contextlib
import io
import json
import math
import os
import re
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro import resilience as JRS
from repro.data import ContrastiveDataset as JCD
from repro.data import write_contrastive_shards as jwrite
from repro.launch import train as jtrain
from repro_torch import checkpoint as TCK
from repro_torch import resilience as TRS
from repro_torch.checkpoint import checkpoint as TCKM
from repro_torch.configs import get_arch
from repro_torch.data import (DevicePrefetcher, ShardedLoader,
                              StreamingDataset, StreamingLoader,
                              write_contrastive_shards)
from repro_torch.data import ContrastiveDataset as TCD
from repro_torch.launch import multiprocess as MP
from repro_torch.launch import train as ttrain


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the launcher runs here (the suite's
    workers share the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# SpikeDetector
# ---------------------------------------------------------------------------

def _loss_sequence():
    rng = np.random.default_rng(0)
    seq = [(1.0 + 0.01 * rng.standard_normal(), False) for _ in range(30)]
    seq[12] = (float("nan"), False)
    seq[13] = (1.0, True)
    seq[20] = (50.0, False)                  # spike after warm-up
    seq[21] = (float("inf"), False)
    seq[25] = (1.0, True)
    return seq


@pytest.mark.parametrize("kw", [dict(rollback_after=2),
                                dict(rollback_after=1, warmup=5),
                                dict(rollback_after=3, ema=0.5, zmax=3.0),
                                dict(rollback_after=0)])
def test_spike_detector_decides_as_jax(kw):
    t, j = TRS.SpikeDetector(**kw), JRS.SpikeDetector(**kw)
    for loss, skipped in _loss_sequence():
        got, want = t.update(loss, skipped), j.update(loss, skipped)
        assert got == want
        if got:
            t.reset()
            j.reset()
        assert (t.mean, t.mad, t.n_good, t.consecutive_bad) == (
            j.mean, j.mad, j.n_good, j.consecutive_bad)


def test_spike_detector_escalation_warmup_and_disabled():
    det = TRS.SpikeDetector(rollback_after=2)
    for i in range(20):
        assert det.update(1.0 + 0.01 * i) is False
    assert det.update(float("nan")) is False
    assert det.update(1.0, skipped=True) is True
    det.reset()
    assert det.consecutive_bad == 0
    det = TRS.SpikeDetector(rollback_after=1, warmup=5)
    for _ in range(10):
        assert det.update(1.0) is False
    assert det.update(100.0) is True
    assert TRS.SpikeDetector(rollback_after=1, warmup=5).update(100.0) \
        is False
    det = TRS.SpikeDetector(rollback_after=0)
    for _ in range(5):
        assert det.update(float("nan")) is False
    assert det.consecutive_bad == 5 and math.isfinite(det.mean)


# ---------------------------------------------------------------------------
# Checkpoint writer: fault events, retention, async
# ---------------------------------------------------------------------------

def _tree(v):
    return {"w": np.linspace(0, 1, 12, dtype=np.float32) + v,
            "b": np.full((3,), v, np.float32)}


def _events(mod, fn):
    got = []
    mod.set_fault_hook(got.append)
    try:
        fn()
    finally:
        mod.set_fault_hook(None)
    return got


def _two_rank_step(mod, d, step, v):
    """A genuine two-rank step of ``mod``'s writer: rank 1 on a thread,
    rank 0 here (no fault hook: the hook is module-wide)."""
    local = {"fc/u1": (0, np.full((2,), v, np.float32))}
    t = threading.Thread(target=mod._write_step, args=(
        d, step, {}, {}, ["fc/u1"], None), kwargs=dict(
        local={"fc/u1": (2, np.full((2,), -v, np.float32))},
        process_index=1, process_count=2, barrier_timeout=30.0))
    t.start()
    mod._write_step(d, step, {"w": [np.full((4,), v, np.float32)]}, {},
                    ["fc/u1", "w"], None, local=local, process_index=0,
                    process_count=2, barrier_timeout=30.0)
    t.join(timeout=30.0)


@pytest.mark.parametrize("case", ["plain", "sharded", "retention"])
def test_fault_events_match_jax(tmp_path, case):
    """The stages a save announces, in order, are the same list in both
    packages, so ``kill_save@EVENT:N`` names the same file in both."""
    pieces = {"a": [np.ones((2, 3), np.float32), np.zeros((2, 3),
                                                          np.float32)],
              "b": [np.arange(4, dtype=np.int32)]}

    def run(mod, d):
        if case == "plain":
            return _events(mod, lambda: mod.save(d, _tree(1.0), 1))
        if case == "sharded":
            return _events(mod, lambda: mod._write_step(
                d, 1, pieces, {"a": 0}, ["a", "b"], None))
        for s in (1, 2):
            mod.save(d, _tree(float(s)), s)
        return _events(mod, lambda: mod._write_step(
            d, 3, {"w": [np.ones(3, np.float32)]}, {}, ["w"], None,
            keep_last=1))

    got = run(TCKM, str(tmp_path / "t"))
    want = run(JCK.checkpoint, str(tmp_path / "j"))
    assert got == want
    assert got[0] == "pre_npz" and got[-1] == "done"
    if case == "sharded":
        assert got.count("mid_npz") == 2
    if case == "retention":
        assert TCK.available_steps(str(tmp_path / "t")) == [3]


@pytest.mark.parametrize("keep_last,keep_every", [(2, 3), (1, 0), (3, 2)])
def test_prune_keeps_the_steps_jax_keeps(tmp_path, keep_last, keep_every):
    dirs = {}
    for name, mod in (("t", TCKM), ("j", JCK.checkpoint)):
        d = dirs[name] = str(tmp_path / name)
        for s in range(1, 5):
            mod.save(d, _tree(float(s)), s)
        for s in (5, 6):
            _two_rank_step(mod, d, s, float(s))
    got = TCK.prune_checkpoints(dirs["t"], keep_last, keep_every)
    want = JCK.prune_checkpoints(dirs["j"], keep_last, keep_every)
    assert got == want
    assert sorted(os.listdir(dirs["t"])) == sorted(os.listdir(dirs["j"]))
    # the rank-tagged files of a pruned step go with it
    for name in os.listdir(dirs["t"]):
        m = re.match(r"ckpt_(\d{8})\.", name)
        if m:
            assert int(m.group(1)) in TCK.available_steps(dirs["t"])
    assert TCK.prune_checkpoints(dirs["t"], keep_last=0) == []


def _state_like(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((5, 4), generator=g),
                       "b": torch.randn((4,), generator=g)},
            "opt": {"t": torch.tensor(3, dtype=torch.int32)},
            "fc": {"u1": torch.full((6,), -math.inf)}}


def test_async_checkpoints_restore_across_the_packages(tmp_path):
    """A port ``AsyncCheckpointer`` save restores bitwise in JAX's
    ``restore``, and a JAX async save in the port's."""
    live = _state_like(0)
    dt = str(tmp_path / "port")
    ac = TCK.AsyncCheckpointer(dt)
    ac.save(live, 7, metadata={"arch": "x"})
    ac.close()
    want = TCK.flatten(live)
    like = jax.tree.map(np.zeros_like, {k: {n: np.asarray(v) for n, v in
                                            d.items()}
                                        for k, d in live.items()})
    tree, step, meta = JCK.restore(dt, like)
    assert step == 7 and meta == {"arch": "x"}
    for k, v in TCK.flatten(tree).items():
        assert np.asarray(v).tobytes() == want[k].numpy().tobytes(), k

    dj = str(tmp_path / "jax")
    jac = JCK.AsyncCheckpointer(dj, keep_last=1)
    host = {k: {n: v.numpy() for n, v in d.items()}
            for k, d in _state_like(1).items()}
    jac.save(host, 2)
    jac.save(jax.tree.map(lambda a: a + 1, host), 3)
    jac.close()
    got, step, _ = TCK.restore(dj, _state_like(5))
    assert step == 3 and TCK.available_steps(dj) == [3]
    want = TCK.flatten(host)
    for k, v in TCK.flatten(got).items():
        assert v.tobytes() == (want[k] + 1).tobytes(), k


def test_async_checkpointer_roundtrip_and_error_latch(tmp_path):
    d = str(tmp_path / "ok")
    ac = TCK.AsyncCheckpointer(d)
    for s in (1, 2, 3):
        ac.save(_tree(float(s)), s, metadata={"s": s})
    ac.wait()
    assert TCK.available_steps(d) == [1, 2, 3]
    restored, step, meta = TCK.restore(d, _tree(0.0))
    assert step == 3 and meta == {"s": 3}
    assert np.array_equal(restored["w"], _tree(3.0)["w"])
    ac.close()
    blocked = str(tmp_path / "blocked")
    with open(blocked, "w") as f:
        f.write("not a directory")
    ac2 = TCK.AsyncCheckpointer(blocked)
    ac2.save(_tree(1.0), 1)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ac2.wait()
    ac2.save(_tree(1.0), 2)             # the latch was raised once
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ac2.close()


def test_async_snapshot_is_mutation_safe(tmp_path):
    """``save`` copies: in-place updates of the live tensors (the
    optimizer's, on CPU tensors whose ``.numpy()`` aliases them) right
    after ``save`` do not reach the written checkpoint."""
    d = str(tmp_path)
    live = _state_like(0)
    want = {k: v.clone() for k, v in TCK.flatten(live).items()}
    block = threading.Event()
    TCK.set_fault_hook(lambda ev: block.wait(10.0) if ev == "pre_npz"
                       else None)
    try:
        ac = TCK.AsyncCheckpointer(d)
        ac.save(live, 1)
        with torch.no_grad():
            for v in TCK.flatten(live).values():
                v.fill_(-777)
        block.set()
        ac.close()
    finally:
        TCK.set_fault_hook(None)
    got, _, _ = TCK.restore(d, live)
    for k, v in TCK.flatten(got).items():
        assert v.tobytes() == want[k].numpy().tobytes(), k


def test_retention_applies_on_async_saves(tmp_path):
    d = str(tmp_path)
    ac = TCK.AsyncCheckpointer(d, keep_last=2, keep_every=2)
    for s in range(1, 6):
        ac.save(_tree(float(s)), s)
    ac.close()
    assert TCK.available_steps(d) == [2, 4, 5]


@pytest.mark.parametrize("damage", ["truncate_npz", "flip_npz",
                                    "truncate_sidecar", "delete_npz"])
def test_restore_falls_back_past_damaged_newest_step(tmp_path, damage):
    d = str(tmp_path)
    TCK.save(d, _tree(1.0), 1)
    TCK.save(d, _tree(2.0), 2)
    npz2 = os.path.join(d, "ckpt_00000002.npz")
    if damage == "truncate_npz":
        TRS.truncate_file(npz2, 40)
    elif damage == "flip_npz":
        TRS.flip_byte(npz2, os.path.getsize(npz2) // 2)
    elif damage == "truncate_sidecar":
        TRS.truncate_file(os.path.join(d, "ckpt_00000002.json"), 10)
    else:
        os.remove(npz2)
    assert TCK.latest_step(d) == 1
    restored, step, _ = TCK.restore(d, _tree(0.0))
    assert step == 1 and np.array_equal(restored["b"], _tree(1.0)["b"])


class _SimKill(BaseException):
    pass


@pytest.mark.parametrize("event", ["pre_npz", "mid_npz", "npz",
                                   "mid_sidecar", "sidecar", "mid_latest",
                                   "latest", "done"])
def test_every_kill_point_leaves_a_verified_latest(tmp_path, event):
    """A kill at any stage of the step-2 save: ``latest_step`` returns a
    step that verifies and restores (2 once its sidecar is in place)."""
    d = str(tmp_path)
    TCK.save(d, _tree(1.0), 1)

    def boom(ev):
        if ev == event:
            raise _SimKill()

    TCK.set_fault_hook(boom)
    try:
        with pytest.raises(_SimKill):
            TCK.save(d, _tree(2.0), 2)
    finally:
        TCK.set_fault_hook(None)
    want = 1 if event in ("pre_npz", "mid_npz", "npz", "mid_sidecar") else 2
    assert TCK.latest_step(d) == want and TCK.verify_step(d, want)
    restored, step, _ = TCK.restore(d, _tree(0.0))
    assert step == want
    assert np.array_equal(restored["w"], _tree(float(want))["w"])
    assert not [n for n in os.listdir(d) if ".tmp." in n]


def test_digests_and_tmp_files(tmp_path):
    d = str(tmp_path)
    TCK.save(d, _tree(1.0), 1)
    TCK.save(d, _tree(2.0), 2)
    p2 = os.path.join(d, "ckpt_00000002.npz")
    with np.load(p2) as f:
        data = {k: f[k].copy() for k in f.files}
    data["w"][0] += 1.0
    np.savez_compressed(p2, **data)     # the zip's own CRC is happy
    assert not TCK.verify_step(d, 2) and TCK.latest_step(d) == 1
    with pytest.raises(ValueError, match="digest mismatch"):
        TCK.restore(d, _tree(0.0), step=2)
    for name in ["ckpt_00000003.npz.tmp.123", "ckpt_00000009.json.tmp.7",
                 "latest.tmp.42"]:
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"partial garbage")
    assert TCK.available_steps(d) == [1, 2] and TCK.latest_step(d) == 1


# ---------------------------------------------------------------------------
# Chaos training hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,shape", [(0, 2, (16, 32, 32, 3)),
                                             (11, 3, (8, 4)),
                                             (5, 40, (256, 2))])
def test_nan_batch_poisons_jax_row(seed, step, shape):
    batch = {"texts": np.zeros((shape[0], 4), np.int32),
             "images": np.ones(shape, np.float32)}
    spec = f"nan_batch@{step}"
    got = TRS.ChaosInjector(spec, seed=seed).poison_batch(step, batch)
    want = JRS.ChaosInjector(spec, seed=seed).poison_batch(step, batch)
    for k in batch:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert np.isnan(got["images"]).any() and not np.isnan(
        batch["images"]).any()
    inj = TRS.ChaosInjector(spec, seed=seed)
    inj.poison_batch(step, batch)
    assert inj.poison_batch(step, batch) is batch       # fires once


def test_kill_save_and_step_hooks_fire_as_jax():
    spec = "kill@2,sigterm@7,kill_save@npz:2,kill_save@mid_npz:3"
    events = ["pre_npz", "mid_npz", "npz"] * 4 + ["done"]
    fired = {}
    for name, mod in (("t", TRS), ("j", JRS)):
        log = []
        inj = mod.ChaosInjector(spec, kill_fn=lambda log=log: log.append(
            "kill"))
        for i, ev in enumerate(events):
            inj.checkpoint_event(ev)
            log.append((i, len(log)))
        for s in (0, 2, 2, 3):
            inj.pre_step(s)
            log.append(("step", s, log.count("kill")))
        fired[name] = log
    assert fired["t"] == fired["j"]
    assert fired["t"].count("kill") == 3
    for spec in ("explode@3", "nan_batch@x", "kill_save@", "slow_batch@3"):
        with pytest.raises(ValueError):
            TRS.parse_chaos(spec)
        with pytest.raises(ValueError):
            JRS.parse_chaos(spec)
    with pytest.raises(RuntimeError, match="injected loader failure"):
        TRS.ChaosInjector("loader_raise@1").on_loader(1)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        TRS.ChaosInjector("decode_raise@4").on_decode(4)


# ---------------------------------------------------------------------------
# DevicePrefetcher and the loader's fast-forward
# ---------------------------------------------------------------------------

def test_prefetcher_exception_at_position_and_latched():
    def gen():
        yield 0
        yield 1
        raise ValueError("boom at 2")

    pf = DevicePrefetcher(gen(), depth=2)
    assert next(pf) == 0 and next(pf) == 1
    with pytest.raises(ValueError, match="boom at 2"):
        next(pf)
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(pf)


def test_prefetcher_close_unblocks_mid_put_producer():
    pf = DevicePrefetcher(iter(int, 1), depth=1)     # infinite zeros
    assert next(pf) == 0
    time.sleep(0.05)                                 # producer in put()
    pf.close()
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


@pytest.mark.parametrize("depth", [3, 4, 8])
def test_prefetcher_deep_preserves_order(depth):
    calls = []

    def tf(x):
        calls.append(x)
        return x * 3

    pf = DevicePrefetcher(iter(range(25)), depth=depth, transform=tf)
    assert list(pf) == [3 * i for i in range(25)]
    assert sorted(calls) == list(range(25))


@pytest.mark.parametrize("depth", [4, 8])
def test_prefetcher_deep_exception_at_position(depth):
    def gen():
        yield from range(5)
        raise ValueError("boom at 5")

    got = []
    with pytest.raises(ValueError, match="boom at 5"):
        for x in DevicePrefetcher(gen(), depth=depth):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def _shards(tmp_path, n=64):
    ds = TCD(n=n, image_size=32, context_length=16, vocab_size=512,
             n_classes=8)
    root = str(tmp_path / "shards")
    write_contrastive_shards(ds, root, samples_per_shard=16)
    return ds, root


def test_prefetcher_over_the_decode_pool(tmp_path):
    """The launcher's streaming stack: oracle order under a depth-4
    prefetcher; a decode-worker error lands at its step; closing
    mid-stream shuts the decode pool down (no thread left behind)."""
    ds, root = _shards(tmp_path)

    def make(**kw):
        return StreamingLoader(StreamingDataset(root), global_batch=16,
                               n_shards=4, seed=2, workers=3,
                               decode_ahead=4, **kw)

    oracle = list(ShardedLoader(ds, global_batch=16, n_shards=4,
                                seed=2).steps(10))
    strm = make()
    got = list(DevicePrefetcher(strm.steps(10), depth=4))
    assert len(got) == 10
    for (e1, s1, i1, b1), (e2, s2, i2, b2) in zip(oracle, got):
        assert (e1, s1) == (e2, s2) and np.array_equal(i1, i2)
        assert all(b1[k].tobytes() == b2[k].tobytes() for k in b1)
    strm.dataset.close()

    def hook(step):
        if step == 3:
            raise RuntimeError("decode boom at 3")

    strm = make(fault_hook=hook)
    steps = []
    with pytest.raises(RuntimeError, match="decode boom at 3"):
        for _e, step, _i, _b in DevicePrefetcher(strm.steps(8), depth=4):
            steps.append(step)
    assert steps == [0, 1, 2]
    strm.dataset.close()

    before = {t.ident for t in threading.enumerate()}
    strm = make()
    pf = DevicePrefetcher(strm.steps(10), depth=4)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and any(
            t.name.startswith("decode") and t.ident not in before
            for t in threading.enumerate()):
        time.sleep(0.02)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("decode") and t.ident not in before]
    with pytest.raises(StopIteration):
        next(pf)
    strm.dataset.close()


class _CountingDataset:
    def __init__(self, n):
        self.n = n
        self.batch_calls = 0

    def batch(self, idx):
        self.batch_calls += 1
        return {"x": np.asarray(idx, np.int64) * 10}


def test_loader_start_assembles_no_batch_before_it():
    full = ShardedLoader(_CountingDataset(16), global_batch=4, n_shards=2,
                         seed=3)
    want = [it for it in full.steps(11) if it[1] >= 5]
    ds = _CountingDataset(16)
    loader = ShardedLoader(ds, global_batch=4, n_shards=2, seed=3)
    perms = []
    orig = loader._epoch_perms
    loader._epoch_perms = lambda e: perms.append(e) or orig(e)
    got = list(loader.steps(11, start=5))
    assert ds.batch_calls == len(got) == len(want) == 6
    assert perms == [1, 2]                   # epoch 0 drew no permutation
    for (e1, s1, i1, b1), (e2, s2, i2, b2) in zip(want, got):
        assert (e1, s1) == (e2, s2) and np.array_equal(i1, i2)
        assert np.array_equal(b1["x"], b2["x"])


# ---------------------------------------------------------------------------
# multiprocess.initialize: the card by default
# ---------------------------------------------------------------------------

def test_initialize_defaults_to_the_card(tmp_path):
    """Without a device argument ``initialize`` asks for the card, and
    on a host without CUDA refuses as the launchers do, before it joins
    any group."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        MP.initialize(store, 1, 0)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        MP.initialize(None)
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# Bad values of the new flags are refused (as the JAX package refuses them)
# ---------------------------------------------------------------------------

BASE = ["--arch", "clip-vitb32-cc12m", "--reduced", "--global-batch", "16",
        "--n-samples", "32", "--log-every", "1", "--device", "cpu",
        "--steps", "1"]


@pytest.mark.parametrize("flag,why", [
    (["--image-size-schedule", "5:16"], "step 0"),
    (["--context-schedule", "4:8,0:16,4:4"], "duplicate"),
    (["--context-schedule", "0:8,x"], "unparseable"),
    (["--image-size-schedule", "0:24"], "must divide"),
    (["--chaos", "nan_batch@x"], "unparseable chaos"),
    (["--chaos", "explode@3"], "unparseable chaos"),
    (["--data", "webdataset:/x"], "want 'synthetic'"),
])
def test_bad_flag_values_are_refused(flag, why, capsys):
    with pytest.raises(SystemExit) as e:
        ttrain.main(BASE + flag)
    assert e.value.code == 2 and why in capsys.readouterr().err


def test_bad_shard_directories_are_refused(tmp_path):
    with pytest.raises(SystemExit, match="has no index.json"):
        ttrain.main(BASE + ["--data", f"streaming:{tmp_path / 'none'}"])
    _, root = _shards(tmp_path, n=32)
    idx = os.path.join(root, "index.json")
    with open(idx) as f:
        side = json.load(f)
    side["version"] = 99
    with open(idx, "w") as f:
        json.dump(side, f)
    with pytest.raises(SystemExit, match="format version 99"):
        ttrain.main(BASE + ["--data", f"streaming:{root}"])


# ---------------------------------------------------------------------------
# The slice against the JAX launcher
# ---------------------------------------------------------------------------

SLICE = ["--arch", "clip-vitb32-cc12m", "--reduced", "--global-batch", "16",
         "--log-every", "1", "--steps", "8", "--impl", "chunked",
         "--loss-impl", "dense", "--image-size-schedule", "0:16,4:32",
         "--context-schedule", "0:8,4:16", "--rollback-after", "2",
         "--chaos", "nan_batch@4,nan_batch@5", "--ckpt-every", "2",
         "--ckpt-async", "--ckpt-keep", "2"]
LINE = re.compile(r"^step +(\d+) epoch \d+ (\{.*\})$")


def _lines(out):
    steps, rollbacks = [], []
    for i, ln in enumerate(out.splitlines()):
        m = LINE.match(ln)
        if m:
            steps.append((int(m.group(1)), json.loads(m.group(2))))
        elif ln.startswith("rollback:"):
            rollbacks.append((len(steps), ln))
    return steps, rollbacks


class _StopAfter(list):
    """A record list that stops the launcher once step ``at`` ran."""

    def __init__(self, at):
        super().__init__()
        self.at = at

    def append(self, item):
        super().append(item)
        if item["step"] == self.at:
            raise _SimKill()


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """Both launchers resume the same step-2 state (the port's, stopped
    after step 2 was saved) and run to step 8 under the slice's flags:
    the packages seed their random weights differently."""
    d = tmp_path_factory.mktemp("slice")
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    ds = JCD(n=32, image_size=cfg.clip.image_size,
             context_length=cfg.clip.context_length,
             vocab_size=cfg.vocab_size, n_classes=64)
    shards = str(d / "shards")
    jwrite(ds, shards, samples_per_shard=8)
    data = ["--data", f"streaming:{shards}"]
    prefix = str(d / "prefix")
    sync = [a for a in SLICE if a != "--ckpt-async"]
    with pytest.raises(_SimKill), contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(sync + data + ["--device", "cpu", "--ckpt-dir", prefix],
                    record=_StopAfter(2))
    assert TCK.latest_step(prefix) == 2
    out = {}
    for name, main, extra in (("jax", jtrain.main, []),
                              ("port", ttrain.main, ["--device", "cpu"])):
        ck = str(d / name)
        os.makedirs(ck)
        for f in os.listdir(prefix):
            if f.startswith("ckpt_00000002.") or f == "latest":
                shutil.copy(os.path.join(prefix, f), os.path.join(ck, f))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = main(SLICE + data + extra + ["--ckpt-dir", ck,
                                                 "--resume"])
        out[name] = dict(state=state, out=buf.getvalue(), ck=ck)
    return out


def test_slice_rolls_back_at_the_jax_step(slice_runs):
    """The same rollback line after the same steps; loss and tau of every
    line within 1e-5 (one unit of the printed fifth decimal)."""
    j, t = (_lines(slice_runs[k]["out"]) for k in ("jax", "port"))
    assert all("resumed from step 2" in slice_runs[k]["out"]
               for k in ("jax", "port"))
    assert len(j[1]) == len(t[1]) == 1 and j[1] == t[1]
    assert "restored verified step 4" in t[1][0][1]
    assert [s for s, _ in t[0]] == [s for s, _ in j[0]] == [
        2, 3, 4, 5, 4, 5, 6, 7]
    for (s, got), (_, want) in zip(t[0], j[0]):
        assert got["skipped"] == want["skipped"], s
        for k in ("loss", "tau"):
            if math.isfinite(want[k]):
                assert round(abs(got[k] - want[k]), 9) <= 1e-5, (s, k)
            else:
                assert not math.isfinite(got[k]), (s, k)


def test_slice_final_state_and_kept_checkpoints_match_jax(slice_runs):
    """Params within 5e-5, log-u within 1e-4, counters equal; the same
    kept checkpoints."""
    from repro.checkpoint.checkpoint import _path_str
    from repro_torch.checkpoint import bridge
    jflat = {_path_str(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(
                 slice_runs["jax"]["state"])[0]}
    tflat = {k: np.asarray(v) for k, v in TCK.flatten(bridge.state_to_tree(
        slice_runs["port"]["state"])).items()}
    assert sorted(tflat) == sorted(jflat)
    for k, w in jflat.items():
        g = tflat[k]
        if k.startswith("params/"):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5, err_msg=k)
        elif k in ("fc/u1", "fc/u2"):
            fin = np.isfinite(w)
            assert np.array_equal(fin, np.isfinite(g)), k
            np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-4,
                                       err_msg=k)
        elif np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), k
    kept = [TCK.available_steps(slice_runs[k]["ck"]) for k in ("port",
                                                              "jax")]
    assert kept[0] == kept[1] == [6, 8]
    assert TCK.latest_step(slice_runs["port"]["ck"]) == 8
