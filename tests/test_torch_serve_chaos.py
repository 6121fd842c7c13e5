"""The port's fault injection (``repro_torch.resilience.chaos``), planted
known-answer serving (``serve_embed --planted --chaos``) and the
trainer's periodic eval (``--eval-every``) on the CPU.

* ``parse_chaos``: the same ``(spec, seed)`` gives the same decision as
  ``repro.resilience.chaos`` at every step or occurrence, and the same
  errors on malformed specs.
* The serving battery of tests/helpers/serve_check.py (faults, overload,
  reload, SIGTERM) in planted mode: the planted towers are exact on any
  device, so **every completed response is bitwise equal to the solo
  forward** of its payload under the params step it claims, and every
  other request gets a typed rejection.
* ``launch.train --eval-every``: the JAX launcher's ``eval`` lines, the
  final eval unless the loop just ran one, ``eval_loss`` through K1's
  plain version equal to the dense path's (rtol 1e-5, the K1 bound of
  tests/test_kernels.py)."""
import json
import os
import re
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro.resilience import chaos as JCH
from repro_torch import checkpoint as CK
from repro_torch.configs import get_arch
from repro_torch.core import losses as LS
from repro_torch.data import ZeroShotEvalDataset
from repro_torch.eval import ClipEvaluator
from repro_torch.eval import planted as PL
from repro_torch.launch import serve_embed
from repro_torch.launch import train as ttrain
from repro_torch.resilience import chaos as TCH
from repro_torch.serve import (
    CheckpointWatcher, EmbedServer, RetryPolicy, ServeConfig, ServeRejection,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

CPU = "cpu"
DS = ZeroShotEvalDataset(n_classes=4, n_per_class=2, seed=0)
PARAMS0 = PL.planted_params(DS, CPU)


# ---------------------------------------------------------------------------
# parse_chaos: decisions equal to JAX's
# ---------------------------------------------------------------------------

class _Killed(Exception):
    pass


def _raise_kill():
    raise _Killed()


def _decisions(mod, spec, seed, tmp):
    """Every hook's decision over steps / occurrences 1..10 (kills and
    raises as strings, poisoned batches and flipped files as bytes)."""
    inj = mod.parse_chaos(spec, seed=seed, kill_fn=_raise_kill)
    batch = {"ids": np.arange(6, dtype=np.int32),
             "x": np.arange(24, dtype=np.float32).reshape(6, 4)}
    out = []
    for step in range(1, 11):
        row = [step]
        for hook in (inj.on_loader, inj.on_decode, inj.pre_step):
            try:
                hook(step)
                row.append("ok")
            except (RuntimeError, _Killed) as e:
                row.append(type(e).__name__ + ":" + str(e))
        row.append({k: v.tobytes() for k, v in
                    inj.poison_batch(step, batch).items()})
        for event in ("pre_npz", "mid_npz", "done"):
            try:
                inj.checkpoint_event(event)
                row.append("ok")
            except _Killed:
                row.append("killed")
        row += [inj.compute_poison(step), inj.compute_delay(step),
                inj.on_cache_put(step)]
        path = os.path.join(tmp, f"ckpt_{step:08d}.npz")
        with open(path, "wb") as f:
            f.write(bytes(range(64)))
        inj.on_reload(step, tmp, step)
        with open(path, "rb") as f:
            row.append(f.read())
        out.append(row)
    return out


@pytest.mark.parametrize("spec,seed", [
    ("nan_batch@3,loader_raise@5,decode_raise@2,kill@7", 0),
    ("nan_batch@4,nan_batch@9,kill_save@mid_npz:2,kill_save@done", 5),
    ("compute_nan@2,cache_corrupt@1,slow_batch@3:50,reload_bad_ckpt@1", 0),
    ("compute_nan@2,compute_nan@3,slow_batch@7:12.5,reload_bad_ckpt@4,"
     "cache_corrupt@10", 17),
])
def test_parse_chaos_decisions_equal_jax(spec, seed, tmp_path):
    dirs = [tmp_path / name for name in ("jax", "port", "quiet")]
    for d in dirs:
        d.mkdir()
    want = _decisions(JCH, spec, seed, str(dirs[0]))
    got = _decisions(TCH, spec, seed, str(dirs[1]))
    assert got == want
    assert got != _decisions(TCH, "kill@99", seed, str(dirs[2]))   # fired


@pytest.mark.parametrize("spec", ["nan_batch", "kill@x", "bogus@3",
                                  "slow_batch@3", "kill_save@Bad",
                                  "compute_nan@1,,oops@2"])
def test_parse_chaos_malformed_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as want:
        JCH.parse_chaos(spec)
    with pytest.raises(ValueError) as got:
        TCH.parse_chaos(spec)
    assert str(got.value) == str(want.value)
    assert TCH.parse_chaos(None) is None and TCH.parse_chaos("") is None


def test_offline_corruption_helpers_equal_jax(tmp_path):
    for mod in (JCH, TCH):
        p = tmp_path / f"{mod.__name__}.bin"
        p.write_bytes(bytes(range(100)))
        mod.flip_byte(str(p), 37)
        mod.truncate_file(str(p), 60)
    assert (tmp_path / f"{JCH.__name__}.bin").read_bytes() == \
        (tmp_path / f"{TCH.__name__}.bin").read_bytes()


# ---------------------------------------------------------------------------
# The serving battery (tests/helpers/serve_check.py) in planted mode
# ---------------------------------------------------------------------------

def encode(params, batch):
    return PL.encode_image(params, batch["images"])


def payload(i):
    # planted images are identical within a class: stride by
    # n_per_class so distinct payloads have distinct content hashes
    idx = (i * DS.n_per_class) % DS.n
    return {"images": DS.images(np.array([idx]))[0]}


def oracle(params, pay):
    """Solo forward + f32 L2 norm: the bytes every completed response
    must reproduce exactly."""
    with torch.inference_mode():
        e = LS.l2_normalize(encode(params, {
            k: torch.from_numpy(v[None]) for k, v in pay.items()}))
    return e[0].numpy()


def server(params=PARAMS0, chaos=None, **kw):
    return EmbedServer(encode, params, 0, ServeConfig(seed=0, **kw),
                       chaos=TCH.parse_chaos(chaos), device=CPU)


def test_serve_compute_nan_retries_into_the_exact_answer():
    srv = server(max_batch=4, retry=RetryPolicy(base=0.001, cap=0.004),
                 chaos="compute_nan@1")
    try:
        r = srv.request(payload(0))
    finally:
        srv.close()
    assert r.attempts == 2 and r.path == "compute"
    assert r.embedding.tobytes() == oracle(PARAMS0, payload(0)).tobytes()


def test_serve_breaker_trips_and_recovers_exactly():
    srv = server(max_batch=1, retry=RetryPolicy(max_retries=0),
                 breaker_failures=3, breaker_reset=0.2,
                 chaos="compute_nan@2,compute_nan@3,compute_nan@4")
    a, b, c = payload(0), payload(1), payload(2)
    try:
        srv.request(a)                   # batch 1 clean: a now cached
        codes = []
        for _ in range(3):               # batches 2..4 all poisoned
            try:
                srv.request(b)
                codes.append("completed")
            except ServeRejection as e:
                codes.append(e.code)
        assert codes == ["UNAVAILABLE"] * 3
        assert srv.breaker.state == "open"
        with pytest.raises(ServeRejection) as fast:
            srv.request(c)               # open: uncached fails fast
        assert fast.value.code == "UNAVAILABLE"
        ra = srv.request(a)              # cached still serves exactly
        assert ra.path == "cache"
        assert ra.embedding.tobytes() == oracle(PARAMS0, a).tobytes()
        time.sleep(0.25)                 # reset_timeout elapses
        rc = srv.request(c)              # the half-open probe recovers
        assert rc.path == "compute"
        assert rc.embedding.tobytes() == oracle(PARAMS0, c).tobytes()
        assert srv.breaker.state == "closed"
        assert srv.breaker.transitions == {"opened": 1, "half_opened": 1,
                                           "closed": 1}
    finally:
        srv.close()


def test_serve_cache_corrupt_is_detected_and_recomputed_exactly():
    srv = server(max_batch=4, chaos="cache_corrupt@1")
    try:
        r1 = srv.request(payload(0))     # put 1: flipped after its digest
        r2 = srv.request(payload(0))     # hit -> mismatch -> recompute
        st = srv.snapshot_stats()
    finally:
        srv.close()
    want = oracle(PARAMS0, payload(0)).tobytes()
    assert r1.embedding.tobytes() == want == r2.embedding.tobytes()
    assert r2.path == "compute" and st["cache_corrupt"] == 1


def test_serve_slow_batch_sheds_queued_deadlines_keeps_the_rest_exact():
    srv = server(max_batch=1, estimator_prior=0.01,
                 chaos="slow_batch@2:300")
    try:
        srv.request(payload(0))          # batch 1: warms the estimator
        fut_a = srv.submit(payload(1))   # batch 2: stalled 300 ms
        time.sleep(0.02)
        shed, futs = [], []
        for _ in range(3):
            try:
                futs.append(srv.submit(payload(2), deadline=0.1))
            except ServeRejection as e:
                shed.append(e.code)
        res_a = fut_a.result(timeout=10.0)
        for f in futs:
            try:
                f.result(timeout=10.0)
                shed.append("completed")
            except ServeRejection as e:
                shed.append(e.code)
    finally:
        srv.close()
    assert res_a.embedding.tobytes() == oracle(PARAMS0,
                                               payload(1)).tobytes()
    assert shed == ["DEADLINE"] * 3


def test_serve_overload_sheds_at_admission_and_completes_exactly():
    srv = server(max_batch=4, queue_capacity=8, estimator_prior=0.01)
    real_compute = srv.compute

    def sleepy(params, payloads, *, poison=False):
        time.sleep(0.005)
        return real_compute(params, payloads, poison=poison)
    srv.compute = sleepy
    deadline = 0.5
    futs, rejects = [], {"OVERLOADED": 0, "DEADLINE": 0, "UNAVAILABLE": 0}
    try:
        srv.request(payload(0))
        for i in range(200):              # a burst far beyond capacity
            p = payload(i)
            try:
                futs.append((p, srv.submit(p, deadline=deadline)))
            except ServeRejection as e:
                rejects[e.code] += 1
        lat, completed, late = [], 0, 0
        for p, f in futs:
            try:
                r = f.result(timeout=30.0)
            except ServeRejection:
                late += 1
                continue
            completed += 1
            lat.append(r.latency)
            if r.path == "compute":
                assert r.embedding.tobytes() == oracle(PARAMS0, p).tobytes()
    finally:
        srv.close()
    assert completed + late + sum(rejects.values()) == 200
    assert completed > 0 and rejects["OVERLOADED"] > 0
    assert float(np.percentile(lat, 99)) < deadline


def test_serve_hot_reload_exact_under_claimed_step_and_rejects_corrupt(
        tmp_path):
    d = str(tmp_path)
    perm = np.eye(PL.LATENT, dtype=np.float32)[::-1]
    # normalisation erases scale changes, so the new params permute the
    # projection: old and new oracles differ for every payload
    params1 = dict(PARAMS0, img_proj=torch.from_numpy(perm.copy()))
    like = PL.planted_params(DS, CPU)
    CK.save(d, PARAMS0, 0)
    srv = server(max_batch=2)
    watcher = CheckpointWatcher(
        d, like, srv.store, prefix="", poll_interval=0.05,
        materialize=lambda tree: PL.params_from_tree(tree, CPU))
    oracles = {s: {i: oracle(p, payload(i)).tobytes() for i in range(4)}
               for s, p in ((0, PARAMS0), (1, params1))}
    results, failures = [], []
    barrier = threading.Event()

    def client():
        for i in range(150):
            try:
                r = srv.request(payload(i % 4), timeout=10.0)
                results.append((i % 4, r.params_step,
                                r.embedding.tobytes()))
            except ServeRejection as e:
                failures.append(e.code)
            if i == 20:
                barrier.set()
            time.sleep(0.002)            # traffic spans the swap
    th = threading.Thread(target=client)
    try:
        th.start()
        assert barrier.wait(timeout=30.0)
        CK.save(d, params1, 1)
        assert watcher.poll_once() == 1
        th.join(timeout=60.0)
        assert not th.is_alive()
        assert not failures
        assert all(by == oracles[s][i] for i, s, by in results)
        assert {s for _, s, _ in results} == {0, 1}
        r = srv.request(payload(0))      # no step-0 bytes after the swap
        assert r.params_step == 1 and r.embedding.tobytes() == oracles[1][0]
        # a corrupt candidate: the digest-verified restore rejects it
        watcher._fault_hook = TCH.parse_chaos("reload_bad_ckpt@2").on_reload
        CK.save(d, PARAMS0, 2)
        assert watcher.poll_once() is None
        still = srv.request(payload(1))
        assert srv.store.step == 1
        assert still.embedding.tobytes() == oracles[1][1]
        assert watcher.stats["reload_rejected"] == 1
        assert watcher.poll_once() is None       # blacklisted, no retry
        CK.save(d, params1, 3)                    # a clean one swaps
        assert watcher.poll_once() == 3 and srv.store.step == 3
    finally:
        srv.close()


SERVE = ["--planted", "--device", CPU, "--classes", "8", "--per-class", "1",
         "--payload-pool", "8"]


def test_serve_embed_planted_chaos_and_bad_reload(tmp_path):
    """The launcher in planted mode with every serving fault: the
    reference checkpoint is written on first run; a step-1 candidate is
    corrupted on the watcher's first attempt and rejected, so step 0
    keeps serving; nothing is dropped; every completed response is the
    solo forward's bytes."""
    d = str(tmp_path)
    stats0 = serve_embed.main(["--ckpt-dir", d, *SERVE, "--requests", "4"])
    assert stats0["completed"] == 4 and CK.latest_step(d) == 0
    # a random projection: incompressible, it fills the middle of the npz
    # where the fault flips a byte
    proj = np.random.RandomState(4).randn(PL.LATENT, PL.LATENT).astype(
        np.float32)
    CK.save(d, dict(PARAMS0, img_proj=torch.from_numpy(proj)), 1)
    record = []
    stats = serve_embed.main(
        ["--ckpt-dir", d, *SERVE, "--step", "0", "--requests", "96",
         "--offered-rate", "400", "--deadline-ms", "2000",
         "--watch-ckpt", "0.02", "--chaos",
         "compute_nan@2,cache_corrupt@1,slow_batch@3:50,reload_bad_ckpt@1"],
        record=record)
    ds = ZeroShotEvalDataset(n_classes=8, n_per_class=1)
    params = PL.planted_params(ds, CPU)
    assert stats["dropped"] == 0 and stats["client"]["offered"] == 96
    assert stats["reload_rejected"] == 1 and stats["reloads"] == 0
    assert stats["params_step"] == 0 and stats["retries"] >= 1
    assert stats["cache_corrupt"] <= 1 and stats["served_cache"] > 0
    assert len(record) == stats["client"]["completed"] > 0
    for pay, res in record:
        assert res.params_step == 0
        assert res.embedding.tobytes() == oracle(params, pay).tobytes()


def test_serve_embed_planted_sigterm_drains(tmp_path):
    """SIGTERM mid-load (the launcher's handler, in this process): every
    admitted request is drained, nothing dropped, the final heartbeat
    written."""
    d = str(tmp_path)
    hb = os.path.join(d, "serve_heartbeat.json")

    def terminate():
        for _ in range(600):
            if os.path.exists(hb):
                break
            time.sleep(0.05)
        time.sleep(0.3)
        os.kill(os.getpid(), signal.SIGTERM)
    th = threading.Thread(target=terminate)
    th.start()
    try:
        stats = serve_embed.main(["--ckpt-dir", d, *SERVE, "--requests",
                                  "100000", "--offered-rate", "200"])
    finally:
        th.join(timeout=60.0)
    assert not th.is_alive()
    assert stats["sigterm"] is True and stats["dropped"] == 0
    assert 0 < stats["client"]["completed"] < 100000
    with open(hb) as f:
        beat = json.load(f)
    assert beat["step"] == stats["batches"]
    assert time.time() - beat["time"] < 3600.0


# ---------------------------------------------------------------------------
# The trainer's periodic eval
# ---------------------------------------------------------------------------

TRAIN = ["--arch", "clip-vitb32-cc12m", "--reduced", "--global-batch", "16",
         "--n-samples", "32", "--log-every", "1", "--device", CPU,
         "--eval-classes", "4", "--eval-per-class", "4", "--eval-batch", "8"]
EVAL_KEYS = ["eval_loss", "i2t_r@1", "i2t_r@10", "i2t_r@5", "t2i_r@1",
             "t2i_r@10", "t2i_r@5", "zs_top1", "zs_top5"]
EVAL_LINE = re.compile(r"^eval  ([ \d]{5}) (\{.*\})$")


def _eval_lines(out):
    return [(int(m.group(1)), json.loads(m.group(2)))
            for m in map(EVAL_LINE.match, out.splitlines()) if m]


@pytest.mark.parametrize("steps,want_steps", [(4, [2, 4]), (3, [2, 3])])
def test_train_eval_every_prints_eval_lines(steps, want_steps, capsys):
    state = ttrain.main(TRAIN + ["--steps", str(steps), "--eval-every",
                                 "2"])
    lines = _eval_lines(capsys.readouterr().out)
    assert [s for s, _ in lines] == want_steps   # final eval not repeated
    for _, m in lines:
        assert list(m) == EVAL_KEYS and all(np.isfinite(list(m.values())))
    # the hook's eval set (seed + 1) and K1's plain version against the
    # dense loss math on the final params
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    ds = ZeroShotEvalDataset(n_classes=4, n_per_class=4,
                             image_size=cfg.clip.image_size,
                             context_length=cfg.clip.context_length,
                             vocab_size=cfg.vocab_size, seed=1)
    fused, dense = (ClipEvaluator(cfg, ds, batch_size=8, loss_impl=impl,
                                  device=CPU).evaluate(state["params"])
                    for impl in ("fused", "dense"))
    assert lines[-1][1] == {k: round(v, 5) for k, v in fused.items()}
    assert fused["eval_loss"] == pytest.approx(dense["eval_loss"],
                                               rel=1e-5)
    assert {k: v for k, v in fused.items() if k != "eval_loss"} == \
        {k: v for k, v in dense.items() if k != "eval_loss"}
