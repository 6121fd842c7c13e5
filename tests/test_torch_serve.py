"""The port's serving path (``repro_torch.serve``,
``repro_torch.launch.serve_embed``) on the CPU against the JAX package:
a JAX-written checkpoint served by the port's launcher with ``--impl
flash`` gives, for every computed response, the JAX
``make_serve_encode_fn`` embedding of the same payload (f32 1e-5); cache
hits are computed bytes; the control plane behaves as the JAX one."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.configs import get_arch as j_get_arch
from repro.data import rng as JR
from repro.data.synthetic import ZeroShotEvalDataset as JZS
from repro.eval.extraction import make_serve_encode_fn as j_serve_fn
from repro.models import backbones as JBB
from repro.models import clip as JC
from repro_torch import device as D
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.data import rng as TR
from repro_torch.data.synthetic import ZeroShotEvalDataset as TZS
from repro_torch.launch import serve_embed
from repro_torch.models import backbones as TBB
from repro_torch.models import clip as TC
from repro_torch.serve import (
    CircuitBreaker, EmbedServer, EmbeddingCache, RetryPolicy, ServeConfig,
    bucket_sizes, content_hash, pick_bucket, stack_pad,
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

ARCH = "clip-vitb32-cc12m"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX checkpoint of the reduced config's JAX init."""
    d = str(tmp_path_factory.mktemp("serve_ckpt"))
    cfg = j_get_arch(ARCH).reduced()
    params = JBB.init_params(jax.random.PRNGKey(3), cfg)
    JCK.save(d, {"params": jax.tree.map(np.asarray, params)}, 4,
             {"arch": ARCH})
    return d, cfg, params


@pytest.mark.parametrize("modality", ["image", "text"])
def test_serve_embed_matches_jax_serve_fn(served, modality):
    d, jcfg, jparams = served
    record = []
    stats = serve_embed.main(
        ["--ckpt-dir", d, "--reduced", "--device", "cpu", "--impl", "flash",
         "--modality", modality, "--requests", "24", "--classes", "4",
         "--per-class", "2", "--payload-pool", "8", "--offered-rate",
         "200"], record=record)
    assert stats["dropped"] == 0 and stats["completed"] == 24
    assert stats["params_step"] == 4 and stats["retries"] == 0
    assert len(record) == 24
    with open(os.path.join(d, "serve_heartbeat.json")) as f:
        assert json.load(f)["step"] == stats["batches"]
    key = "images" if modality == "image" else "texts"
    tower = JC.encode_image if modality == "image" else JC.encode_text
    jfn = j_serve_fn(lambda p, b: tower(p, jcfg, b[key], impl="flash"))
    computed = {}
    for payload, res in record:
        assert res.params_step == 4
        if res.path != "compute":
            continue
        want, ok = jfn(jparams, {key: jnp.asarray(payload[key][None])})
        assert bool(ok)
        np.testing.assert_allclose(res.embedding, np.asarray(want)[0],
                                   atol=1e-5, rtol=0)
        computed.setdefault(content_hash(payload), set()).add(
            res.embedding.tobytes())
    assert computed
    # a hit returns the bytes of a compute of the same payload (which may
    # have run in another bucket: the port's batches are not bitwise
    # batch-size invariant, unlike the JAX serving contract)
    for payload, res in record:
        if res.path == "cache":
            assert res.embedding.tobytes() in computed[content_hash(payload)]


def _reduced_server(**kw):
    cfg = t_get_arch(ARCH).reduced()
    model = TBB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def encode(params, batch):
        return TC.encode_text(params, batch["texts"], impl="flash")
    return cfg, EmbedServer(encode, model, 0, ServeConfig(**kw),
                            device="cpu")


def test_cache_hit_is_the_computed_bytes():
    cfg, srv = _reduced_server(max_batch=4)
    try:
        pay = {"texts": np.arange(cfg.clip.context_length, dtype=np.int32)}
        first = srv.request(pay)
        again = srv.request(pay)
    finally:
        srv.close()
    assert first.path == "compute" and again.path == "cache"
    assert again.embedding.tobytes() == first.embedding.tobytes()
    assert first.embedding.dtype == np.float32
    assert abs(float(np.linalg.norm(first.embedding)) - 1.0) < 1e-5


class _PoisonFirstBatch:
    """The engine's chaos hook: NaN the first batch's first attempt."""

    def compute_delay(self, n_batch):
        return 0.0

    def compute_poison(self, n_batch):
        return n_batch == 1

    def on_cache_put(self, n_put):
        return False


def test_nonfinite_batch_retries_into_a_clean_answer():
    cfg = t_get_arch(ARCH).reduced()
    model = TBB.init_params(cfg, torch.Generator().manual_seed(1), "cpu")

    def encode(params, batch):
        return TC.encode_image(params, batch["images"], impl="flash")
    srv = EmbedServer(encode, model, 0, ServeConfig(
        max_batch=2, retry=RetryPolicy(base=0.001, cap=0.004)),
        chaos=_PoisonFirstBatch(), device="cpu")
    img = np.random.default_rng(0).standard_normal(
        (cfg.clip.image_size, cfg.clip.image_size, 3), dtype=np.float32)
    try:
        r = srv.request({"images": img})
    finally:
        srv.close()
    assert r.attempts == 2 and r.path == "compute"
    assert np.all(np.isfinite(r.embedding))


def test_entry_points_default_to_the_card_and_never_run_on_cpu(served):
    """Without ``device`` the entry points ask for CUDA; on a machine
    without it they raise instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    d, _, _ = served
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        D.resolve(None)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        serve_embed.main(["--ckpt-dir", d, "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        EmbedServer(lambda p, b: None, None, 0)
    cfg = t_get_arch(ARCH).reduced()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TBB.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TBB.params_from_tree(cfg, {})
    assert D.resolve("cpu").type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(), dict(n_classes=5, n_per_class=3, label_flip_frac=0.3, seed=2),
    dict(image_size=224, context_length=77, vocab_size=49_408, n_classes=32,
         n_per_class=1),
])
def test_eval_dataset_batches_bitwise_equal_jax(kw):
    j, t = JZS(**kw), TZS(**kw)
    idx = np.arange(j.n)[::-1]
    assert np.array_equal(j.labels, t.labels)
    for k, v in j.batch(idx).items():
        w = t.batch(idx)[k]
        assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), k


def test_data_rng_streams_equal_jax():
    kj, kt = JR.stream_key(7, "a/b"), TR.stream_key(7, "a/b")
    assert kj.tobytes() == kt.tobytes()
    idx = np.array([5, 0, 9])
    a = JR.add_gaussian_noise(np.ones((3, 4, 2), np.float32), 0.3, kj, idx)
    b = TR.add_gaussian_noise(np.ones((3, 4, 2), np.float32), 0.3, kt, idx)
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Control plane (pure Python), as tests/test_serve.py holds the JAX one
# ---------------------------------------------------------------------------

def test_bucket_sizes_and_stack_pad():
    assert bucket_sizes(8) == [1, 2, 4, 8]
    assert bucket_sizes(6) == [1, 2, 4, 6]
    assert pick_bucket(3, [1, 2, 4, 8]) == 4
    with pytest.raises(ValueError):
        pick_bucket(9, [1, 2, 4, 8])
    pays = [{"x": np.full((3,), i, np.float32)} for i in range(3)]
    out = stack_pad(pays, 4)
    assert out["x"].shape == (4, 3)
    assert np.array_equal(out["x"][3], out["x"][0])


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_full_cycle():
    clk = _Clock()
    br = CircuitBreaker(fail_threshold=3, reset_timeout=1.0, probes=1,
                        clock=clk)
    for _ in range(3):
        br.record_failure()
    assert br.state == "open" and not br.allow() and br.fail_fast()
    clk.t += 1.01
    assert br.state == "half_open" and br.allow() and not br.allow()
    br.record_success()
    assert br.state == "closed"
    assert br.transitions == {"opened": 1, "half_opened": 1, "closed": 1}


def test_cache_lru_and_digest():
    c = EmbeddingCache(capacity=2, fault_hook=lambda n: n == 3)
    c.put("a", np.zeros(2, np.float32))
    c.put("b", np.ones(2, np.float32))
    assert c.get("a") is not None           # a is MRU now
    c.put("c", np.full(2, 2.0, np.float32))  # 3rd put: bytes flipped
    assert len(c) == 2 and c.get("b") is None
    assert c.get("c") is None and c.stats["corrupt"] == 1
    assert c.get("a").tobytes() == np.zeros(2, np.float32).tobytes()
