"""The port's streaming shard pipeline and curricula
(``repro_torch.data.streaming`` / ``curriculum``) on the CPU, held to the
JAX package: shards written by either package read bitwise by the other
under the same ``StreamingLoader`` plan, the reader's refusals, decode
thread safety, the fast-forward doing no decode work, decode faults at
their step, early close, the writer CLI; the curriculum functions'
batches bitwise equal to JAX's, and the towers at the curriculum shapes
against JAX's on the same params."""
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import get_arch as j_get_arch
from repro.data import ContrastiveDataset as JCD
from repro.data import ShardedLoader as JSL
from repro.data import StreamingDataset as JSD
from repro.data import StreamingLoader as JSTL
from repro.data import curriculum as JCU
from repro.data import streaming as JST
from repro.models import backbones as JBB
from repro.models import clip as JC
from repro.models import vit as JV
from repro_torch.configs import get_arch
from repro_torch.data import ContrastiveDataset as TCD
from repro_torch.data import (ShardedLoader, StreamingDataset,
                              StreamingLoader, write_contrastive_shards,
                              write_shards)
from repro_torch.data import curriculum as CU
from repro_torch.data import streaming as ST
from repro_torch.models import backbones as TBB
from repro_torch.models import clip as TC
from repro_torch.models import vit as TV


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

KW = dict(n=64, image_size=32, context_length=16, vocab_size=512,
          n_classes=8)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The same 64 samples written by each package (16 per file)."""
    d = tmp_path_factory.mktemp("shards")
    roots = {"port": str(d / "port"), "jax": str(d / "jax")}
    write_contrastive_shards(TCD(**KW), roots["port"], samples_per_shard=16)
    JST.write_contrastive_shards(JCD(**KW), roots["jax"],
                                 samples_per_shard=16)
    return TCD(**KW), roots


def _same_stream(a, b):
    assert len(a) == len(b)
    for (ea, sa, ia, ba), (eb, sb, ib, bb) in zip(a, b):
        assert (ea, sa) == (eb, sb) and ia.tobytes() == ib.tobytes()
        assert sorted(ba) == sorted(bb)
        for k in ba:
            assert ba[k].dtype == bb[k].dtype, k
            assert ba[k].tobytes() == bb[k].tobytes(), k


def test_shard_files_equal_across_the_packages(shards):
    _, roots = shards
    names = sorted(os.listdir(roots["port"]))
    assert names == sorted(os.listdir(roots["jax"]))
    assert "index.json" in names and ST.FORMAT_VERSION == JST.FORMAT_VERSION
    for n in names:
        with open(os.path.join(roots["port"], n), "rb") as f, \
                open(os.path.join(roots["jax"], n), "rb") as g:
            if n == "index.json":
                assert json.load(f) == json.load(g)
            else:
                assert f.read() == g.read(), n


@pytest.mark.parametrize("reader,writer", [("port", "jax"),
                                           ("jax", "port")])
@pytest.mark.parametrize("n_shards,owned,start", [(1, None, 0),
                                                  (4, None, 3),
                                                  (4, (2,), 1)])
def test_each_package_streams_the_others_shards(shards, reader, writer,
                                                n_shards, owned, start):
    """The plan and the batches of one package's loader over the other's
    shards equal the in-memory oracle's, bit for bit."""
    ds, roots = shards
    Loader, Dataset = ((StreamingLoader, StreamingDataset)
                       if reader == "port" else (JSTL, JSD))
    strm = Loader(Dataset(roots[writer]), global_batch=16,
                  n_shards=n_shards, seed=3, owned_shards=owned, workers=3,
                  decode_ahead=3)
    oracle = JSL(JCD(**KW), global_batch=16, n_shards=n_shards, seed=3,
                 owned_shards=owned)
    _same_stream(list(strm.steps(9, start=start)),
                 list(oracle.steps(9, start=start)))
    strm.dataset.close()


def test_roundtrip_contrastive_bitwise(shards):
    ds, roots = shards
    sd = StreamingDataset(roots["port"])
    for idx in (np.arange(16), np.asarray([63, 0, 17, 5]), np.asarray([7])):
        a, b = ds.batch(idx), sd.batch(idx)
        assert set(a) == set(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    sd.close()


class _Generic:
    """A dataset of a float and an int field (no augment)."""
    n = 50

    @staticmethod
    def batch(idx):
        idx = np.asarray(idx)
        return {"x": (idx[:, None] * np.arange(3)).astype(np.float32),
                "ids": np.stack([idx, -idx], 1).astype(np.int64)}


def test_roundtrip_generic_ragged_final_shard(tmp_path):
    root = str(tmp_path / "g")
    write_shards(root, _Generic(), samples_per_shard=16)
    sd, jd = StreamingDataset(root), JSD(root)
    assert sd.n == 50 and sd.augment is None
    idx = np.asarray([49, 0, 31, 16])
    for k, v in _Generic.batch(idx).items():
        assert sd.batch(idx)[k].tobytes() == v.tobytes(), k
        assert jd.batch(idx)[k].tobytes() == v.tobytes(), k
    sd.close()
    jd.close()


def test_missing_sidecar_version_and_truncation(tmp_path, shards):
    with pytest.raises(FileNotFoundError, match="index.json"):
        StreamingDataset(str(tmp_path / "nope"))
    _, roots = shards
    with open(os.path.join(roots["port"], "index.json")) as f:
        side = json.load(f)
    side["version"] = 99
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    with open(os.path.join(bad, "index.json"), "w") as f:
        json.dump(side, f)
    with pytest.raises(ValueError, match="version"):
        StreamingDataset(bad)
    sd = StreamingDataset(roots["port"])
    for i in (64, -1):
        with pytest.raises(IndexError):
            sd.read_record(i)
    sd.close()
    root = str(tmp_path / "trunc")
    write_contrastive_shards(TCD(**KW), root, samples_per_shard=16)
    sd = StreamingDataset(root)
    os.truncate(os.path.join(root, "shard-00000.bin"), sd.record_size // 2)
    with pytest.raises(IOError, match="short read"):
        sd.batch(np.asarray([0]))
    sd.close()


def test_concurrent_decode_thread_safe(shards):
    ds, roots = shards
    sd = StreamingDataset(roots["jax"])
    oracle = ds.batch(np.arange(64))
    errs = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(5):
            idx = rng.integers(0, 64, size=9)
            got = sd.batch(idx)
            errs.extend((seed, k) for k in oracle
                        if not np.array_equal(got[k], oracle[k][idx]))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    assert sd.decodes == 8 * 5 * 9
    sd.close()


def test_fast_forward_does_no_decode_work(shards):
    _, roots = shards

    def make():
        return StreamingLoader(StreamingDataset(roots["port"]),
                               global_batch=16, n_shards=4, seed=1,
                               workers=2, decode_ahead=2)

    full = make()
    tail_want = list(full.steps(12))[5:]
    full.dataset.close()
    part = make()
    tail_got = list(part.steps(12, start=5))
    assert part.dataset.decodes == 7 * 16     # nothing for steps 0..4
    part.dataset.close()
    _same_stream(tail_got, tail_want)


def test_decode_fault_at_position_and_early_close(shards):
    _, roots = shards

    def hook(step):
        if step == 2:
            raise RuntimeError("boom at 2")

    strm = StreamingLoader(StreamingDataset(roots["port"]), global_batch=16,
                           n_shards=4, seed=0, workers=2, decode_ahead=4,
                           fault_hook=hook)
    got = []
    with pytest.raises(RuntimeError, match="boom at 2"):
        for _e, step, _i, _b in strm.steps(8):
            got.append(step)
    assert got == [0, 1]
    strm.dataset.close()
    strm = StreamingLoader(StreamingDataset(roots["port"]), global_batch=16,
                           n_shards=4, seed=0, workers=4, decode_ahead=4)
    it = strm.steps(12)
    next(it)
    it.close()                   # the generator's finally cancels the pool
    before = strm.dataset.decodes
    time.sleep(0.1)
    assert strm.dataset.decodes <= before + 4 * 16
    with pytest.raises(ValueError, match="steps_per_epoch"):
        StreamingLoader(strm.dataset, global_batch=128, n_shards=4)
    strm.dataset.close()


def test_writer_cli_matches_jax(tmp_path, capsys):
    args = ["--arch", "clip-vitb32-cc12m", "--reduced", "--n", "32",
            "--samples-per-shard", "16", "--seed", "2"]
    out = ST.main(["--out", str(tmp_path / "port")] + args)
    assert "wrote 32 samples" in capsys.readouterr().out
    JST.main(["--out", str(tmp_path / "jax")] + args)
    a, b = StreamingDataset(out), JSD(str(tmp_path / "jax"))
    idx = np.arange(32)[::-1]
    assert a.index == b.index
    for k, v in b.batch(idx).items():
        assert a.batch(idx)[k].tobytes() == v.tobytes(), k
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# Curricula
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "", "0:16,300:32", "300:32,0:16",
                                  "0:8,5:16,9:32", "10:16", "0:16,0:32",
                                  "0:16,banana", "0:x"])
def test_parse_schedule_as_jax(spec):
    try:
        want = JCU.parse_schedule(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            CU.parse_schedule(spec)
        assert str(got.value) == str(e)
        return
    assert CU.parse_schedule(spec) == want
    for s in (0, 4, 5, 8, 9, 100, 300):
        assert CU.schedule_value(want, s) == JCU.schedule_value(want, s)


def test_shrink_and_truncate():
    imgs = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    assert CU.shrink_images(imgs, 8) is imgs
    small = CU.shrink_images(imgs, 4)
    assert small.shape == (2, 4, 4, 3)
    np.testing.assert_allclose(small[0, 0, 0, 0], imgs[0, :2, :2, 0].mean())
    with pytest.raises(ValueError, match="divide"):
        CU.shrink_images(imgs, 3)
    toks = np.arange(32).reshape(2, 16)
    assert CU.truncate_tokens(toks, 16) is toks
    assert CU.truncate_tokens(toks, 4).tobytes() == toks[:, :4].tobytes()


@pytest.mark.parametrize("step", [0, 3, 4, 9])
def test_apply_curriculum_bitwise_as_jax(step):
    rng = np.random.default_rng(step)
    batch = {"images": rng.standard_normal((4, 32, 32, 3),
                                           dtype=np.float32),
             "texts": rng.integers(0, 99, (4, 16)).astype(np.int32),
             "other": np.ones(4)}
    img, ctx = [(0, 8), (4, 16), (9, 32)], [(0, 4), (4, 16)]
    got = CU.apply_curriculum(batch, step, img, ctx)
    want = JCU.apply_curriculum(batch, step, img, ctx)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["other"] is batch["other"]
    assert CU.apply_curriculum(batch, step) is batch


def test_vit_pos_embed_for_grid_as_jax():
    pos = np.random.default_rng(0).normal(size=(1, 17, 8)).astype(
        np.float32)
    tpos = torch.from_numpy(pos)
    assert TV.pos_embed_for_grid(tpos, 4, 4) is tpos
    for g in (2, 1):
        want = np.asarray(JV.pos_embed_for_grid(jax.numpy.asarray(pos), g,
                                                g))
        got = TV.pos_embed_for_grid(tpos, g, g).numpy()
        assert got.shape == want.shape == (1, g * g + 1, 8)
        assert got[0, 0].tobytes() == pos[0, 0].tobytes()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="divide"):
        TV.pos_embed_for_grid(tpos, 3, 3)


def test_towers_accept_curriculum_shapes():
    """The reduced towers on shrunk images (2x2 and 1x1 patch grids) and
    truncated contexts, from one set of params in both packages: the
    embeddings within 1e-5 of JAX's (the native shapes:
    tests/test_torch_towers.py)."""
    jcfg = j_get_arch("clip-vitb32-cc12m").reduced()
    tcfg = get_arch("clip-vitb32-cc12m").reduced()
    jparams = JBB.init_params(jax.random.PRNGKey(0), jcfg)
    flat = {_path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    model = TBB.params_from_tree(tcfg, flat, "cpu")
    c = tcfg.clip
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((2, c.image_size, c.image_size, 3),
                               dtype=np.float32)
    toks = rng.integers(1, tcfg.vocab_size, (2, c.context_length)).astype(
        np.int32)
    with torch.no_grad():
        for size in (c.image_size // 2, c.patch_size):
            small = CU.shrink_images(imgs, size)
            got = TC.encode_image(model, torch.from_numpy(small),
                                  impl="chunked").numpy()
            want = np.asarray(JC.encode_image(jparams, jcfg, small))
            assert got.shape == (2, c.embed_dim) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for n in (c.context_length // 2, 3):
            got = TC.encode_text(model, torch.from_numpy(toks[:, :n]),
                                 impl="chunked").numpy()
            want = np.asarray(JC.encode_text(jparams, jcfg, toks[:, :n]))
            assert got.shape == (2, c.embed_dim) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
