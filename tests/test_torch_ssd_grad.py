"""Gradients through the SSD chunk-scan kernel K4, on the CPU.

On the card ``repro_torch.kernels.ssd_chunk.ssd_chunk`` is an autograd
Function (``_SSDChunk``): the forward is the kernel's four passes, the
backward recomputes ``ssd_scan_plain`` on the saved inputs and
differentiates it, as the JAX package differentiates its jnp
``ssd_chunked``.  Here the Function runs with its passes on the CPU, where
each pass entry point takes its plain version, counted by a wrapper in
place of the launches: its forward and its gradients with respect to x,
log_a, B and C are held to autograd of ``ssd_scan_plain`` (1e-5) and to
``jax.grad`` of the JAX ``ssd_chunked`` on the same numpy inputs (1e-4),
and its backward makes no pass call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels import ssd_chunk as K4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL, TOL_JAX = 1e-5, 1e-4
PASSES = ("ssd_chunk_cb", "ssd_chunk_state", "ssd_state_pass",
          "ssd_chunk_scan")


@pytest.fixture
def counted_passes(monkeypatch):
    """The four pass entry points wrapped to count their calls."""
    calls = []
    for name in PASSES:
        def wrapped(*args, _fn=getattr(K4, name), _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(K4, name, wrapped)
    return calls


def _inputs(B, T, H, P, N, seed):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), dtype=np.float32)
    log_a = (-np.logaddexp(0.0, rng.standard_normal((B, T, H)))).astype(
        np.float32)
    Bm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    gy = rng.standard_normal((B, T, H, P), dtype=np.float32)
    return (x, log_a, Bm, Cm), gy


def _jax_grads(inp, gy, chunk):
    def loss(x, la, Bm, Cm):
        y, _ = JS.ssd_chunked(x, la, Bm, Cm, chunk=chunk)
        return jnp.sum(y * gy)
    return jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a)
                                                  for a in inp))


def _err(a, b):
    return (a - b).abs().max().item()


# B, T, H, P, N, chunk: tests/test_kernels.py's shape, a ragged T, T below
# one chunk, and the reduced zamba2 widths
SHAPES = [(2, 60, 3, 8, 4, 16), (2, 50, 2, 8, 4, 32), (1, 12, 2, 8, 4, 16),
          (2, 40, 4, 32, 16, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_function_gradients_match_plain_and_jax(counted_passes, shape):
    B, T, H, P, N, chunk = shape
    inp, gy = _inputs(B, T, H, P, N, seed=T + chunk)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in inp]
    y = K4._SSDChunk.apply(*ins, chunk)
    assert counted_passes == list(PASSES)
    got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    assert counted_passes == list(PASSES)       # the backward: no launch
    ref, _ = K4.ssd_scan_plain(*ins, chunk=chunk)
    want = torch.autograd.grad(ref, ins, torch.from_numpy(gy))
    assert _err(y, ref) <= TOL
    jgrads = _jax_grads(inp, gy, chunk)
    for a, w, j in zip(got, want, jgrads):
        assert a.shape == w.shape and a.dtype == torch.float32
        assert _err(a, w) <= TOL
        assert _err(a, torch.from_numpy(np.array(j))) <= TOL_JAX


def test_function_bf16_bc_gets_bf16_gradients(counted_passes):
    inp, gy = _inputs(2, 48, 2, 8, 4, seed=3)
    x, la = (torch.from_numpy(a).requires_grad_(True) for a in inp[:2])
    Bm, Cm = (torch.from_numpy(a).bfloat16().requires_grad_(True)
              for a in inp[2:])
    ins = [x, la, Bm, Cm]
    got = torch.autograd.grad(K4._SSDChunk.apply(*ins, 16), ins,
                              torch.from_numpy(gy))
    want = torch.autograd.grad(K4.ssd_scan_plain(*ins, chunk=16)[0], ins,
                               torch.from_numpy(gy))
    assert len(counted_passes) == 4
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert got[2].dtype == got[3].dtype == torch.bfloat16


def test_function_only_differentiates_what_needs_it(counted_passes):
    inp, gy = _inputs(1, 20, 2, 8, 4, seed=4)
    x, la, Bm, Cm = (torch.from_numpy(a) for a in inp)
    x.requires_grad_(True)
    (gx,) = torch.autograd.grad(K4._SSDChunk.apply(x, la, Bm, Cm, 16), x,
                                torch.from_numpy(gy))
    (want,) = torch.autograd.grad(K4.ssd_scan_plain(x, la, Bm, Cm,
                                                    chunk=16)[0], x,
                                  torch.from_numpy(gy))
    assert torch.equal(gx, want)


def test_function_under_inference_mode_keeps_the_prefill(counted_passes):
    """The prefill path: same outputs and passes, no graph."""
    inp, _ = _inputs(2, 60, 3, 8, 4, seed=5)
    ins = [torch.from_numpy(a) for a in inp]
    with torch.inference_mode():
        y = K4._SSDChunk.apply(*ins, 16)
    assert not y.requires_grad and counted_passes == list(PASSES)
    assert torch.equal(y, K4.ssd_chunk_plain(*ins, chunk=16))


def test_reduced_hybrid_gradients_through_the_function(monkeypatch):
    """A reduced zamba2 forward + backward with every Mamba2 layer's scan
    through the Function (as ``impl="flash"`` runs it on the card; under
    grad ``forward_hidden`` recomputes each layer once, so each runs it
    twice): every
    leaf's gradient within 1e-4 relative L2 of ``impl="chunked"``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import backbones as BB
    from repro_torch.models import ssm as SSM
    calls = []

    def through_function(x, log_a, Bm, Cm, *, chunk=64):
        calls.append(chunk)
        return K4._SSDChunk.apply(x, log_a, Bm, Cm, chunk)

    monkeypatch.setattr(SSM, "ssd_chunk", through_function)
    cfg = get_arch("zamba2-1.2b").reduced().replace(n_layers=3)
    model = BB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    grads = {}
    ct = None
    for impl in ("flash", "chunked"):
        model.zero_grad(set_to_none=True)
        x, _ = BB.forward_hidden(model, cfg, {"tokens": tokens}, impl=impl)
        if ct is None:
            ct = torch.from_numpy(rng.standard_normal(
                tuple(x.shape)).astype(np.float32))
        (x * ct).sum().backward()
        grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}
    assert calls == [cfg.ssm.chunk] * (2 * cfg.n_layers)
    assert grads["flash"].keys() == grads["chunked"].keys()
    assert any("A_log" in n for n in grads["flash"])
    for n, w in grads["chunked"].items():
        rel = (grads["flash"][n] - w).norm() / w.norm().clamp_min(1e-30)
        assert rel.item() <= 1e-4, n
