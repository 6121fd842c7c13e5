"""The remaining FastCLIP versions (v0, sogclr, isogclr) through the
port's training step against the JAX package's: the checks and
tolerances of ``tests/test_torch_train.py`` (kept in a file of their own
so that each file stays short on one core)."""
import pytest
import torch

import test_torch_train as base


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the host's cores, and torch's default of one thread per core
    in each of them oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("version", ["v0", "sogclr", "isogclr"])
def test_three_steps_match_jax_other_versions(version):
    base.test_three_steps_match_jax(version)
