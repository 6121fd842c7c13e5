"""The remaining FastCLIP versions (v0, sogclr, isogclr) through the
port's training step against the JAX package's: the checks and
tolerances of ``tests/test_torch_train.py`` (kept in a file of their own
so that each file stays short on one core)."""
import pytest

import test_torch_train as base


@pytest.mark.parametrize("version", ["v0", "sogclr", "isogclr"])
def test_three_steps_match_jax_other_versions(version):
    base.test_three_steps_match_jax(version)
