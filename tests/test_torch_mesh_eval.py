"""The port's sharded eval forms on a 4-rank gloo group (the K=4
battery of tests/helpers/eval_check.py, run by
tests/helpers/torch_mesh_check.py), exact: the sharded streaming top-k on
quantized embeddings with planted ties equals the dense oracle bit for
bit, and the planted known answers through the sharded retrieval equal
the closed form and the single-device pass (ragged N included)."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_mesh_check as H  # noqa: E402


@pytest.fixture(scope="module")
def eval_checks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_eval")
    ranks = H.spawn("eval", d, timeout=120)
    assert [r.returncode for r in ranks] == [0] * 4, ranks[0].stderr[-3000:]
    with open(d / "eval.json") as f:
        return json.load(f)


def test_sharded_topk_equals_dense_oracle_bitwise(eval_checks):
    assert eval_checks["topk_exact"] is True


@pytest.mark.parametrize("case", ["4x4/0.0", "5x3/0.0", "6x4/0.25"])
def test_sharded_planted_known_answers_exact(eval_checks, case):
    got, single, want = eval_checks[f"planted/{case}"]
    assert got == single
    assert sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)
