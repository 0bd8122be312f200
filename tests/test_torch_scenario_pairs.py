"""The scenario layer's pairwise composition matrix (the reference's, from
``tests/test_scenarios.py``: every registry term but ``cluster_churn``,
which moves members only on a clustered pool), each pair on the dense and
the sparse path, against live reference runs."""
import itertools

import pytest

from test_torch_oracle import reference, run_both  # noqa: F401
from test_torch_scenarios import SMALL, SPARSE, TERMS

PAIRS = sorted(itertools.combinations(
    sorted(k for k in TERMS if k != "cluster_churn"), 2))


@pytest.mark.parametrize("a,b", PAIRS)
def test_pairwise_compositions_match_live_reference(reference, monkeypatch,
                                                    a, b):
    """The reference's composition matrix, each pair on the dense and the
    sparse path, 2 rounds, against live reference runs."""
    spec = f"{TERMS[a]}+{TERMS[b]}"
    for path in ({}, SPARSE):
        run_both(reference, monkeypatch, "osafl",
                 dict(SMALL, rounds=2, scenario=spec, **path),
                 eval_samples=16)
