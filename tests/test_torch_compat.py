"""The configuration matrix (``harness/compat.py``) against the reference's
over a grid of engine x request and round backend x ``cohort_size`` x
``participation`` x ``num_clusters`` x scenario: wherever the reference
raises, the port raises the same rule key; where it does not, the port
resolves the same plan or rejects it with a ``port-*`` rule, and only for
the pod engine, the fused round or a mesh."""
import dataclasses
import itertools

import pytest

from repro_torch.harness import ExperimentConfig, ExperimentConfigError
from repro_torch.harness.compat import PORT_RULES, resolve
from test_torch_oracle import reference  # noqa: F401

GRID = dict(
    cohort_size=(0, 4, 8, 9),
    participation=(1.0, 0.5),
    num_clusters=(0, 1, 2, 3),
    scenario=("", "null", "churn(p_away=0.3)",
              "cluster_churn(rate=0.2)+flash_crowd(scale=2)"),
    request_backend=("python", "stacked"),
)
ENGINES = ("auto", "stacked", "loop", "centralized", "pod")
ROUNDS = ("dispatch", "fused")


def test_port_rules_are_pod_fused_and_mesh():
    assert [r.key for r in PORT_RULES] == ["port-engine",
                                           "port-round-backend",
                                           "port-mesh"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("round_backend", ROUNDS)
@pytest.mark.parametrize("mesh", [False, True], ids=["no-mesh", "mesh"])
def test_matrix_matches_the_reference(reference, engine, round_backend,
                                      mesh):
    keys = list(GRID)
    seen = set()
    for values in itertools.product(*GRID.values()):
        change = dict(zip(keys, values), engine=engine,
                      round_backend=round_backend)
        xc = dataclasses.replace(ExperimentConfig(num_clients=8), **change)
        rxc = dataclasses.replace(
            reference.harness.ExperimentConfig(num_clients=8), **change)
        kw = dict(mesh=object()) if mesh else {}
        try:
            want = reference.harness.resolve("osafl", rxc, **kw)
            want_key = None
        except reference.harness.ExperimentConfigError as err:
            want, want_key = None, err.key
        try:
            got = resolve("osafl", xc, **kw)
            got_key = None
        except ExperimentConfigError as err:
            got, got_key = None, err.key
        what = (change, mesh)
        if want_key is not None:
            assert got_key == want_key, what
        elif got_key is not None:
            assert got_key.startswith("port-"), what
            plan_engine = ("pod" if engine == "pod" or (
                engine == "auto" and mesh) else engine)
            assert (plan_engine == "pod" or round_backend == "fused"
                    or mesh), what
        else:
            assert got.describe() == want.describe(), what
            assert not mesh and engine != "pod" and round_backend != "fused"
        seen.add(got_key or "ok")
    assert seen - {"ok"}                        # the grid reaches the rules
