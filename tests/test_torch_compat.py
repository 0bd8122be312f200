"""The configuration matrix (``harness/compat.py``) against the reference's
over a grid of engine x request and round backend x ``cohort_size`` x
``participation`` x ``num_clusters`` x scenario: wherever the reference
raises, the port raises the same rule key; where it does not, the port
resolves the same plan. The reference's side takes a stand-in mesh object
(its ``resolve`` only asks whether one was passed), the port's its own
one-row mesh (``make_host_mesh()``); the port adds no rule of its own,
on a mesh of more than one client row either."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro_torch.harness import ExperimentConfig, ExperimentConfigError
from repro_torch.harness import compat
from repro_torch.harness.compat import resolve
from repro_torch.launch.mesh import HostMesh, make_host_mesh
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


def test_port_rules_are_pod_and_mesh():
    """No port rule is left: the pod engine on a one-row mesh and on a
    two-row one resolves, a sparse cohort, edge clusters (K = 1 and K = R)
    and cluster churn on two rows among it (the rows' own refusals are the
    reference's, in the pod harness)."""
    assert not hasattr(compat, "PORT_RULES")
    xc = ExperimentConfig(num_clients=8)
    assert resolve("osafl", xc, mesh=make_host_mesh()).engine == "pod"
    assert resolve("osafl", dataclasses.replace(xc, engine="pod")
                   ).pod_engine == "exact_tp"
    two = HostMesh(np.full((2, 1), None, dtype=object))
    plan = resolve("osafl", xc, mesh=two)
    assert (plan.engine, plan.mesh_rows) == ("pod", 2)
    for change in (dict(cohort_size=4), dict(num_clusters=2),
                   dict(num_clusters=1),
                   dict(cohort_size=4, num_clusters=2,
                        scenario="cluster_churn(rate=0.3)")):
        plan = resolve("osafl", dataclasses.replace(xc, **change), mesh=two)
        assert (plan.engine, plan.mesh_rows) == ("pod", 2)
        assert plan.cohort_size == change.get("cohort_size", 0)
        assert plan.num_clusters == change.get("num_clusters", 0)
    with pytest.raises(TypeError, match="make_host_mesh"):
        resolve("osafl", xc, mesh=object())


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
        try:
            want = reference.harness.resolve(
                "osafl", rxc, **(dict(mesh=object()) if mesh else {}))
            want_key = None
        except reference.harness.ExperimentConfigError as err:
            want, want_key = None, err.key
        try:
            got = resolve("osafl", xc,
                          **(dict(mesh=make_host_mesh()) if mesh else {}))
            got_key = None
        except ExperimentConfigError as err:
            got, got_key = None, err.key
        what = (change, mesh)
        assert got_key == want_key, what
        if want_key is None:
            assert got.describe() == want.describe(), what
            assert got.mesh_rows == (1 if mesh else 0), what
        seen.add(got_key or "ok")
    assert seen - {"ok"}                        # the grid reaches the rules


@pytest.mark.parametrize("change", [
    dict(request_backend="stacked"),
    dict(engine="stacked", request_backend="stacked",
         resource_backend="f32", rounds_per_dispatch=8),
    dict(request_backend="stacked", scenario="null"),
    dict(request_backend="stacked", score_sketch_dim=16),
    dict(request_backend="stacked", use_resource_opt=False),
], ids=["auto", "stacked-f32-8", "null-scenario", "sketched", "no-solve"])
def test_resolve_accepts_the_fused_round(reference, change):
    """The fused shapes the reference accepts resolve to its plan."""
    xc = dataclasses.replace(ExperimentConfig(num_clients=8),
                             round_backend="fused", **change)
    rkw = {k: v for k, v in change.items() if k != "score_sketch_dim"}
    rxc = dataclasses.replace(
        reference.harness.ExperimentConfig(num_clients=8),
        round_backend="fused", **rkw)
    want = reference.harness.resolve("osafl", rxc)
    got = resolve("osafl", xc)
    assert got.describe() == want.describe()
    assert (got.engine, got.round_backend) == ("stacked", "fused")
