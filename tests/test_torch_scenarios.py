"""The scenario layer (``repro_torch/scenarios/``) against the reference:
every registry term's hook outputs bit for bit for the same seed, round
and population, the spec parser's errors word for word, ``"null"`` bit for
bit against ``""`` on the dense and the sparse path, and each term on the
sparse path against live reference runs (the pairwise composition matrix
is ``tests/test_torch_scenario_pairs.py``)."""
import dataclasses

import numpy as np
import pytest

from repro_torch.core.resource import make_clients
from repro_torch.core.resource_stacked import stack_clients
from repro_torch.harness import ExperimentConfig, run
from repro_torch.scenarios import REGISTRY, Scenario, parse_scenario
from test_torch_oracle import reference, run_both  # noqa: F401

METRICS = ("round", "test_loss", "test_acc", "participants")
SMALL = dict(model="mlp", dataset=2, num_clients=6, rounds=3,
             capacity=(12, 24), arrivals=4, batch=8, seed=7)
SPARSE = dict(cohort_size=4, participation=0.75)
# every registered term, with arguments that fire within a few rounds
TERMS = {
    "churn": "churn(p_away=0.5,period=2,away=1)",
    "flash_crowd": "flash_crowd(period=2,duty=1,scale=2)",
    "quiet": "quiet(scale=0.5)",
    "radius_step": "radius_step(at=1,factor=1.667)",
    "device_classes": "device_classes(weak_frac=0.5)",
    "cluster_churn": "cluster_churn(rate=0.4)",
    "pareto_select": "pareto_select()",
}


def test_registry_is_the_reference_registry(reference):
    assert sorted(REGISTRY) == sorted(reference.scenarios.REGISTRY)
    assert set(TERMS) == set(REGISTRY)


def _systems(reference, U, seed=3):
    rng = np.random.default_rng(seed)
    got = stack_clients(make_clients(rng, U))
    rng = np.random.default_rng(seed)
    want = reference.resource_stacked.stack_clients(
        reference.resource.make_clients(rng, U))
    return got, want


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name),
                                          err_msg=f"{what}.{f.name}")
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=what)


@pytest.mark.parametrize("name", sorted(TERMS))
def test_term_hooks_equal_the_reference(reference, name):
    """Bind, setup and round hooks of one term and of it composed after
    churn, for three seeds over 10 rounds: every output bit for bit, and
    each hook that does not fire hands back its input itself."""
    U, K = 12, 3
    for spec in (TERMS[name], f"churn()+{TERMS[name]}"):
        for seed in (0, 1, 11):
            got = parse_scenario(spec, seed=seed).bind(U)
            want = reference.scenarios.parse_scenario(spec,
                                                      seed=seed).bind(U)
            assert got.arrival_width(4) == want.arrival_width(4)
            assert got.moves_clusters == want.moves_clusters
            caps = np.random.default_rng(seed).integers(12, 24, U)
            _eq(got.setup_capacities(caps), want.setup_capacities(caps),
                "caps")
            tsys, jsys = _systems(reference, U, seed)
            _eq(got.setup_system(tsys), want.setup_system(jsys), "system")
            p_ac = np.linspace(0.2, 0.9, U)
            for t in range(10):
                ge, gp = got.round_arrivals(t, 4, p_ac)
                we, wp = want.round_arrivals(t, 4, p_ac)
                _eq(ge, we, f"e_u {t}")
                _eq(gp, wp, f"p_ac {t}")
                if gp is not p_ac:
                    assert wp is not p_ac
                _eq(got.round_system(t, tsys), want.round_system(t, jsys),
                    f"system {t}")
                _eq(got.round_available(t, U),
                    want.round_available(t, U), f"available {t}")
                _eq(got.round_selection_weights(t, U),
                    want.round_selection_weights(t, U), f"weights {t}")
                gm = got.round_cluster_moves(t, U, K)
                wm = want.round_cluster_moves(t, U, K)
                _eq(None if gm is None else gm[0],
                    None if wm is None else wm[0], f"movers {t}")
                _eq(None if gm is None else gm[1],
                    None if wm is None else wm[1], f"dest {t}")


def test_null_scenario_hooks_hand_back_their_inputs():
    null = parse_scenario("null", seed=0).bind(5)
    assert isinstance(null, Scenario) and null.is_null
    assert parse_scenario("", seed=0) is None
    p_ac = np.ones(5)
    e_u, p = null.round_arrivals(0, 4, p_ac)
    assert e_u == 4 and p is p_ac
    assert null.round_available(0, 5) is None
    assert null.round_selection_weights(0, 5) is None
    assert null.round_cluster_moves(0, 5, 2) is None
    assert null.arrival_width(8) == 8


@pytest.mark.parametrize("bad", [
    "nope()", "churn(p_away=2.0)", "null+churn()", "churn(bogus_kw=1)",
    "churn(p_away=)", "churn)(", "churn(0.3)", "flash_crowd(scale=1.5)",
    "radius_step(factor=-1)", "cluster_churn(period=0)",
    "pareto_select(alpha=0)", "device_classes(f=0)", "quiet(scale=2)",
    "churn(period=2,away=2)"])
def test_parse_errors_name_what_the_reference_names(reference, bad):
    with pytest.raises(ValueError) as want:
        reference.scenarios.parse_scenario(bad, seed=0)
    with pytest.raises(ValueError) as got:
        parse_scenario(bad, seed=0)
    assert str(got.value) == str(want.value)


def test_rebinding_to_another_population_is_refused(reference):
    msgs = []
    for parse in (parse_scenario, reference.scenarios.parse_scenario):
        scn = parse("churn()", seed=0).bind(6)
        scn.bind(6)                             # idempotent
        with pytest.raises(ValueError) as err:
            scn.bind(7)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("path", [{}, SPARSE,
                                  dict(SPARSE, request_backend="stacked"),
                                  dict(SPARSE, num_clusters=2)],
                         ids=["dense", "sparse", "sparse-stacked",
                              "sparse-clusters"])
def test_null_scenario_is_bit_exact(path):
    base = run("osafl", ExperimentConfig(**SMALL, **path), eval_samples=32,
               device="cpu")
    null = run("osafl", ExperimentConfig(**SMALL, **path, scenario="null"),
               eval_samples=32, device="cpu")
    assert [[h[k] for k in METRICS] for h in base] == [
        [h[k] for k in METRICS] for h in null]


@pytest.mark.parametrize("name", sorted(TERMS))
def test_each_term_matches_live_reference_on_the_sparse_path(
        reference, monkeypatch, name):
    """One term on the sparse path (cluster_churn on a 2-cluster pool, where
    it moves members): participants exact, the loss within 1e-4."""
    run_both(reference, monkeypatch, "osafl",
             dict(SMALL, **SPARSE, scenario=TERMS[name],
                  num_clusters=2 if name == "cluster_churn" else 0))


def test_a_firing_scenario_changes_the_run():
    base = run("osafl", ExperimentConfig(**SMALL), eval_samples=32,
               device="cpu")
    churned = run("osafl", ExperimentConfig(
        **SMALL, scenario="churn(p_away=1.0,period=2,away=1)"),
        eval_samples=32, device="cpu")
    assert ([h["participants"] for h in churned]
            != [h["participants"] for h in base])


def test_cluster_churn_on_a_dense_cluster_run_is_refused(reference):
    """Membership moves need the slot pool: the reference's rule, under
    its key, in both packages."""
    from repro_torch.harness import ExperimentConfigError, resolve
    kw = dict(SMALL, num_clusters=2, scenario=TERMS["cluster_churn"])
    with pytest.raises(reference.harness.ExperimentConfigError) as want:
        reference.harness.resolve(
            "osafl", reference.harness.ExperimentConfig(**kw))
    with pytest.raises(ExperimentConfigError) as got:
        resolve("osafl", ExperimentConfig(**kw))
    assert got.value.key == want.value.key == "cluster-churn"
