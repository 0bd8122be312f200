"""The whole slice: ``repro_torch.harness.run`` against a live run of the
JAX reference with the same seed and the reference's initial weights, and
the port's configuration matrix."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch.harness.experiments as tex
from repro_torch.harness import ExperimentConfig, ExperimentConfigError, run
from repro_torch.harness.compat import ALL_ALGS, PORT_RULES, resolve
from repro_torch.models.small import params_from_numpy
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

MLP = dict(model="mlp", dataset=2, num_clients=16, rounds=3,
           capacity=(16, 32))
# The convolutional slices take global_lr=1: at OSAFL's default of 16 a
# one-ulp change of their initial weights already moves the loss of a later
# round by more than the 1e-4 held below (test_torch_precision.py), so no
# two float32 implementations could be held to it there.
CONV = dict(dataset=1, num_clients=4, rounds=2, capacity=(16, 32),
            global_lr=1.0)
SLICES = {
    "fcn-d1-u4": ("osafl", dict(model="fcn", dataset=1, num_clients=4,
                                rounds=2, capacity=(16, 32))),
    "mlp-d2-u16": ("osafl", MLP),
    **{f"{alg}-mlp-d2-u16": (alg, MLP) for alg in ALL_ALGS[1:]},
    "centralized-mlp-d2-u16": ("centralized", MLP),
    "cnn-d1-u4": ("osafl", dict(model="cnn", **CONV)),
    "squeezenet-d1-u4": ("osafl", dict(model="squeezenet", **CONV)),
    "lstm-d2-u4": ("osafl", dict(model="lstm", dataset=2, num_clients=4,
                                 rounds=2, capacity=(16, 32))),
}
EVAL = 64


@pytest.mark.parametrize("slice_", sorted(SLICES))
def test_run_matches_live_reference(reference, monkeypatch, slice_):
    alg, kw = SLICES[slice_]
    want = reference.harness.run(
        alg, reference.harness.ExperimentConfig(**kw), eval_samples=EVAL)
    w0 = to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(0),
                                                  kw["model"]))
    # the port cannot draw threefry weights: start it from the reference's
    monkeypatch.setattr(tex, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, w0, device))
    got = run(alg, ExperimentConfig(**kw), eval_samples=EVAL, device="cpu")
    U = kw["num_clients"]
    n_eval = U * max(EVAL // U, 20 if alg == "centralized" else 4)
    assert len(got) == len(want) == kw["rounds"]
    for g, w in zip(got, want):
        # the genie's rows gain the port's timings
        assert set(g) == set(w) | {"request_gen_s", "round_s"}
        assert g["round"] == w["round"]
        if alg != "centralized":
            assert g["participants"] == w["participants"]  # same host draws
        # f32 sums in another order, carried over a few rounds
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=1e-4)
        assert abs(g["test_acc"] - w["test_acc"]) <= 1.0 / n_eval + 1e-9
    assert alg == "centralized" or any(g["participants"] for g in got)


BAD = [
    dict(engine="warp"), dict(request_backend="gumbel"),
    dict(round_backend="fused"), dict(resource_backend="f64"),
    dict(engine="loop", request_backend="stacked"),
    dict(cohort_size=99), dict(participation=0.5),
    dict(round_backend="fused", request_backend="stacked", cohort_size=4),
    # the reference's rules on the loop oracle, each under its own key
    dict(engine="loop", cohort_size=4), dict(engine="loop", num_clusters=2),
    dict(engine="loop", round_backend="fused"),
]


@pytest.mark.parametrize("change", BAD)
def test_reference_rules_name_the_same_failure(reference, change):
    xc = dataclasses.replace(ExperimentConfig(num_clients=8), **change)
    rxc = dataclasses.replace(
        reference.harness.ExperimentConfig(num_clients=8), **change)
    with pytest.raises(reference.harness.ExperimentConfigError) as want:
        reference.harness.resolve("osafl", rxc)
    with pytest.raises(ExperimentConfigError) as got:
        resolve("osafl", xc)
    assert got.value.key == want.value.key
    assert str(got.value).startswith("invalid experiment configuration [")


@pytest.mark.parametrize("change,kwargs,key", [
    (dict(engine="loop"), dict(mesh=object()), "port-mesh"),
    (dict(engine="pod"), {}, "port-engine"),
    (dict(round_backend="fused", request_backend="stacked"), {},
     "port-round-backend"),
    (dict(engine="pod", request_backend="stacked", cohort_size=4), {},
     "port-engine"),
    (dict(engine="stacked", resource_backend="f32", num_clusters=2),
     dict(mesh=object()), "port-mesh"),
    (dict(engine="stacked", cohort_size=4), dict(mesh=object()),
     "port-mesh"),
    (dict(engine="pod", num_clusters=2), {}, "port-engine"),
    (dict(engine="stacked"), dict(mesh=object()), "port-mesh"),
    (dict(engine="pod", scenario="churn(p_away=0.3)"), {}, "port-engine"),
    (dict(round_backend="fused", request_backend="stacked",
          scenario="null"), {}, "port-round-backend"),
])
def test_port_rules_reject_what_is_not_ported(change, kwargs, key):
    xc = dataclasses.replace(ExperimentConfig(num_clients=8), **change)
    alg = kwargs.pop("alg", "osafl")
    with pytest.raises(ExperimentConfigError, match="not ported") as err:
        resolve(alg, xc, **kwargs)
    assert err.value.key == key
    assert key in {r.key for r in PORT_RULES}


@pytest.mark.parametrize("alg,kwargs", [
    ("centralized", dict(save_every_k=2, checkpoint_dir="x")),
    ("centralized", dict(resume_from="x")),
    ("centralized", dict(keep_last=1)),
    ("osafl", dict(keep_last=1)),
])
def test_run_rejects_checkpoint_arguments(reference, alg, kwargs):
    """The genie refuses every checkpoint argument, and a stacked run a
    ``keep_last`` without snapshots to prune, with the reference's
    ``ValueError``, before any work."""
    with pytest.raises(ValueError) as want:
        reference.harness.run(alg, reference.harness.ExperimentConfig(
            num_clients=2), **kwargs)
    with pytest.raises(ValueError) as got:
        run(alg, ExperimentConfig(num_clients=2), device="cpu", **kwargs)
    assert str(got.value) == str(want.value)
    assert not isinstance(got.value, ExperimentConfigError)


@pytest.mark.parametrize("change", [
    dict(request_backend="stacked"), dict(resource_backend="f32"),
    dict(request_backend="stacked", resource_backend="f32"),
    dict(engine="loop", resource_backend="f32"),
])
def test_resolve_accepts_the_paper_presets_backends(reference, change):
    """The backends of the paper presets (``benchmarks/table2_dataset1.py``,
    ``table4_dataset2.py``: stacked requests) and the f32 solve resolve as
    the reference resolves them."""
    xc = dataclasses.replace(ExperimentConfig(num_clients=8), **change)
    plan = resolve("osafl", xc)
    want = reference.harness.resolve("osafl", dataclasses.replace(
        reference.harness.ExperimentConfig(num_clients=8), **change))
    assert plan.describe() == want.describe()
    assert not {"port-request-backend", "port-resource-backend",
                "port-checkpoint"} & {r.key for r in PORT_RULES}


@pytest.mark.parametrize("engine", ["stacked", "loop"])
def test_run_accepts_checkpoint_arguments(tmp_path, engine):
    xc = ExperimentConfig(model="mlp", dataset=2, num_clients=2, rounds=2,
                          capacity=(8, 9), engine=engine)
    hist = run("osafl", xc, eval_samples=8, device="cpu", save_every_k=1,
               checkpoint_dir=tmp_path, keep_last=1)
    assert len(hist) == 2
    names = sorted(p.name for p in tmp_path.glob("round_*"))
    assert names == (["round_00002"] if engine == "stacked"
                     else ["round_00002.meta.json", "round_00002.npz"])


def test_null_scenario_is_accepted():
    plan = ExperimentConfig(scenario="null").validate()
    assert plan == resolve("osafl", ExperimentConfig(scenario="null"))
    assert plan.engine == "stacked"
    assert "engine=stacked alg=osafl" in plan.describe()


@pytest.mark.parametrize("alg", list(ALL_ALGS) + ["centralized"])
def test_resolve_accepts_every_algorithm_and_the_genie(alg):
    plan = resolve(alg, ExperimentConfig(num_clients=8))
    assert plan.engine == ("centralized" if alg == "centralized"
                           else "stacked")
    xc = ExperimentConfig(num_clients=8, engine="centralized")
    assert resolve(alg, xc).engine == "centralized"


@pytest.mark.parametrize("alg", ALL_ALGS)
def test_resolve_accepts_the_loop_engine_for_every_algorithm(alg):
    plan = resolve(alg, ExperimentConfig(num_clients=8, engine="loop"))
    assert plan.engine == "loop"
    assert f"engine=loop alg={alg}" in plan.describe()


@pytest.mark.parametrize("alg", ["osafl", "centralized"])
def test_run_holds_convolutions_in_full_f32(monkeypatch, alg):
    """cuDNN's TF32 convolutions are off for the whole run, forward and
    backward, and the caller's setting comes back after, also on an
    error."""
    seen = []

    def body(*args):
        seen.append(torch.backends.cudnn.allow_tf32)
        raise RuntimeError("stop")
    monkeypatch.setattr(tex, "_run_stacked", body)
    monkeypatch.setattr(tex, "_run_centralized", body)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="stop"):
        run(alg, ExperimentConfig(num_clients=2), device="cpu")
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.parametrize("alg,engine", [("osafl", "stacked"),
                                        ("fedavg", "loop"),
                                        ("centralized", "centralized")])
def test_run_holds_cudnn_deterministic(monkeypatch, alg, engine):
    """cuDNN is held to deterministic algorithms without benchmarking for
    the whole run of every engine, and the caller's settings come back
    after, also on an error."""
    seen = []

    def body(*args):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        raise RuntimeError("stop")
    for name in ("_run_stacked", "_run_loop", "_run_centralized"):
        monkeypatch.setattr(tex, name, body)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    with pytest.raises(RuntimeError, match="stop"):
        run(alg, ExperimentConfig(num_clients=2, engine=engine),
            device="cpu")
    assert seen == [(True, False)]
    assert torch.backends.cudnn.deterministic is False
    assert torch.backends.cudnn.benchmark is True
