"""The FL harness's pod engine of the port (``engine="pod"``,
``repro_torch.core.pod``'s online mode, ``"pod"`` snapshots) on the CPU.

  * Against live reference ``_run_pod`` runs on an Auto 1 x 1 mesh (the
    reference's default mesh raises ``ShardingTypeError`` on jax 0.9.0),
    from the reference's weights with python requests: ``test_loss`` and
    ``test_acc`` within 1e-5, ``participants`` equal, for osafl on
    exact_tp and stale, fednova on exact_tp and feddisco on recompute.
    The other engine cases are held to the port's own stacked engine
    (which the other port tests tie to the reference), at the reference's
    pod-parity bar of 1e-5.
  * The online steps against the reference's on the same inputs (the vmap
    and the one-client-at-a-time form), and the batch function against
    ``StackedOnlineBuffer.gather``.
  * Stale scores lag and differ from exact_tp; an unknown ``pod_engine``
    raises; a mesh of two client rows without a process group raises.
  * ``"pod"`` snapshots: resume bit for bit, refuse another ``pod_engine``,
    engine or mesh shape, carry the reference's mesh fields, and a
    python-stream snapshot resumes in the other package both ways (1e-5).
  * Sparse cohorts, clusters, scenarios and sketched scores run on the pod
    engine through the stacked server and equal the stacked engine.
  * The four deprecated shims equal ``run`` with the engine set.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch.harness.experiments as tex
from repro_torch.checkpoint import CheckpointError, load_run_state
from repro_torch.configs.base import FLConfig
from repro_torch.core import pod
from repro_torch.core.buffer_stacked import StackedOnlineBuffer
from repro_torch.core.flatten import tree_get, tree_paths
from repro_torch.harness import (POD_ENGINES, ExperimentConfig,
                                 ExperimentConfigError, checkpoint_path, run,
                                 run_centralized_sgd, run_experiment,
                                 run_pod_online_experiment,
                                 run_vectorized_experiment)
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models.small import params_from_numpy, small_loss
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

TOL = 1e-5            # tests/test_pod_online.py's pod-parity bar
EVAL = 64
SMALL = dict(model="mlp", dataset=2, num_clients=8, rounds=3,
             capacity=(12, 24), arrivals=4, batch=8, seed=5)
STATS = ("round", "test_loss", "test_acc", "participants")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads held at 1 while this module runs: the test
    suite runs several files at once on a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_mesh(reference):
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def ref_weights(reference):
    return to_numpy_tree(reference.small.init_small(
        jax.random.PRNGKey(SMALL["seed"]), SMALL["model"]))


@pytest.fixture
def from_ref_weights(monkeypatch, ref_weights):
    monkeypatch.setattr(tex, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, ref_weights, device))


@pytest.fixture(scope="module")
def ref_exact(reference, ref_mesh, tmp_path_factory):
    """The reference's osafl exact_tp pod run over 4 rounds, a snapshot
    every 2: its history and its checkpoint directory."""
    d = tmp_path_factory.mktemp("ref_pod")
    R = reference.harness
    h = R.run("osafl", R.ExperimentConfig(**dict(SMALL, rounds=4)),
              mesh=ref_mesh, pod_engine="exact_tp", eval_samples=EVAL,
              save_every_k=2, checkpoint_dir=d)
    return h, d


def _close(got, want, tol=TOL, rounds=None):
    rounds = range(len(want)) if rounds is None else rounds
    assert len(got) == len(want)
    for t in rounds:
        g, w = got[t], want[t]
        assert g["round"] == w["round"]
        assert g["participants"] == w["participants"]
        assert abs(g["test_loss"] - w["test_loss"]) <= tol, (t, g, w)
        assert abs(g["test_acc"] - w["test_acc"]) <= tol, (t, g, w)


def _stats(hist):
    return [{k: h[k] for k in STATS} for h in hist]


def _pod(alg, kw=None, engine="exact_tp", **run_kw):
    xc = ExperimentConfig(**dict(SMALL, **(kw or {})))
    return run(alg, xc, eval_samples=EVAL, device="cpu",
               mesh=make_host_mesh(), pod_engine=engine, **run_kw)


# -- the harness against the reference and the stacked engine ---------------

@pytest.mark.parametrize("alg,engine,against", [
    ("osafl", "exact_tp", "reference"),
    ("osafl", "stale", "reference"),
    ("fednova", "exact_tp", "reference"),
    ("feddisco", "recompute", "reference"),
    ("osafl", "recompute", "stacked"),
    ("fedavg", "fedavg", "stacked"),
    ("fedprox", "stale", "stacked"),
    ("afa_cd", "fedavg", "stacked"),
])
def test_pod_matches_the_reference_and_the_stacked_engine(
        reference, ref_mesh, ref_exact, from_ref_weights, alg, engine,
        against):
    got = _pod(alg, engine=engine)
    if against == "stacked":
        want = run(alg, ExperimentConfig(**SMALL), eval_samples=EVAL,
                   device="cpu")
    elif (alg, engine) == ("osafl", "exact_tp"):
        want = ref_exact[0][:SMALL["rounds"]]
    else:
        R = reference.harness
        want = R.run(alg, R.ExperimentConfig(**SMALL), mesh=ref_mesh,
                     pod_engine=engine, eval_samples=EVAL)
    assert set(got[0]) == set(want[0])          # the history's schema
    _close(got, want)
    assert all(h["participants"] for h in got)


def test_engine_pod_without_a_mesh_is_the_host_mesh():
    xc = ExperimentConfig(**SMALL, engine="pod", pod_engine="recompute")
    assert (_stats(run("osafl", xc, eval_samples=EVAL, device="cpu"))
            == _stats(_pod("osafl", engine="recompute")))


def test_the_mesh_names_the_run_s_device():
    """A mesh made on a device runs there; a run given another raises."""
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device == torch.device("cpu")
    got = run("osafl", ExperimentConfig(**SMALL), eval_samples=EVAL,
              mesh=mesh)
    assert _stats(got) == _stats(_pod("osafl"))
    with pytest.raises(ValueError, match="disagree"):
        run("osafl", ExperimentConfig(**SMALL), eval_samples=EVAL,
            mesh=mesh, device="meta")


def test_stale_engine_lags_scores():
    hs, he = _pod("osafl", engine="stale"), _pod("osafl")
    assert all(np.isfinite(h["test_loss"]) for h in hs)
    assert set(hs[0]) == set(he[0])
    assert any(a["test_loss"] != b["test_loss"] for a, b in zip(hs, he))


def test_unknown_pod_engine_raises():
    with pytest.raises(ValueError, match="pod_engine"):
        _pod("osafl", engine="nope")


def test_a_mesh_of_two_rows_raises_naming_a6():
    """Two client rows run as two ranks of a process group (the cases of
    ``test_torch_pod_mesh.py`` and, since ROADMAP A6's second half was
    ported, of ``test_torch_pod_mesh_sparse.py`` for sparse cohorts and
    clusters): with none, the dense run, a sparse or clustered one and the
    online step raise ``ValueError`` naming the process group, and no
    configuration is refused as not ported."""
    two = HostMesh(np.array([[None], [None]], dtype=object))
    assert two.shape == {"data": 2, "model": 1}
    for change in (dict(), dict(cohort_size=8, participation=0.5),
                   dict(num_clusters=2)):
        with pytest.raises(ValueError, match="torch.distributed") as err:
            run("osafl", ExperimentConfig(**SMALL, **change),
                eval_samples=EVAL, device="cpu", mesh=two)
        assert not isinstance(err.value, ExperimentConfigError)
        assert "A6" not in str(err.value)
    with pytest.raises(ValueError, match="torch.distributed"):
        pod.make_tp_train_step(None, FLConfig(), two,
                               batch_fn=pod.make_pod_batch_fn(),
                               grad_fn=lambda p, b: p)


# -- the online steps ---------------------------------------------------------

def _online_inputs(seed=0, U=4, kappa_max=3, B=5):
    """A filled stacked buffer of MLP samples (Dataset-2 layout), its
    sampled slots and kappas (one straggler)."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(6, 12, size=U)
    buf = StackedOnlineBuffer.create(caps, (10,), 100, stage_capacity=16,
                                     dtype=np.int64, device="cpu")
    buf.stage(rng.integers(0, 100, size=(U, 16, 10)),
              rng.integers(0, 100, size=(U, 16)),
              rng.integers(4, 17, size=U))
    buf.commit()
    slots = buf.sample_slots(rng, (kappa_max, B))
    kappas = np.array([3, 0, 1, 2][:U])
    return buf, slots, kappas


def test_batch_fn_is_the_buffer_gather():
    buf, slots, _ = _online_inputs()
    got = pod.make_pod_batch_fn()(buf.state.x, buf.state.y, slots)
    want = buf.gather(slots)
    for k in ("x", "y"):
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("engine", POD_ENGINES)
def test_online_steps_match_the_reference(reference, ref_mesh, ref_weights,
                                          engine):
    buf, slots, kappas = _online_inputs()
    fl = FLConfig(local_lr=0.1, kappa_max=3, num_clients=4)
    jfl = reference.base.FLConfig(**dataclasses.asdict(fl))
    make = {"exact_tp": lambda m, f, mesh, **kw: m(None, f, mesh, **kw),
            "fedavg": lambda m, f, mesh, **kw: m(None, f, mesh, **kw),
            "recompute": lambda m, f, mesh, **kw: m(None, f, mesh, 4, **kw),
            "stale": lambda m, f, mesh, **kw: m(None, f, mesh, 4, **kw)}
    name = {"exact_tp": "make_tp_train_step",
            "recompute": "make_recompute_train_step",
            "stale": "make_stale_score_train_step",
            "fedavg": "make_fedavg_train_step"}[engine]
    import jax.numpy as jnp
    jgrad = jax.grad(lambda p, b: reference.small.small_loss(p, b, "mlp")[0])
    jstep = make[engine](getattr(reference.pod, name), jfl, ref_mesh,
                         batch_fn=reference.pod.make_pod_batch_fn(),
                         grad_fn=jgrad)
    jd, jw = jax.jit(jstep)(
        jax.tree.map(jnp.asarray, ref_weights),
        jnp.asarray(buf.state.x.numpy()),
        jnp.asarray(buf.state.y.numpy().astype(np.int32)),
        jnp.asarray(slots.astype(np.int32)), jnp.asarray(kappas))
    tgrad = torch.func.grad(lambda p, b: small_loss(p, b, "mlp")[0])
    tstep = make[engine](getattr(pod, name), fl, make_host_mesh(),
                         batch_fn=pod.make_pod_batch_fn(), grad_fn=tgrad)
    td, tw = tstep(params_from_numpy("mlp", ref_weights, "cpu"),
                   buf.state.x, buf.state.y, torch.as_tensor(slots),
                   torch.as_tensor(kappas))
    for got, want in ((td, jd), (tw, jw)):
        want = to_numpy_tree(want)
        for p in tree_paths(got):
            np.testing.assert_allclose(tree_get(got, p).numpy(),
                                       tree_get(want, p), rtol=1e-4,
                                       atol=1e-6, err_msg=str(p))
    # the straggler's update is zero, its weights the global ones
    assert all(not tree_get(td, p)[1].any() for p in tree_paths(td))


def test_one_client_at_a_time_matches_the_vmapped_form():
    buf, slots, kappas = _online_inputs(seed=1)
    fl = FLConfig(local_lr=0.1, kappa_max=3, num_clients=4)
    grad = torch.func.grad(lambda p, b: small_loss(p, b, "mlp")[0])
    from repro_torch.models.small import init_small
    w0 = init_small(1, "mlp", "cpu")
    kw = dict(batch_fn=pod.make_pod_batch_fn(), grad_fn=grad)
    args = (w0, buf.state.x, buf.state.y, torch.as_tensor(slots),
            torch.as_tensor(kappas))
    vd, vw = pod.make_tp_train_step(None, fl, make_host_mesh(), **kw)(*args)
    sd, sw = pod.make_recompute_train_step(None, fl, make_host_mesh(), 4,
                                           **kw)(*args)
    for a, b in ((vd, sd), (vw, sw)):
        for p in tree_paths(a):
            assert tree_get(a, p).shape == tree_get(b, p).shape
            torch.testing.assert_close(tree_get(b, p), tree_get(a, p),
                                       rtol=0, atol=TOL)


# -- "pod" snapshots ----------------------------------------------------------

@pytest.mark.parametrize("engine", POD_ENGINES)
def test_pod_resume_is_bit_exact(tmp_path, engine):
    kw = dict(rounds=4)
    straight = _pod("osafl", kw, engine=engine, save_every_k=2,
                    checkpoint_dir=tmp_path)
    snap = load_run_state(checkpoint_path(tmp_path, 2))
    assert snap["engine"] == "pod"
    assert snap["config"]["pod_engine"] == engine
    assert snap["config"]["mesh_axes"] == ["data", "model"]
    assert snap["config"]["mesh_shape"] == [1, 1]
    resumed = _pod("osafl", kw, engine=engine,
                   resume_from=checkpoint_path(tmp_path, 2))
    assert _stats(resumed) == _stats(straight)


def test_pod_snapshot_refuses_another_engine_or_mesh(tmp_path):
    kw = dict(rounds=3)
    _pod("osafl", kw, save_every_k=2, checkpoint_dir=tmp_path)
    at = checkpoint_path(tmp_path, 2)
    with pytest.raises(CheckpointError, match="pod_engine"):
        _pod("osafl", kw, engine="recompute", resume_from=at)
    with pytest.raises(CheckpointError, match="engine"):
        run("osafl", ExperimentConfig(**SMALL), eval_samples=EVAL,
            device="cpu", resume_from=at)
    three_axes = HostMesh(np.full((1, 1, 1), None, dtype=object),
                          axis_names=("pod", "data", "model"))
    with pytest.raises(CheckpointError, match="mesh_shape"):
        run("osafl", ExperimentConfig(**SMALL), eval_samples=EVAL,
            device="cpu", mesh=three_axes, resume_from=at)


def test_pod_snapshots_cross_the_packages(reference, ref_mesh, ref_exact,
                                          from_ref_weights, tmp_path):
    """The reference's round-2 snapshot resumes in the port, and the
    port's in the reference, each within 1e-5 of the other's straight
    run (python request streams)."""
    want, ref_dir = ref_exact
    got = _pod("osafl", dict(rounds=4),
               resume_from=checkpoint_path(ref_dir, 2))
    _close(got, want, rounds=(2, 3))
    straight = _pod("osafl", dict(rounds=4), save_every_k=2,
                    checkpoint_dir=tmp_path)
    R = reference.harness
    back = R.run("osafl", R.ExperimentConfig(**dict(SMALL, rounds=4)),
                 mesh=ref_mesh, pod_engine="exact_tp", eval_samples=EVAL,
                 resume_from=checkpoint_path(tmp_path, 2))
    _close(back, straight, rounds=(2, 3))
    assert [h["round"] for h in back] == [0, 1, 2, 3]


# -- the stacked server's options on the pod engine ---------------------------

@pytest.mark.parametrize("kw", [
    dict(cohort_size=8, participation=0.5),
    dict(num_clusters=2),
    dict(scenario="churn(p_away=0.3)"),
    dict(score_sketch_dim=16),
], ids=["cohort", "clusters", "scenario", "sketch"])
def test_pod_runs_the_stacked_servers_options(kw):
    got = _pod("osafl", kw)
    want = run("osafl", ExperimentConfig(**dict(SMALL, **kw)),
               eval_samples=EVAL, device="cpu")
    assert _stats(got) == _stats(want)
    assert any(h["participants"] for h in got)


# -- the deprecated shims -----------------------------------------------------

@pytest.mark.parametrize("shim,engine", [
    (run_experiment, "loop"),
    (run_vectorized_experiment, "stacked"),
    (run_pod_online_experiment, "pod"),
    (run_centralized_sgd, "centralized"),
])
def test_shims_equal_run_with_the_engine_set(shim, engine):
    xc = ExperimentConfig(**dict(SMALL, rounds=2))
    if engine == "centralized":
        got = shim(xc, eval_samples=EVAL, device="cpu")
        alg = "centralized"
    else:
        got = shim("osafl", xc, eval_samples=EVAL, device="cpu")
        alg = "osafl"
    want = run(alg, dataclasses.replace(xc, engine=engine),
               eval_samples=EVAL, device="cpu")
    keys = ("round", "test_loss", "test_acc") + (
        ("participants",) if engine != "centralized" else ())
    assert ([{k: h[k] for k in keys} for h in got]
            == [{k: h[k] for k in keys} for h in want])
