"""The pod engine over client rows, one process a row, on the CPU under
gloo (``tests/torch_pod_mesh_ranks.py`` holds what each rank runs).

One group of 2 ranks runs every harness case once and one group of 4 the
stationary engines; the tests below assert on what the ranks handed back:

  * the sharded FIFO buffer equals the plain one over wrap-heavy stages and
    commits, each rank holding U/R rows (``tests/test_pod_online.py``'s
    case);
  * every pod engine with osafl, and fedavg, fednova and feddisco on
    exact_tp, on 2 ranks against the port's one-row run (``test_loss``
    within 1e-5, ``participants`` equal), and osafl exact_tp from the
    reference's weights against a live reference ``_run_pod`` on the Auto
    1 x 1 mesh; every rank returns the same history, a rerun repeats it
    bit for bit, and a group of one rank equals no group bit for bit;
  * the stationary exact_tp on 4 ranks (the two-phase scored all-reduce)
    against recompute with U=4 in one process, at the reference's bars
    (``tests/test_pod_engine.py``: lambda 1e-3, params 5e-3), and sketched
    scores within 0.1 of exact;
  * a 2-rank pod snapshot resumes bit for bit on 2 ranks, reads whole in
    one process and is refused on another mesh shape; U % R != 0,
    C % R != 0, K > 1 with K % R != 0 (``hier-mesh``) and v1 snapshots on
    2 rows raise, while a sparse cohort and edge clusters run
    (``test_torch_pod_mesh_sparse.py`` holds them to one row).
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_pod_mesh_ranks as ranks
from repro_torch.checkpoint import CheckpointError, load_run_state
from repro_torch.configs.base import FLConfig
from repro_torch.core import pod
from repro_torch.harness import checkpoint_path
from repro_torch.launch.mesh import make_host_mesh
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

TOL = 1e-5            # tests/test_pod_online.py's pod-parity bar
STATS = ("round", "test_loss", "test_acc", "participants")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_weights(reference):
    return to_numpy_tree(reference.small.init_small(
        jax.random.PRNGKey(ranks.SMALL["seed"]), ranks.SMALL["model"]))


@pytest.fixture(scope="module")
def two_and_here(reference, tmp_path_factory, ref_weights):
    """Both ranks' results of ``torch_pod_mesh_ranks.two_ranks``, and,
    run here while the ranks run: the reference's osafl exact_tp
    ``_run_pod`` on the Auto 1 x 1 mesh and the port's one-row runs of the
    same cases."""
    from jax.sharding import AxisType

    def here():
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        R = reference.harness
        ref = R.run("osafl", R.ExperimentConfig(**ranks.SMALL), mesh=mesh,
                    pod_engine="exact_tp", eval_samples=ranks.EVAL)
        one_row = {f"{a} {e}": ranks.pod_run(a, e) for a, e in ranks.RUNS}
        one_row.update({case: ranks.pod_run("osafl", **kw)
                        for case, kw in ranks.OPTIONS})
        return ref, one_row
    out = tmp_path_factory.mktemp("two_ranks")
    return ranks.spawn("two", 2, {"ref_weights": ref_weights,
                                  "ckpt": str(out / "ckpt")}, out,
                       meanwhile=here)


@pytest.fixture(scope="module")
def two(two_and_here):
    return two_and_here[0]


@pytest.fixture(scope="module")
def one_row(two_and_here):
    """The port's one-row runs of the cases, in this process."""
    return two_and_here[1][1]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return ranks.spawn("four", 4, {}, tmp_path_factory.mktemp("four"))[0]


def _stats(hist):
    return [{k: h[k] for k in STATS} for h in hist]


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert g["participants"] == w["participants"]
        assert abs(g["test_loss"] - w["test_loss"]) <= tol, (g, w)
        assert abs(g["test_acc"] - w["test_acc"]) <= tol, (g, w)


# -- the sharded buffer ------------------------------------------------------

@pytest.mark.parametrize("check", ["datasets", "pointers", "histograms",
                                   "slots", "rows", "foreign_client"])
def test_sharded_buffer_equals_the_plain_buffer(two, check):
    for r, res in enumerate(two):
        b = res["buffer"]
        if check == "rows":
            assert b["rows"] == (4 * r, 4 * r + 4)
            assert b["storage_rows"] == [4] * 8
        elif check == "foreign_client":
            assert b[check].startswith("IndexError"), b[check]
        else:
            assert b[check] is True, (r, check)


# -- the harness on 2 ranks --------------------------------------------------

@pytest.mark.parametrize("name", [f"{a} {e}" for a, e in ranks.RUNS])
def test_two_ranks_match_the_one_row_run(two, one_row, name):
    for res in two:
        got = res["runs"][name]
        _close(got, one_row[name])
        assert all(h["participants"] for h in got)


def test_two_ranks_match_a_live_reference_run(two_and_here):
    two, (want, _) = two_and_here
    for res in two:
        _close(res["from_reference"], want)


@pytest.mark.parametrize("case", ["runs", "rerun"]
                         + [case for case, _ in ranks.OPTIONS])
def test_every_rank_returns_the_same_history(two, case):
    assert two[0][case] == two[1][case]      # round_s and request_gen_s too


def test_a_rerun_repeats_bit_for_bit(two):
    for res in two:
        assert _stats(res["rerun"]) == _stats(res["runs"]["osafl exact_tp"])


@pytest.mark.parametrize("case", [case for case, _ in ranks.OPTIONS])
def test_server_options_on_two_ranks_match_one_row(two, one_row, case):
    """Sketched scores, stacked requests and the paper's global_lr=16 on 2
    ranks against the one-row run; the gap at 16 is printed (a split sum
    rounds like a one-ulp change of the weights there)."""
    want = one_row[case]
    got = two[0][case]
    print(case, "loss gaps", [abs(g["test_loss"] - w["test_loss"])
                              for g, w in zip(got, want)])
    _close(got, want)


def test_a_group_of_one_rank_equals_no_group():
    want = ranks.pod_run("osafl")
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{ranks.free_port()}")
    try:
        mesh = make_host_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.row == 0
        got = ranks.pod_run("osafl")
    finally:
        dist.destroy_process_group()
    assert _stats(got) == _stats(want)


# -- snapshots ---------------------------------------------------------------

def test_two_rank_snapshot_resumes_bit_for_bit(two):
    for res in two:
        snap = res["snapshot"]
        assert _stats(snap["resumed"]) == _stats(snap["straight"])
        assert snap["other_engine"].startswith("CheckpointError")
        assert "pod_engine" in snap["other_engine"]


def test_two_rank_snapshot_reads_whole_and_refuses_one_row(two):
    at = checkpoint_path(two[0]["snapshot"]["dir"], 2)
    snap = load_run_state(at)
    assert snap["config"]["mesh_shape"] == [2, 1]
    assert snap["server"]["d_buffer"].shape[0] == ranks.SMALL["num_clients"]
    assert snap["buffer"]["x"].shape[0] == ranks.SMALL["num_clients"]
    assert not any(at.glob("part.r*.json"))
    with pytest.raises(CheckpointError, match="mesh_shape"):
        ranks.pod_run("osafl", rounds=ranks.SNAPSHOT_ROUNDS,
                      run_kw=dict(resume_from=at))


# -- what two rows do not run ------------------------------------------------

@pytest.mark.parametrize("case,raised", [
    ("indivisible", "ValueError: num_clients 9 is not divisible"),
    ("cohort", "ValueError: cohort_size 3 is not divisible by the mesh's 2 "
               "client rows"),
    ("clusters", "ExperimentConfigError: invalid experiment configuration "
                 "[hier-mesh]: num_clusters 3 is not a multiple of the "
                 "mesh's 2 client rows"),
    ("v1_snapshots", "ValueError: checkpoint_async=False"),
])
def test_what_two_rows_do_not_run_raises(two, case, raised):
    """The rows' refusals are the reference's own; a sparse cohort
    (C % R == 0) and edge clusters (K % R == 0) run on two rows."""
    for res in two:
        assert res["refused"][case].startswith(raised), res["refused"]
        if case in ("cohort", "clusters"):
            hist = res["ran"][case]
            assert len(hist) == ranks.SMALL["rounds"]
            assert all(np.isfinite(h["test_loss"]) for h in hist)
            assert hist == two[0]["ran"][case]


# -- the stationary engines on 4 ranks ---------------------------------------

@pytest.fixture(scope="module")
def recompute_one_process():
    cfg, params, batch = ranks.zoo_inputs("qwen1.5-4b")
    fl = FLConfig(**ranks.STATIONARY)
    per = {k: x.reshape((4, 2) + tuple(x.shape[1:]))
           for k, x in batch.items()}
    p, m = pod.make_recompute_train_step(cfg, fl, None, 4)(params, per)
    return {k: float(v) for k, v in m.items()}, ranks.flat(p), (
        cfg, params, batch, per, fl)


def test_exact_tp_on_four_ranks_is_the_scored_all_reduce(
        four, recompute_one_process):
    metrics, params, _ = recompute_one_process
    tp = four[0]["exact_tp"]
    gap_lam = abs(tp["metrics"]["lambda_mean"] - metrics["lambda_mean"])
    gap_p = float(np.abs(tp["params"] - params).max())
    print(f"exact_tp on 4 ranks vs recompute: lambda {gap_lam:.3e}, "
          f"params {gap_p:.3e}")
    assert gap_lam < 1e-3 and gap_p < 5e-3
    assert 0.0 <= tp["metrics"]["lambda_mean"] <= 1.0
    assert four[0]["pod_clients"] == 4
    for other in four[1:]:
        assert np.array_equal(other["exact_tp"]["params"], tp["params"])
        assert other["exact_tp"]["metrics"] == tp["metrics"]


@pytest.mark.parametrize("engine", ["recompute", "stale", "fedavg"])
def test_stationary_engines_on_four_ranks_match_one_process(
        four, recompute_one_process, engine):
    cfg, params, batch, per, fl = recompute_one_process[2]
    if engine == "recompute":
        p, m = pod.make_recompute_train_step(cfg, fl, None, 4)(params, per)
    elif engine == "stale":
        p, lam, m = pod.make_stale_score_train_step(cfg, fl, None, 4)(
            params, torch.linspace(0.5, 1.0, 4), per)
        np.testing.assert_allclose(four[0]["stale"]["lam_next"],
                                   lam.numpy(), rtol=0, atol=1e-5)
    else:
        p, m = pod.make_fedavg_train_step(cfg, fl)(params, batch)
    got = four[0][engine]
    np.testing.assert_allclose(got["params"], ranks.flat(p), rtol=0,
                               atol=1e-5)
    for k, v in m.items():
        assert abs(got["metrics"][k] - float(v)) <= 1e-5, k
    for other in four[1:]:
        assert np.array_equal(other[engine]["params"], got["params"])


def test_sketched_scores_approximate_exact_on_four_ranks(four):
    exact = four[0]["danube exact"]["lambda_mean"]
    sketch = four[0]["danube sketch"]["lambda_mean"]
    assert abs(exact - sketch) < 0.1, (exact, sketch)
