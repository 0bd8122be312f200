"""Sparse cohorts, edge clusters and cluster churn on the pod engine over
client rows, one process a row, on the CPU under gloo
(``tests/torch_pod_mesh_sparse_ranks.py`` holds what each rank runs).

One group of 2 ranks, one of 4 and the one-row runs (in a group of one
rank) run at the same time, and this process runs the live reference run
meanwhile; the tests below assert on what the ranks handed back:

  * the per-user tables hold U/R users a rank, and their ``gather`` and
    ``scatter`` equal one process's; a sharded ``reset_rows`` equals the
    plain buffer's; a resident moved to a cluster block on the other rank
    carries its table values there, as in one process;
  * sparse OSAFL on every pod engine and fedavg, fednova and feddisco on
    exact_tp, dense K=1, 2 and 4, hierarchical fedavg and fednova (dense
    and sparse), sketched scores with K=2, sparse K=1 and 4, and sparse
    K=2 under ``cluster_churn`` on 2 ranks, and dense K=4 and sparse K=0,
    1, 4 and 8 (under ``cluster_churn``) on 4 ranks, each against the
    port's one-row run (``test_loss`` within 1e-5, participants equal);
    a sparse run from the reference's weights against a live reference
    ``run_pod_online_experiment`` on the Auto 1 x 1 mesh; every rank
    returns the same history, and a rerun repeats it bit for bit;
  * a 2-rank sparse hierarchical snapshot resumes bit for bit on 2 ranks,
    reads whole in one process and is refused on one row;
  * ``cohort_size % R`` and K=2 on 4 ranks raise the reference's errors.
"""
from pathlib import Path

import jax
import pytest
import torch

import torch_pod_mesh_ranks as ranks
import torch_pod_mesh_sparse_ranks as sparse
from repro_torch.checkpoint import CheckpointError, load_run_state
from repro_torch.checkpoint.streaming import read_manifest
from repro_torch.harness import checkpoint_path
from test_torch_oracle import (_imported_roots, reference,  # noqa: F401
                               to_numpy_tree)

TOL = 1e-5            # tests/test_pod_online.py's pod-parity bar
STATS = ("round", "test_loss", "test_acc", "participants")
U, C = sparse.SPARSE["num_clients"], sparse.SPARSE["cohort_size"]


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
def groups(reference, tmp_path_factory, ref_weights):
    """``(two, four, (reference run, one-row runs))``: both ranks' results
    of ``two_ranks``, the four ranks' of ``four_ranks``, the one-row runs
    of every case (``one_row``, in a process of its own) and, run here
    while those seven processes run, the reference's sparse osafl
    exact_tp on the Auto 1 x 1 mesh."""
    from jax.sharding import AxisType

    def here():
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        R = reference.harness
        return R.run_pod_online_experiment(
            "osafl", R.ExperimentConfig(**dict(ranks.SMALL,
                                               **sparse.ANCHOR)),
            eval_samples=ranks.EVAL, mesh=mesh, pod_engine="exact_tp")

    def started(job, nprocs, payload, meanwhile):
        out = tmp_path_factory.mktemp(job.__name__)
        return lambda: ranks.spawn(job, nprocs, dict(payload, ckpt=str(
            out / "ckpt")), out, meanwhile=meanwhile)

    two, (four, ((one,), ref)) = started(
        sparse.two_ranks, 2, {"ref_weights": ref_weights},
        started(sparse.four_ranks, 4, {},
                started(sparse.one_row, 1, {}, here)))()
    return two, four, (ref, one)


@pytest.fixture(scope="module")
def two(groups):
    return groups[0]


@pytest.fixture(scope="module")
def four(groups):
    return groups[1]


@pytest.fixture(scope="module")
def one_row(groups):
    return groups[2][1]


def _stats(hist):
    return [{k: h[k] for k in STATS} for h in hist]


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert g["participants"] == w["participants"]
        assert abs(g["test_loss"] - w["test_loss"]) <= tol, (g, w)
        assert abs(g["test_acc"] - w["test_acc"]) <= tol, (g, w)


def test_rank_modules_import_no_jax():
    for mod in (ranks, sparse):
        roots = {root for root, _ in _imported_roots(Path(mod.__file__))}
        assert not roots & {"jax", "jaxlib", "repro"}, (mod, roots)


# -- the per-user tables, reset_rows and a mover -----------------------------

@pytest.mark.parametrize("group", ["two", "four"])
def test_tables_hold_their_rank_s_users(groups, group):
    res = groups[0] if group == "two" else groups[1]
    R = len(res)
    for r, out in enumerate(res):
        t = out["tables"]
        n = sparse.TABLE_USERS // R
        assert t["rows"] == (r * n, (r + 1) * n)
        assert t["local_lengths"] == [n] * 3
        for check in ("gathered", "scattered", "state_dict_rows"):
            assert t[check] is True, (r, check)


@pytest.mark.parametrize("check", ["pointers", "datasets", "staged",
                                   "snapshot_kept", "local_rows"])
def test_sharded_reset_rows_equals_the_plain_buffer(two, check):
    for r, res in enumerate(two):
        got = res["reset_rows"][check]
        if check == "local_rows":
            assert got == [4] * 4
        else:
            assert got is True, (r, check)


def test_a_mover_carries_its_tables_to_a_block_on_another_rank(two):
    for r, res in enumerate(two):
        m = res["mover"]
        # user 1 leaves cluster 0 (slots 0-3, rank 0) for cluster 1's
        # block (slots 4-7, rank 1), where it takes slot 4
        assert m["moved"] == [1] and m["slots"] == [4]
        assert m["bounds"] == (4 * r, 4 * r + 4)
        assert m["lam_prev"] == 0.25 and m["last_score"] == 0.5
        assert m["same_as_one_process"] is True


# -- the runs against one row ------------------------------------------------

@pytest.mark.parametrize("case", [c for c, *_ in sparse.TWO_RUNS])
def test_two_ranks_match_the_one_row_run(two, one_row, case):
    for res in two:
        _close(res["runs"][case], one_row[case])
    assert all(h["participants"] for h in two[0]["runs"][case])


@pytest.mark.parametrize("case", [c for c, *_ in sparse.FOUR_RUNS])
def test_four_ranks_match_the_one_row_run(four, one_row, case):
    for res in four:
        _close(res["runs"][case], one_row[case])


def test_sparse_two_ranks_match_a_live_reference_run(groups):
    two, _, (want, _) = groups
    for res in two:
        _close(res["anchor"], want)


@pytest.mark.parametrize("group,case", [
    ("two", "runs"), ("two", "rerun"), ("two", "anchor"),
    ("two", "snapshot"), ("four", "runs")])
def test_every_rank_returns_the_same_history(groups, group, case):
    res = groups[0] if group == "two" else groups[1]
    for other in res[1:]:
        assert other[case] == res[0][case]   # round_s, request_gen_s too


def test_a_rerun_repeats_bit_for_bit(two):
    for res in two:
        assert _stats(res["rerun"]) == _stats(
            res["runs"]["sparse osafl exact_tp"])


# -- snapshots ---------------------------------------------------------------

def test_sparse_hierarchical_snapshot_resumes_bit_for_bit(two):
    for res in two:
        snap = res["snapshot"]
        assert _stats(snap["resumed"]) == _stats(snap["straight"])
        assert len(snap["straight"]) == sparse.SNAPSHOT["rounds"]


def test_sparse_hierarchical_snapshot_reads_whole_and_refuses_one_row(two):
    at = checkpoint_path(two[0]["snapshot"]["dir"], 2)
    snap = load_run_state(at)
    assert snap["config"]["mesh_shape"] == [2, 1]
    server = snap["server"]
    assert server["inner"]["d_buffer"].shape[0] == C
    assert server["inner"]["clam_prev"].shape == (2,)
    assert snap["buffer"]["x"].shape[0] == C
    for k in ("participated", "scores", "lam_prev"):
        assert server["tables"][k].shape == (U,)
    # each rank wrote its U/R users of every table as its own shard
    arrays = read_manifest(at)["arrays"]
    tables = [e for key, e in arrays.items() if "/tables/" in key]
    assert len(tables) == 3
    for ent in tables:
        assert ent.get("split") == "rows"
        assert sorted(s["index"][0] for s in ent["shards"]) == [
            [0, U // 2], [U // 2, U]]
    assert not any(at.glob("part.r*.json"))
    with pytest.raises(CheckpointError, match="mesh_shape"):
        ranks.pod_run("osafl", **sparse.SNAPSHOT,
                      run_kw=dict(resume_from=at))


# -- what rows refuse ----------------------------------------------------------

@pytest.mark.parametrize("group,case,raised", [
    ("two", "cohort_size % R",
     "ValueError: cohort_size 5 is not divisible by the mesh's 2 client "
     "rows (the slot-indexed buffer shards over the client axes; each "
     "shard must own whole slots)"),
    ("four", "cohort_size % R",
     "ValueError: cohort_size 6 is not divisible by the mesh's 4 client "
     "rows (the slot-indexed buffer shards over the client axes; each "
     "shard must own whole slots)"),
    ("four", "hier-mesh",
     "ExperimentConfigError: invalid experiment configuration [hier-mesh]: "
     "num_clusters 2 is not a multiple of the mesh's 4 client rows: with "
     "K>1 each mesh shard must own whole cluster slot blocks (K=1 spans "
     "shards exactly like the flat buffer and is exempt)"),
])
def test_what_rows_refuse_raises_the_reference_s_words(groups, group, case,
                                                       raised):
    res = groups[0] if group == "two" else groups[1]
    for out in res:
        assert out["refused"][case] == raised
