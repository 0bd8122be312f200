"""What each rank of ``tests/test_torch_pod_mesh_sparse.py``'s process
groups runs: sparse cohorts, edge clusters and cluster churn on the port's
pod engine over client rows, one process a row, on the CPU under gloo.
``torch_pod_mesh_ranks.spawn(two_ranks, 2, ...)`` (or ``four_ranks``, 4)
starts the group; each rank runs every case and pickles its results for
the test to assert on. Like ``torch_pod_mesh_ranks``, this module imports
torch and the port only (the ranks never load JAX).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from torch_pod_mesh_ranks import _raises, host_mesh, pod_run

# U=16 registered users behind C=8 slots, half of them sampled a round
SPARSE = dict(num_clients=16, cohort_size=8, participation=0.5)
CHURN = "cluster_churn(rate=0.3)"
ENGINES = ("exact_tp", "recompute", "stale", "fedavg")
# (case, alg, pod engine, change of SMALL): each runs on the ranks and, in
# the test process, on one row
TWO_RUNS = (
    [(f"sparse osafl {e}", "osafl", e, SPARSE) for e in ENGINES]
    + [(f"sparse {a} exact_tp", a, "exact_tp", SPARSE)
       for a in ("fedavg", "fednova", "feddisco")]
    + [(f"dense K={k}", "osafl", "exact_tp", dict(num_clusters=k))
       for k in (1, 2, 4)]
    + [(f"dense K=2 {a}", a, "exact_tp", dict(num_clusters=2))
       for a in ("fedavg", "fednova")]
    + [("dense K=2 sketch", "osafl", "exact_tp",
        dict(num_clusters=2, score_sketch_dim=16)),
       ("sparse K=1", "osafl", "exact_tp", dict(SPARSE, num_clusters=1)),
       ("sparse K=2 cluster_churn", "osafl", "exact_tp",
        dict(SPARSE, num_clusters=2, scenario=CHURN)),
       ("sparse K=4", "osafl", "exact_tp", dict(SPARSE, num_clusters=4))]
    + [(f"sparse K=2 {a}", a, "exact_tp", dict(SPARSE, num_clusters=2))
       for a in ("fedavg", "fednova")])
FOUR_RUNS = [
    ("dense K=4", "osafl", "exact_tp", dict(num_clusters=4)),
    ("sparse osafl exact_tp", "osafl", "exact_tp", SPARSE),
    ("sparse K=1", "osafl", "exact_tp", dict(SPARSE, num_clusters=1)),
    ("sparse K=4", "osafl", "exact_tp", dict(SPARSE, num_clusters=4)),
    ("sparse K=8 cluster_churn", "osafl", "exact_tp",
     dict(SPARSE, num_clusters=8, scenario=CHURN))]
# the live reference anchor's configuration (python requests: the
# reference's stacked stream draws threefry noise)
ANCHOR = SPARSE
# the sparse hierarchical snapshot: a snapshot every 2 of 4 rounds
SNAPSHOT = dict(SPARSE, num_clusters=2, scenario=CHURN, rounds=4,
                request_backend="stacked")
TABLE_USERS = 16


def run_cases(runs) -> dict:
    """Each case of ``runs`` on this process's host mesh (its rank's
    row, or one row with no process group), keyed by case."""
    return {case: pod_run(alg, engine, **kw)
            for case, alg, engine, kw in runs}


def _tables_case() -> dict:
    """Per-user tables split over the ranks against one process's: each
    rank holds U/R users; ``gather`` of users in any order (owned by every
    rank) and ``scatter`` of new values equal one process's."""
    from repro_torch.checkpoint.run_state import RowShard
    from repro_torch.core.cohort import CohortTables
    rng = np.random.default_rng(4)
    init = {"participated": rng.random(TABLE_USERS) < 0.5,
            "scores": rng.random(TABLE_USERS).astype(np.float32),
            "lam_prev": rng.random(TABLE_USERS).astype(np.float32)}
    plain = CohortTables(TABLE_USERS, init, device="cpu")
    split = CohortTables(TABLE_USERS, init, device="cpu", mesh=host_mesh())
    lo, hi = split.rows
    users = rng.permutation(TABLE_USERS)[:11]
    got, want = split.gather(users), plain.gather(users)
    gathered = all(torch.equal(got[k], want[k]) for k in init)
    dtypes = all(got[k].dtype == want[k].dtype for k in init)
    values = {"participated": rng.random(11) < 0.5,
              "scores": rng.random(11).astype(np.float32),
              "lam_prev": torch.as_tensor(rng.random(11), dtype=torch.float32)}
    split.scatter(users, values)
    plain.scatter(users, values)
    sd = split.state_dict()
    return {
        "rows": (lo, hi),
        "local_lengths": [int(split[k].shape[0]) for k in init],
        "gathered": gathered and dtypes,
        "scattered": all(torch.equal(split[k], plain[k][lo:hi])
                         for k in init),
        "state_dict_rows": all(isinstance(v, RowShard) and v.start == lo
                               and v.rows == TABLE_USERS
                               for v in sd.values()),
    }


def _reset_rows_case() -> dict:
    """``reset_rows`` on a sharded buffer against a plain one, after
    wrap-heavy stages and commits, with slots of both ranks reset; the
    replaced pointer tensors leave an earlier snapshot's alone."""
    from repro_torch.core.buffer_stacked import StackedOnlineBuffer
    caps = np.random.default_rng(3).integers(4, 9, size=8)
    plain = StackedOnlineBuffer.create(caps, (3,), 10, stage_capacity=24,
                                       depth=12, device="cpu")
    shard = StackedOnlineBuffer.create(caps, (3,), 10, stage_capacity=24,
                                       depth=12, device="cpu",
                                       mesh=host_mesh())
    pointers = ("cap", "size", "head", "staged_n")
    for buf in (plain, shard):
        rng = np.random.default_rng(7)
        for it in range(5):
            counts = rng.integers(0, 7, size=8)
            buf.stage(rng.normal(size=(8, 6, 3)).astype(np.float32),
                      rng.integers(0, 10, size=(8, 6)), counts)
            if it == 2:
                before = {k: getattr(buf.state, k) for k in pointers}
                held = {k: t.clone() for k, t in before.items()}
                buf.reset_rows([1, 6, 3], [12, 5, 9])
            if it % 2:
                buf.commit()
    lo, hi, _ = shard.rows
    return {
        "pointers": all(np.array_equal(getattr(plain, a), getattr(shard, a))
                        for a in ("sizes", "heads", "capacities")),
        "datasets": all(np.array_equal(plain.dataset(u)[k],
                                       shard.dataset(u)[k])
                        for u in range(lo, hi) for k in (0, 1)),
        "staged": torch.equal(plain.state.staged_n[lo:hi],
                              shard.state.staged_n),
        "snapshot_kept": all(torch.equal(before[k], held[k])
                             for k in pointers),
        "local_rows": [int(getattr(shard.state, k).shape[0])
                       for k in pointers],
    }


def _mover_case() -> dict:
    """A resident moved by ``apply_cluster_moves`` to a cluster block that
    lies on the other rank: its carried table values reach the new slot
    on every rank, the slot's contribution row resets on its owner, and
    the result equals one process's server."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.baselines import make_server
    from repro_torch.models.small import init_small
    fl = FLConfig(num_clients=16, engine="stacked", cohort_size=8,
                  participation=0.5, num_clusters=2, algorithm="osafl")
    out = {}
    for name, mesh in (("plain", None), ("split", host_mesh())):
        srv = make_server(init_small(0, "mlp", "cpu"), fl, 16, device="cpu",
                          mesh=mesh)
        srv.admit(srv.initial_residents())
        srv.inner.d_buffer.fill_(7.0)
        srv.tables.scatter([1], {"participated": [True], "scores": [0.5],
                                 "lam_prev": [0.25]})
        moved, res = srv.apply_cluster_moves([1], [1])
        lo, hi = srv.slots
        out[name] = {"moved": moved.tolist(), "slots": res.slots.tolist(),
                     "lam_prev": srv.inner._lam_prev.clone(),
                     "last_scores": np.array(srv.inner.last_scores),
                     "part": srv.inner.participated.clone(),
                     "rows": srv.inner.d_buffer[:, 0].clone(),
                     "bounds": (lo, hi)}
    p, s = out["plain"], out["split"]
    lo, hi = s["bounds"]
    return {
        "moved": s["moved"], "slots": s["slots"], "bounds": (lo, hi),
        "lam_prev": float(s["lam_prev"][s["slots"][0]]),
        "last_score": float(s["last_scores"][s["slots"][0]]),
        "same_as_one_process": (
            s["moved"] == p["moved"] and s["slots"] == p["slots"]
            and torch.equal(s["lam_prev"], p["lam_prev"])
            and np.array_equal(s["last_scores"], p["last_scores"])
            and torch.equal(s["part"], p["part"][lo:hi])
            and torch.equal(s["rows"], p["rows"][lo:hi])),
    }


def _snapshot_case(root: Path) -> dict:
    """A sparse hierarchical run under cluster churn writing a snapshot
    every 2 of 4 rounds, and the run resumed from round 2 on the ranks."""
    from repro_torch.harness import checkpoint_path
    kw = dict(SNAPSHOT)
    straight = pod_run("osafl", **kw, run_kw=dict(
        save_every_k=2, checkpoint_dir=root))
    resumed = pod_run("osafl", **kw, run_kw=dict(
        resume_from=checkpoint_path(root, 2)))
    return {"straight": straight, "resumed": resumed, "dir": str(root)}


def two_ranks(rank: int, payload: dict) -> dict:
    return {
        "tables": _tables_case(),
        "reset_rows": _reset_rows_case(),
        "mover": _mover_case(),
        "runs": run_cases(TWO_RUNS),
        "rerun": pod_run("osafl", **SPARSE),
        "anchor": pod_run("osafl", weights=payload["ref_weights"],
                          **ANCHOR),
        "snapshot": _snapshot_case(Path(payload["ckpt"])),
        "refused": {"cohort_size % R": _raises(lambda: pod_run(
            "osafl", **dict(SPARSE, cohort_size=5)))},
    }


def one_row(rank: int, payload: dict) -> dict:
    """Every case of ``TWO_RUNS`` and ``FOUR_RUNS`` on one row: the one
    rank of a group of one, which equals no group bit for bit
    (``tests/test_torch_pod_mesh.py``)."""
    return run_cases(TWO_RUNS + FOUR_RUNS)


def four_ranks(rank: int, payload: dict) -> dict:
    return {
        "tables": _tables_case(),
        "runs": run_cases(FOUR_RUNS),
        "refused": {
            "cohort_size % R": _raises(lambda: pod_run(
                "osafl", **dict(SPARSE, cohort_size=6))),
            "hier-mesh": _raises(lambda: pod_run(
                "osafl", **dict(SPARSE, num_clusters=2)))},
    }

