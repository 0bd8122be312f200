"""What each rank of ``tests/test_torch_pod_mesh.py``'s process groups runs:
the port's pod engine over client rows, one process a row, on the CPU
under gloo. ``spawn(job, nprocs, payload, out)`` starts ``nprocs`` ranks
with ``torch.multiprocessing.spawn``; each joins the group, runs every
case of ``JOBS[job]`` and pickles its results to ``out``; the test then
asserts on them, so each case counts without a spawn of its own. This
module imports torch and the port only (the ranks never load JAX).
"""
from __future__ import annotations

import dataclasses
import pickle
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

EVAL = 64
SMALL = dict(model="mlp", dataset=2, num_clients=8, rounds=3,
             capacity=(12, 24), arrivals=4, batch=8, seed=5)
# the pod engines with osafl, and the baselines on exact_tp
RUNS = ([("osafl", e) for e in ("exact_tp", "recompute", "stale", "fedavg")]
        + [(a, "exact_tp") for a in ("fedavg", "fednova", "feddisco")])
# the server's options on two ranks against one row: (case, config change)
OPTIONS = (("sketch", dict(score_sketch_dim=16)),
           ("stacked_requests", dict(request_backend="stacked")),
           ("global_lr=16", dict(global_lr=16.0)))
STATIONARY = dict(kappa_max=1, local_lr=0.05, global_lr=1.0, num_clients=4)
SKETCH_DIM = 4096
SNAPSHOT_ROUNDS = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(job, nprocs: int, payload: dict, out: Path, meanwhile=None):
    """Run ``JOBS[job]`` (or ``job`` itself, a module-level function of
    another JAX-free rank module) on ``nprocs`` gloo ranks; returns each
    rank's results, in rank order, and what ``meanwhile()`` returns,
    called in this process while the ranks run. A rank that raises fails
    the spawn."""
    out = Path(out)
    ctx = mp.start_processes(
        _rank, args=(nprocs, free_port(), job, payload, str(out)),
        nprocs=nprocs, join=False, start_method="spawn")
    done = meanwhile() if meanwhile is not None else None
    while not ctx.join():
        pass
    results = []
    for r in range(nprocs):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results, done


def _rank(rank: int, nprocs: int, port: int, job, payload: dict,
          out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=nprocs, rank=rank)
    try:
        res = (JOBS[job] if isinstance(job, str) else job)(rank, payload)
    finally:
        dist.destroy_process_group()
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(device="cpu")


def pod_run(alg: str, engine: str = "exact_tp", **kw):
    """One pod run of ``SMALL`` (changed by ``kw``; ``run_kw`` and
    ``weights`` taken out) on this process's host mesh."""
    import repro_torch.harness.experiments as tex
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.models.small import params_from_numpy
    run_kw = kw.pop("run_kw", {})
    weights = kw.pop("weights", None)
    seeded = tex.init_small
    if weights is not None:
        tex.init_small = lambda seed, name, device: params_from_numpy(
            name, weights, device)
    try:
        return run(alg, ExperimentConfig(**dict(SMALL, **kw)),
                   eval_samples=EVAL, mesh=host_mesh(), pod_engine=engine,
                   **run_kw)
    finally:
        tex.init_small = seeded


def _raises(fn) -> str:
    """The name of the exception ``fn()`` raises and its message."""
    try:
        fn()
    except Exception as e:             # the case records what was raised
        return f"{type(e).__name__}: {e}"
    return ""


# ---------------------------------------------------------------------------
# two ranks: the harness
# ---------------------------------------------------------------------------

def _buffer_case(rank: int) -> dict:
    """A sharded buffer against a plain one over wrap-heavy stages and
    commits (``tests/test_pod_online.py``'s case)."""
    from repro_torch.core.buffer_stacked import StackedOnlineBuffer
    caps = np.random.default_rng(3).integers(4, 9, size=8)
    plain = StackedOnlineBuffer.create(caps, (3,), 10, stage_capacity=24,
                                       device="cpu")
    shard = StackedOnlineBuffer.create(caps, (3,), 10, stage_capacity=24,
                                       device="cpu", mesh=host_mesh())
    moved = StackedOnlineBuffer.create(caps, (3,), 10, stage_capacity=24,
                                       device="cpu")
    for buf in (plain, shard, moved):
        rng = np.random.default_rng(7)
        for it in range(6):
            counts = rng.integers(0, 7, size=8)
            x = rng.normal(size=(8, 6, 3)).astype(np.float32)
            y = rng.integers(0, 10, size=(8, 6))
            buf.stage(x, y, counts)
            if it % 2:
                buf.commit()
            if buf is moved and it == 2:
                buf.shard(host_mesh())
    lo, hi, _ = shard.rows
    mine = range(lo, hi)
    slots_rng = [np.random.default_rng(11) for _ in range(2)]
    return {
        "rows": (lo, hi),
        "storage_rows": [int(t.shape[0]) for t in shard.state],
        "datasets": all(
            np.array_equal(plain.dataset(u)[k], b.dataset(u)[k])
            for u in mine for k in (0, 1) for b in (shard, moved)),
        "pointers": all(
            np.array_equal(getattr(plain, a), getattr(b, a))
            for a in ("sizes", "heads", "capacities") for b in (shard,
                                                                moved)),
        "histograms": np.array_equal(plain.label_histograms(),
                                     shard.label_histograms()),
        "slots": np.array_equal(plain.sample_slots(slots_rng[0], (2, 3)),
                                shard.sample_slots(slots_rng[1], (2, 3))),
        "foreign_client": _raises(lambda: shard.dataset((hi % 8))),
    }


def _snapshot_case(rank: int, root: Path) -> dict:
    """A 2-rank pod run writing a snapshot every 2 of 4 rounds, and the
    run resumed from round 2 on 2 ranks."""
    kw = dict(rounds=SNAPSHOT_ROUNDS)
    straight = pod_run("osafl", **kw, run_kw=dict(
        save_every_k=2, checkpoint_dir=root))
    from repro_torch.harness import checkpoint_path
    resumed = pod_run("osafl", **kw, run_kw=dict(
        resume_from=checkpoint_path(root, 2)))
    refused = _raises(lambda: pod_run(
        "osafl", engine="recompute", **kw,
        run_kw=dict(resume_from=checkpoint_path(root, 2))))
    return {"straight": straight, "resumed": resumed,
            "other_engine": refused, "dir": str(root)}


def two_ranks(rank: int, payload: dict) -> dict:
    out = {"buffer": _buffer_case(rank), "runs": {}}
    for alg, engine in RUNS:
        out["runs"][f"{alg} {engine}"] = pod_run(alg, engine)
    out["rerun"] = pod_run("osafl")
    out["from_reference"] = pod_run("osafl",
                                    weights=payload["ref_weights"])
    for case, kw in OPTIONS:
        out[case] = pod_run("osafl", **kw)
    out["snapshot"] = _snapshot_case(rank, Path(payload["ckpt"]))
    # a sparse cohort and edge clusters run on two rows; what the rows
    # refuse of them is the reference's divisibility and hier-mesh rules
    out["ran"] = {
        "cohort": pod_run("osafl", cohort_size=8, participation=0.5),
        "clusters": pod_run("osafl", num_clusters=2)}
    out["refused"] = {
        "indivisible": _raises(lambda: pod_run("osafl", num_clients=9)),
        "cohort": _raises(lambda: pod_run("osafl", cohort_size=3,
                                          participation=0.5)),
        "clusters": _raises(lambda: pod_run("osafl", num_clients=6,
                                            num_clusters=3)),
        "v1_snapshots": _raises(lambda: pod_run("osafl", run_kw=dict(
            save_every_k=1, checkpoint_dir=payload["ckpt"] + "-v1",
            checkpoint_async=False))),
    }
    return out


# ---------------------------------------------------------------------------
# four ranks: the stationary engines (the zoo's training steps)
# ---------------------------------------------------------------------------

def zoo_inputs(arch: str):
    """The reduced ``arch``'s weights and an (8, 32) batch, drawn from
    seeds 0 and 1 the same on every rank."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch).reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg)
    batch = make_train_batch(torch.Generator().manual_seed(1), cfg, 8, 32)
    return cfg, params, batch


def flat(tree) -> np.ndarray:
    from repro_torch.core.flatten import tree_get, tree_paths
    return np.concatenate([tree_get(tree, p).float().reshape(-1).numpy()
                           for p in tree_paths(tree)])


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def four_ranks(rank: int, payload: dict) -> dict:
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import pod
    from repro_torch.core.shmap import client_sharding
    mesh = host_mesh()
    fl = FLConfig(**STATIONARY)
    out = {}
    cfg, params, batch = zoo_inputs("qwen1.5-4b")
    mine = {k: client_sharding(mesh, x.dim()).block(x)
            for k, x in batch.items()}
    p, m = pod.make_tp_train_step(cfg, fl, mesh)(params, mine)
    out["exact_tp"] = {"metrics": _metrics(m), "params": flat(p)}
    per = {k: client_sharding(mesh, x.dim() + 1).block(
        x.reshape((4, 2) + tuple(x.shape[1:]))) for k, x in batch.items()}
    p, m = pod.make_recompute_train_step(cfg, fl, mesh, 4)(params, per)
    out["recompute"] = {"metrics": _metrics(m), "params": flat(p)}
    p, lam, m = pod.make_stale_score_train_step(cfg, fl, mesh, 4)(
        params, torch.linspace(0.5, 1.0, 4), per)
    out["stale"] = {"metrics": _metrics(m), "params": flat(p),
                    "lam_next": lam.numpy()}
    p, m = pod.make_fedavg_train_step(cfg, fl, mesh)(params, mine)
    out["fedavg"] = {"metrics": _metrics(m), "params": flat(p)}
    dcfg, dparams, dbatch = zoo_inputs("h2o-danube-3-4b")
    dmine = {k: client_sharding(mesh, x.dim()).block(x)
             for k, x in dbatch.items()}
    dfl = dataclasses.replace(fl, num_clients=1)
    out["danube exact"] = _metrics(pod.make_tp_train_step(
        dcfg, dfl, mesh)(dparams, dmine)[1])
    out["danube sketch"] = _metrics(pod.make_tp_train_step(
        dcfg, dfl, mesh, sketch_dim=SKETCH_DIM)(dparams, dmine)[1])
    out["pod_clients"] = pod.num_pod_clients(mesh)
    return out


JOBS = {"two": two_ranks, "four": four_ranks}
