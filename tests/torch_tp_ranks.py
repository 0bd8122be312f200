"""What each rank of ``tests/test_torch_tp.py``'s process groups runs: the
port's dense decoders tensor-parallel over a 'model' axis, one process a
(row, column) device, on the CPU under gloo. ``spawn(groups, payload,
out)`` starts as many processes as the groups span and runs them through
each group in turn (``groups``: ``(name, ranks, model_parallel,
harness[, first process])``, each made anew once the one before is
destroyed; a process outside a group goes on to the next, so groups on
disjoint processes run at once); every rank pickles what it computed to
``out``. This
module imports torch and the port only (the ranks never load JAX).
"""
from __future__ import annotations

import pickle
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

FL = dict(kappa_max=1, local_lr=0.1, global_lr=1.0)
SKETCH_DIM = 64
DECODE_STEPS = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(groups, payload: dict, out: Path, meanwhile=None, job=None):
    """Run ``payload``'s cases on each of ``groups`` in turn (and its FL
    harness runs on the groups whose fourth entry is true); returns
    ``{group name: [each rank's results, in rank order]}`` and what
    ``meanwhile()`` returns, called here while the ranks run. ``job(payload,
    M)`` (a module-level function) is what each rank runs, ``run_cases``
    by default."""
    out = Path(out)
    nprocs = max(_first(g) + g[1] for g in groups)
    ports = [free_port() for _ in groups]
    ctx = mp.start_processes(
        _process, args=(groups, ports, payload, str(out), job or run_cases),
        nprocs=nprocs, join=False, start_method="spawn")
    done = meanwhile() if meanwhile is not None else None
    while not ctx.join():
        pass
    results = {}
    for name, n, *_ in groups:
        results[name] = []
        for r in range(n):
            path = out / f"{name}.rank{r}.pkl"
            with open(path, "rb") as f:
                results[name].append(pickle.load(f))
            path.unlink()           # the trees are in memory now
    return results, done


def _first(group) -> int:
    """The first process of a group (0 unless its fifth entry says)."""
    return group[4] if len(group) > 4 else 0


def _process(proc: int, groups, ports, payload: dict, out: str,
             job) -> None:
    torch.set_num_threads(1)
    for group, port in zip(groups, ports):
        name, n, M, harness = group[:4]
        rank = proc - _first(group)
        if not 0 <= rank < n:
            continue
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=n, rank=rank)
        try:
            res = job(payload if harness else dict(payload, harness=()), M)
        finally:
            dist.destroy_process_group()
        with open(Path(out) / f"{name}.rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else t


def _tree_np(tree):
    from repro_torch.core.flatten import tree_map
    return tree_map(_np, tree)


def run_cases(payload: dict, M: int) -> dict:
    """Every case of ``payload["cases"]`` on this rank's mesh (R x M over
    the running group): the forward's logits, the loss and its gradient
    (this rank's shards), one step of exact_tp (exact and sketched) and
    fedavg from the same weights, the greedy prefill token and
    ``DECODE_STEPS`` greedy decode steps after it; then the FL harness
    runs of ``payload["harness"]``. Each row takes its block of the
    batch."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import pod
    from repro_torch.core.shmap import client_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.core.shmap import model_cat, model_sum
    mesh = make_host_mesh(model_parallel=M, device="cpu")
    mine = torch.tensor([float(mesh.rank)])
    out = {"row": mesh.row, "col": mesh.col, "rank": mesh.rank,
           "shape": mesh.shape, "model_sum": float(model_sum(mine, mesh)),
           "model_cat": model_cat(mine, mesh).tolist()}
    for case in payload["cases"]:
        cfg = case["cfg"]
        params = T.params_from_numpy(case["weights"], cfg, device="cpu",
                                     mesh=mesh)
        blk = client_sharding(mesh, 2)
        batch = {k: blk.block(torch.from_numpy(v))
                 for k, v in case["batch"].items()}
        res = {}
        logits, _ = T.forward(params, batch, cfg, mesh)
        res["logits"] = _np(logits)
        loss, grads = pod._loss_and_grad(params, batch, cfg, mesh)
        res["loss"], res["grads"] = _np(loss), _tree_np(grads)
        fl = FLConfig(num_clients=mesh.shape["data"], **FL)
        for name, step in (
                ("exact_tp", pod.make_tp_train_step(cfg, fl, mesh)),
                ("exact_tp_sketch", pod.make_tp_train_step(
                    cfg, fl, mesh, sketch_dim=SKETCH_DIM)),
                ("fedavg", pod.make_fedavg_train_step(cfg, fl, mesh))):
            new, metrics = step(params, batch)
            res[name] = {"params": _tree_np(new),
                         "metrics": {k: float(v) for k, v in
                                     metrics.items()}}
        prompt = batch["tokens"]
        res["prefill"] = _np(pod.make_prefill_step(cfg, mesh)(
            params, {"tokens": prompt}))
        B, S = prompt.shape
        cache = T.init_cache(cfg, B, S + DECODE_STEPS, device="cpu",
                             dtype=torch.float32, mesh=mesh)
        serve = pod.make_serve_step(cfg, mesh)
        tokens = []
        for pos in range(S + DECODE_STEPS - 1):
            tok = prompt[:, pos:pos + 1] if pos < S else tok
            tok, cache = serve(params, cache, tok, pos)
            if pos >= S - 1:
                tokens.append(_np(tok))
        res["decode"] = np.concatenate(tokens, axis=1)
        res["cache_heads"] = int(cache["dense"]["k"].shape[-2])
        out[case["name"]] = res
    out["harness"], out["scored_calls"] = {}, {}
    for name, alg, engine, kw in payload.get("harness", ()):
        out["harness"][name], out["scored_calls"][name] = _harness(
            alg, engine, kw, mesh)
    out["refusals"] = _refusals(mesh) if M > 1 else {}
    return out


def _harness(alg: str, engine: str, kw: dict, mesh) -> tuple:
    """One FL harness run on the mesh and the calls of ``scored_reduce``
    its server rounds made (its plain version, on the CPU)."""
    from repro_torch.core import osafl
    from repro_torch.harness import ExperimentConfig, run
    calls = []
    kernel = osafl.scored_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)
    osafl.scored_reduce = counted
    try:
        hist = run(alg, ExperimentConfig(**kw), eval_samples=64, mesh=mesh,
                   pod_engine=engine, device="cpu")
    finally:
        osafl.scored_reduce = kernel
    return hist, len(calls)


def _refusals(mesh) -> dict:
    """What the 'model' axis refuses, by the message it raises with."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import pod
    from repro_torch.models import transformer as T
    cfg = get_config("qwen1.5-4b").reduced()
    fl = FLConfig(num_clients=mesh.shape["data"], **FL)
    ssm = get_config("zamba2-2.7b").reduced()
    out = {}
    for what, call in (
            ("recompute", lambda: pod.make_recompute_train_step(
                cfg, fl, mesh, mesh.shape["data"])),
            ("stale", lambda: pod.make_stale_score_train_step(
                cfg, fl, mesh, mesh.shape["data"])),
            ("ssm stale", lambda: pod.make_stale_score_train_step(
                ssm, fl, mesh, mesh.shape["data"]))):
        try:
            call()
            out[what] = "ran"
        except NotImplementedError as e:
            out[what] = str(e)
    return out


def online_job(rank: int, payload: dict) -> dict:
    """``launch/dryrun.run_online`` on this rank of the running group (a
    ('pod', 'data') mesh of every rank), its records."""
    from repro_torch.launch.dryrun import run_online
    torch.set_num_threads(1)
    return run_online(device="cpu", **payload)
