"""The experiment harness of the port: ``run(alg, xc)`` over the dense
stacked dispatch round or the per-client loop oracle for OSAFL and the five
baselines, and the centralized genie; the port of
``repro/harness/experiments.py``'s ``_run_stacked``, ``_run_loop`` and
``_run_centralized``.

Each stacked round: Binomial arrivals drawn from the per-user request
streams and committed FIFO (``StackedOnlineBuffer``), the batched resource
solve for every client's kappa, whole-cohort masked local SGD
(``make_vmapped_local_train``), the server round (``StackedOSAFLServer``,
whose score reduction is the CUDA kernel on the card, or one of the
baselines' ``STACKED_SERVERS``) and an evaluation of the global model. The
host draws consume one ``np.random.Generator`` in exactly the reference's
order, so with the same seed and weights the two packages see the same
arrivals, kappas and batches. The loop oracle does the same one client at
a time: its arrivals, scalar resource solve and ``local_train``, and a loop
server (``OSAFLServer``, which scores without the kernel, or one of
``SERVERS``). A run holds cuDNN's convolutions in full f32
(``full_f32_convolutions``) and to deterministic algorithms
(``deterministic_convolutions``).
"""
from __future__ import annotations

import logging
import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.configs.base import ExperimentConfig, FLConfig
from repro_torch.core.baselines import make_server
from repro_torch.core.buffer import OnlineBuffer, binomial_arrivals
from repro_torch.core.buffer_stacked import StackedOnlineBuffer
from repro_torch.core.client import local_train, make_vmapped_local_train
from repro_torch.core.flatten import tree_map
from repro_torch.core.osafl import ClientUpdate
from repro_torch.core.resource import (NetworkConfig, make_clients,
                                       optimize_round)
from repro_torch.core.resource_stacked import (optimize_round_batched,
                                               stack_clients)
from repro_torch.data.online import (binomial_arrivals_batched,
                                     dataset_layout, draw_arrival_batch,
                                     pad_arrival_batch)
from repro_torch.data.video_caching import make_population
from repro_torch.device import (deterministic_convolutions,
                                full_f32_convolutions, resolve_device)
from repro_torch.harness.compat import resolve
from repro_torch.models.small import init_small, small_loss

_LOG = logging.getLogger("repro_torch.harness")

MODEL_PARAMS = {"fcn": 3_900_000, "cnn": 1_100_000, "squeezenet": 740_000,
                "lstm": 430_000, "mlp": 18_000}


def _draw(stream, n, dataset):
    return (stream.draw_dataset1(n) if dataset == 1
            else stream.draw_dataset2(n))


def _stacked_setup(alg: str, xc: ExperimentConfig, eval_samples: int,
                   device: torch.device) -> SimpleNamespace:
    """Deterministic run setup: population and request streams, capacities,
    the FIFO buffers' initial fill, the eval set, the server and the client
    system parameters, drawing the host RNG in the reference's order."""
    model, U = xc.model, xc.num_clients
    cat, streams = make_population(xc.seed, U, topk=xc.topk)
    rng = np.random.default_rng(xc.seed)
    feat_shape, dtype = dataset_layout(xc.dataset)
    lo, hi = xc.capacity
    caps = rng.integers(lo, max(hi, lo + 1), size=U)
    fl = FLConfig(num_clients=U, local_lr=xc.local_lr,
                  global_lr=(xc.global_lr if alg in ("osafl", "afa_cd")
                             else 1.0),
                  algorithm=alg, engine="stacked",
                  request_backend=xc.request_backend,
                  round_backend=xc.round_backend,
                  resource_backend=xc.resource_backend,
                  cohort_size=xc.cohort_size,
                  participation=xc.participation,
                  num_clusters=xc.num_clusters, scenario=xc.scenario)
    server = make_server(init_small(xc.seed, model, device), fl, U,
                         device=device)
    sbuf = StackedOnlineBuffer.create(caps, feat_shape, 100,
                                      stage_capacity=xc.arrivals,
                                      dtype=dtype, device=device)
    # initial fill: FIFO commits compose, so ingest the cap_u seed samples
    # in arrival-width chunks through the round's staging area
    init = [_draw(streams[u], int(caps[u]), xc.dataset) for u in range(U)]
    for off in range(0, int(caps.max()), xc.arrivals):
        chunk = [(x[off:off + xc.arrivals], y[off:off + xc.arrivals])
                 if off < len(y) else None for x, y in init]
        sbuf.stage(*pad_arrival_batch(chunk, xc.arrivals, xc.dataset))
        sbuf.commit()
    p_ac = np.array([s.user.p_ac for s in streams])

    per = max(eval_samples // U, 4)
    tests = [_draw(s, per, xc.dataset) for s in streams]
    test_batch = {
        "x": torch.as_tensor(np.concatenate([t[0] for t in tests]),
                             device=device),
        "y": torch.as_tensor(np.concatenate([t[1] for t in tests]),
                             device=device)}

    sysb = stack_clients(make_clients(rng, U,
                                      cell_radius_m=xc.cell_radius_m))
    return SimpleNamespace(
        model=model, U=U, streams=streams, rng=rng, caps=caps, sbuf=sbuf,
        p_ac=p_ac, test_batch=test_batch, fl=fl, server=server,
        codec=server.codec, device=device,
        grad_fn=torch.func.grad(lambda p, b: small_loss(p, b, model)[0]),
        weights_alg=alg in ("fedavg", "fedprox", "feddisco"),
        prox_mu=fl.fedprox_mu if alg == "fedprox" else 0.0,
        net=NetworkConfig(), sysb=sysb,
        n_params=MODEL_PARAMS.get(model, 1_000_000))


def _draw_round_inputs(s: SimpleNamespace, xc: ExperimentConfig) -> tuple:
    """One round of host draws, in the reference's order: arrival counts
    and samples (staged and committed FIFO), the resource solve's kappas,
    the straggler mask and the local-SGD batch slots. Returns
    ``(req_s, kappas, active, slots)``."""
    t0 = time.perf_counter()
    counts = binomial_arrivals_batched(s.rng, xc.arrivals, s.p_ac)
    arrivals = draw_arrival_batch(s.streams, counts, xc.dataset,
                                  width=xc.arrivals)
    req_s = time.perf_counter() - t0
    s.sbuf.stage(*arrivals)
    s.sbuf.commit()
    if xc.use_resource_opt:
        kappas = optimize_round_batched(s.rng, s.net, s.sysb, s.n_params,
                                        backend=xc.resource_backend,
                                        device=s.device).kappa
    else:
        kappas = np.full(s.U, s.fl.kappa_max)
    active = kappas >= 1                    # kappa = 0 => straggler
    slots = s.sbuf.sample_slots(s.rng, (s.fl.kappa_max, xc.batch))
    return req_s, kappas, active, slots


def _server_round(s: SimpleNamespace, alg: str, upd, active, kappas) -> None:
    if alg == "fednova":
        # round_stacked merges sizes/kappas for active clients only, so
        # stragglers keep their last-seen kappa
        s.server.round_stacked(upd, active, sizes=s.sbuf.sizes,
                               kappas=kappas)
    elif alg == "feddisco":
        s.server.round_stacked(upd, active, sizes=s.sbuf.sizes,
                               hists=s.sbuf.label_histograms())
    else:
        s.server.round_stacked(upd, active)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_stacked(alg: str, xc: ExperimentConfig, eval_samples: int,
                 device: torch.device) -> list:
    """The dispatch-round stacked engine; one history row per round."""
    s = _stacked_setup(alg, xc, eval_samples, device)
    local_step = make_vmapped_local_train(s.grad_fn, s.fl.local_lr,
                                          s.fl.kappa_max, prox_mu=s.prox_mu)
    history = []
    for t in range(xc.rounds):
        t_start = time.perf_counter()
        req_s, kappas, active, slots = _draw_round_inputs(s, xc)
        d, w = local_step(s.server.params, s.sbuf.gather(slots),
                          torch.as_tensor(kappas, device=device))
        upd = s.codec.flatten_stacked(w if s.weights_alg else d)
        del d, w
        _server_round(s, alg, upd, active, kappas)
        del upd
        loss, m = small_loss(s.server.params, s.test_batch, s.model)
        _synchronize(device)         # round_s covers all of the round's work
        round_s = time.perf_counter() - t_start
        history.append({"round": t, "test_loss": float(loss),
                        "test_acc": float(m["accuracy"]),
                        "participants": int(active.sum()),
                        "request_gen_s": req_s,
                        "round_s": round_s})
    return history


def _client_setup(xc: ExperimentConfig, eval_samples: int,
                  device: torch.device) -> tuple:
    """The loop oracle's and the genie's setup, in the reference's order of
    host draws: the request streams, each client's capacity and initial
    FIFO fill, and the eval set (each client's own next requests). Returns
    ``(streams, rng, bufs, test_batch)``."""
    _, streams = make_population(xc.seed, xc.num_clients, topk=xc.topk)
    rng = np.random.default_rng(xc.seed)
    feat_shape, dtype = dataset_layout(xc.dataset)
    bufs = []
    for s in streams:
        cap = int(rng.integers(*xc.capacity))
        buf = OnlineBuffer.create(cap, feat_shape, 100, dtype=dtype)
        buf.stage(*_draw(s, cap, xc.dataset))
        buf.commit()
        bufs.append(buf)
    per = max(eval_samples // xc.num_clients, 20)
    tests = [_draw(s, per, xc.dataset) for s in streams]
    test_batch = {
        "x": torch.as_tensor(np.concatenate([t[0] for t in tests]),
                             device=device),
        "y": torch.as_tensor(np.concatenate([t[1] for t in tests]),
                             device=device)}
    return streams, rng, bufs, test_batch


def _arrive(rng, streams, bufs, xc: ExperimentConfig, c: int) -> float:
    """Client ``c``'s Binomial arrivals, staged and committed FIFO. Returns
    the seconds spent drawing them (the round's ``request_gen_s``)."""
    t0 = time.perf_counter()
    n = binomial_arrivals(rng, xc.arrivals, streams[c].user.p_ac)
    arrived = _draw(streams[c], n, xc.dataset) if n else None
    req_s = time.perf_counter() - t0
    if arrived is not None:
        bufs[c].stage(*arrived)
    bufs[c].commit()
    return req_s


def _run_loop(alg: str, xc: ExperimentConfig, eval_samples: int,
              device: torch.device) -> list:
    """The per-client loop oracle (the reference's ``_run_loop`` without its
    checkpoints); one history row per round. Each round solves every
    client's resources, then for each client in turn draws its arrivals and
    runs ``local_train`` unless it is a straggler (kappa < 1), and hands
    the list of ``ClientUpdate``s to the loop server."""
    model, U = xc.model, xc.num_clients
    streams, rng, bufs, test_batch = _client_setup(xc, eval_samples, device)
    grad_fn = torch.func.grad(lambda p, b: small_loss(p, b, model)[0])
    fl = FLConfig(num_clients=U, local_lr=xc.local_lr,
                  global_lr=(xc.global_lr if alg in ("osafl", "afa_cd")
                             else 1.0),
                  algorithm=alg, engine="loop")
    server = make_server(init_small(xc.seed, model, device), fl, U,
                         device=device)
    net = NetworkConfig()
    clients_sys = make_clients(rng, U, cell_radius_m=xc.cell_radius_m)
    n_params = MODEL_PARAMS.get(model, 1_000_000)
    prox_mu = fl.fedprox_mu if alg == "fedprox" else 0.0
    history = []
    for t in range(xc.rounds):
        t_start = time.perf_counter()
        if xc.use_resource_opt:
            decisions = optimize_round(rng, net, clients_sys, n_params)
        req_s, updates = 0.0, []
        for c in range(U):
            req_s += _arrive(rng, streams, bufs, xc, c)
            kappa = (decisions[c].kappa if xc.use_resource_opt
                     else fl.kappa_max)
            if kappa < 1:
                continue                      # straggler
            d, w = local_train(server.params, grad_fn, bufs[c], kappa,
                               fl.local_lr, xc.batch, rng, prox_mu=prox_mu)
            updates.append(ClientUpdate(
                c, d if alg in ("osafl", "fednova", "afa_cd") else w, kappa,
                data_size=bufs[c].size, label_hist=bufs[c].label_histogram()))
        server.round(updates)
        loss, m = small_loss(server.params, test_batch, model)
        _synchronize(device)         # round_s covers all of the round's work
        round_s = time.perf_counter() - t_start
        history.append({"round": t, "test_loss": float(loss),
                        "test_acc": float(m["accuracy"]),
                        "participants": len(updates),
                        "request_gen_s": req_s,
                        "round_s": round_s})
    return history


def _run_centralized(xc: ExperimentConfig, eval_samples: int,
                     device: torch.device) -> list:
    """The genie baseline: every round pools all clients' current FIFO
    datasets and takes 5 SGD steps of batch 4 x ``xc.batch`` on the pool.
    Rows carry ``round``, ``test_loss`` and ``test_acc`` as the reference's
    do, plus the port's ``request_gen_s`` (the arrival draws) and
    ``round_s``."""
    model = xc.model
    streams, rng, bufs, test_batch = _client_setup(xc, eval_samples, device)
    params = init_small(xc.seed, model, device)
    grad_fn = torch.func.grad(lambda p, b: small_loss(p, b, model)[0])
    history = []
    for t in range(xc.rounds):
        t_start = time.perf_counter()
        req_s = sum(_arrive(rng, streams, bufs, xc, c)
                    for c in range(xc.num_clients))
        xs, ys = zip(*[b.dataset() for b in bufs])
        X, Y = np.concatenate(xs), np.concatenate(ys)
        for _ in range(5):                     # kappa=5 epochs-ish steps
            idx = rng.integers(0, len(Y), xc.batch * 4)
            g = grad_fn(params, {"x": torch.as_tensor(X[idx], device=device),
                                 "y": torch.as_tensor(Y[idx], device=device)})
            params = tree_map(lambda w, gg: w - xc.local_lr * gg, params, g)
        loss, m = small_loss(params, test_batch, model)
        _synchronize(device)
        history.append({"round": t, "test_loss": float(loss),
                        "test_acc": float(m["accuracy"]),
                        "request_gen_s": req_s,
                        "round_s": time.perf_counter() - t_start})
    return history


def run(alg: str, xc: ExperimentConfig, *, eval_samples: int = 400,
        device=None, mesh=None, pod_engine: str = None,
        save_every_k: int = None, checkpoint_dir=None, resume_from=None,
        checkpoint_async: bool = True, keep_last: int = None) -> list:
    """Run one FL experiment on ``device`` (``None``: the CUDA device, which
    must exist; ``"cpu"`` runs on the CPU) and return per-round metrics:
    ``round``, ``test_loss``, ``test_acc``, ``participants``,
    ``request_gen_s`` and ``round_s`` (the genie's rows have no
    ``participants``).

    ``alg`` is one of ``ALL_ALGS`` on the stacked engine (``xc.engine``
    ``"stacked"`` or ``"auto"``) or on the per-client loop oracle
    (``xc.engine="loop"``), or ``"centralized"`` (or
    ``xc.engine="centralized"``) for the pooled-data genie. The whole
    configuration is validated up front (``repro_torch.harness.compat``);
    the knobs the port does not run yet — a mesh, checkpoint arguments and
    the configurations that need them — raise ``ExperimentConfigError``."""
    checkpoint = (save_every_k is not None or checkpoint_dir is not None
                  or resume_from is not None or keep_last is not None
                  or not checkpoint_async)
    plan = resolve(alg, xc, mesh=mesh, pod_engine=pod_engine,
                   checkpoint=checkpoint)
    _LOG.info("resolved experiment plan: %s", plan.describe())
    device = resolve_device(device)
    with full_f32_convolutions(), deterministic_convolutions():
        if plan.engine == "centralized":
            return _run_centralized(xc, eval_samples, device)
        if plan.engine == "loop":
            return _run_loop(alg, xc, eval_samples, device)
        return _run_stacked(alg, xc, eval_samples, device)
