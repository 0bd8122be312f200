"""The experiment harness of the port: ``run(alg, xc)`` over the dense
stacked dispatch round, the pod engine or the per-client loop oracle for
OSAFL and the five baselines, and the centralized genie; the port of
``repro/harness/experiments.py``'s ``_run_stacked``, ``_run_pod``,
``_run_loop`` and ``_run_centralized`` with their RunState checkpoints,
and of its four deprecated ``run_*`` shims.

Each stacked round: Binomial arrivals whose samples come from the per-user
request streams (``request_backend="python"``) or the batched Gumbel-max
sampler on the run's device (``"stacked"``), committed FIFO
(``StackedOnlineBuffer``), the batched resource solve for every client's
kappa (float64, or the log-domain float32 backend), whole-cohort masked
local SGD (``make_vmapped_local_train``), the server round
(``StackedOSAFLServer``, whose score reduction is the CUDA kernel on the
card, or one of the baselines' ``STACKED_SERVERS``) and an evaluation of
the global model. The host draws consume one ``np.random.Generator`` in
exactly the reference's order, so with the same seed and weights the two
packages see the same arrivals, kappas and batches (and, with the python
streams, the same samples). The loop oracle does the same one client at a
time: its arrivals, scalar resource solve and ``local_train``, and a loop
server (``OSAFLServer``, which scores without the kernel, or one of
``SERVERS``). A run holds cuDNN's convolutions in full f32
(``full_f32_convolutions``) and to deterministic algorithms
(``deterministic_convolutions``).

The pod engine (``engine="pod"``, or a mesh under ``"auto"``) runs the
stacked round with the local SGD of ``core/pod.py``'s online steps, which
gather each client's minibatches from its own storage row: ``exact_tp``,
``stale`` and ``fedavg`` vmapped over the clients, ``recompute`` one
client at a time; ``stale`` weights round t with round t-1's scores
(``FLConfig.stale_scores``). Its mesh (``launch/mesh.make_host_mesh``)
holds one client row per rank of the ``torch.distributed`` process group,
one row with none, where it matches the stacked engine metric for metric.
Over R > 1 rows every rank draws the host RNG for all U clients, as one
process does, and keeps its U/R rows of the FIFO buffer and of the
server's contribution buffer; the server round's sums run across the
ranks in rank order, every rank holds the same weights, evaluates them
and returns the same history (``round_s`` the slowest rank's). Its
snapshots are tagged ``"pod"`` and record the engine flavour and the
mesh's axes and shape; over R rows each rank writes its rows as shard
files of one v2 snapshot, and a resume on R ranks reads each rank's.

The stacked and pod engines also run the sparse cohort (``cohort_size``,
``participation``: only C slots of round state exist, a sample of the
registered users is seated each round, ``core/cohort.py``), the edge
cluster tier (``num_clusters``, ``core/hierarchy.py``), the scenario layer
(``scenario``, ``repro_torch/scenarios/``) as the reference does, and
sketched scores (``score_sketch_dim``), which the reference's harness does
not pass on to its servers. Over R > 1 rows each rank holds C/R slots of
the FIFO buffer and of the inner server (K/R whole cluster blocks) and
U/R users of the per-user tables, while the slot pool, the cluster map
and every draw stay whole and alike on every rank; an admission or a
cluster move resets the newly seated slots of each rank's own block.

Checkpoints (``save_every_k`` + ``checkpoint_dir``, ``resume_from``,
``keep_last``, ``checkpoint_async``) write the reference's RunState
snapshots, key for key: the stacked engine through the async v2 writer by
default, the loop engine through the blocking v1 writer. A snapshot from
either package resumes in the other, but for the reference's stacked
request stream, whose threefry lineage the port cannot continue.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.checkpoint import CheckpointError
from repro_torch.configs.base import ExperimentConfig, FLConfig
from repro_torch.core.baselines import make_server
from repro_torch.core.buffer import OnlineBuffer, binomial_arrivals
from repro_torch.core.buffer_stacked import StackedOnlineBuffer
from repro_torch.core.client import local_train, make_vmapped_local_train
from repro_torch.core.cohort import sample_participants
from repro_torch.core.flatten import tree_map
from repro_torch.core.hierarchy import sample_participants_clustered
from repro_torch.core.osafl import ClientUpdate
from repro_torch.core.pod import (make_fedavg_train_step, make_pod_batch_fn,
                                  make_recompute_train_step,
                                  make_stale_score_train_step,
                                  make_tp_train_step)
from repro_torch.core.resource import (NetworkConfig, make_clients,
                                       optimize_round)
from repro_torch.core.resource_stacked import (optimize_round_batched,
                                               stack_clients)
from repro_torch.core.shmap import (check_ranks, client_rows,
                                    client_sharding, grouped, row_max)
from repro_torch.core.round_fused import FusedEngine
from repro_torch.data.online import (binomial_arrivals_batched,
                                     dataset_layout, draw_arrival_batch,
                                     load_streams_state, pad_arrival_batch,
                                     streams_state_dict)
from repro_torch.data.video_caching import make_population
from repro_torch.data.video_caching_stacked import StackedRequestStream
from repro_torch.device import (deterministic_convolutions,
                                full_f32_convolutions, resolve_device)
from repro_torch.harness.compat import ExperimentConfigError, resolve
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models.small import init_small, small_loss
from repro_torch.scenarios import parse_scenario

_LOG = logging.getLogger("repro_torch.harness")

MODEL_PARAMS = {"fcn": 3_900_000, "cnn": 1_100_000, "squeezenet": 740_000,
                "lstm": 430_000, "mlp": 18_000}


# ---------------------------------------------------------------------------
# checkpoint/resume plumbing (RunState snapshots)
# ---------------------------------------------------------------------------

def checkpoint_path(checkpoint_dir, t: int) -> Path:
    """Canonical snapshot location for the state after round t (a snapshot
    named round_00003 holds the state with rounds 0-2 done)."""
    return Path(checkpoint_dir) / f"round_{t:05d}"


def _validate_ckpt_args(save_every_k, checkpoint_dir,
                        keep_last=None) -> None:
    if bool(save_every_k) != (checkpoint_dir is not None):
        raise ValueError(
            "save_every_k and checkpoint_dir must be passed together "
            f"(got save_every_k={save_every_k!r}, "
            f"checkpoint_dir={checkpoint_dir!r})")
    if keep_last is not None:
        if not save_every_k:
            raise ValueError(
                "keep_last requires save_every_k/checkpoint_dir (there is "
                "nothing to prune without periodic snapshots)")
        if not isinstance(keep_last, int) or keep_last < 1:
            raise ValueError(
                f"keep_last must be a positive int, got {keep_last!r}")


def _make_ckpt_writer(save_every_k, checkpoint_async: bool, keep_last,
                      mesh=None, device=None):
    """The run's checkpoint writer, or None when checkpointing is off: the
    async v2 writer (``submit`` copies the state to the host, a thread
    writes it; ``close()`` at exit is the drain barrier), over the client
    rows of ``mesh`` one shard file per rank, or the blocking v1 writer
    (one process's whole arrays)."""
    if not save_every_k:
        return None
    if checkpoint_async:
        return checkpoint.AsyncCheckpointWriter(keep_last=keep_last,
                                                mesh=mesh, device=device)
    if mesh is not None and client_rows(mesh) > 1:
        raise ValueError(
            "checkpoint_async=False writes v1 snapshots, one file of whole "
            f"arrays; a run over {client_rows(mesh)} client rows writes "
            "v2 snapshots, one shard file per rank (checkpoint_async=True)")
    return checkpoint.BlockingCheckpointWriter(keep_last=keep_last)


def _run_shape(xc: ExperimentConfig, eval_samples: int) -> dict:
    """Everything that must match between the saving and the resuming run
    for the trajectory to continue bit for bit: the whole ExperimentConfig
    but ``rounds`` (resuming into a longer run is the point) and the
    engine-selection fields ``engine``/``pod_engine`` (the snapshot's
    top-level ``engine`` tag is compared instead), plus the eval set size.
    JSON-normalized so it compares against a loaded snapshot. The port's
    own ``score_sketch_dim`` is left out at 0, so that an exact run's
    snapshot is the reference's, field for field."""
    cfg = dataclasses.asdict(xc)
    if not cfg["score_sketch_dim"]:
        cfg.pop("score_sketch_dim")
    cfg.pop("rounds")
    cfg.pop("engine")
    cfg.pop("pod_engine")
    cfg["capacity"] = list(cfg["capacity"])
    cfg["eval_samples"] = int(eval_samples)
    return cfg


def _check_snapshot(snap: dict, engine: str, alg: str, xc: ExperimentConfig,
                    eval_samples: int, extra: dict = None) -> None:
    """A snapshot resumes only into the run shape it came from. Config
    fields absent from a snapshot are compared as their defaults (the run
    that wrote it behaved like them). ``extra`` holds shape keys outside
    ExperimentConfig, compared with no default-filling."""
    got = dict(snap.get("config") or {}, engine=snap.get("engine"),
               alg=snap.get("alg"))
    want = dict(_run_shape(xc, eval_samples), engine=engine, alg=alg,
                **(extra or {}))
    base = dataclasses.asdict(ExperimentConfig())
    for k in want:                  # _run_shape owns which fields compare
        if k not in got and k in base:
            got[k] = (list(base[k]) if isinstance(base[k], tuple)
                      else base[k])
    bad = sorted(k for k in set(got) | set(want)
                 if got.get(k) != want.get(k))
    if bad:
        raise CheckpointError(
            "cannot resume: snapshot and run disagree on "
            + ", ".join(f"{k} ({got.get(k)!r} vs {want.get(k)!r})"
                        for k in bad))
    if int(snap["next_round"]) > xc.rounds:
        raise CheckpointError(
            f"snapshot already holds {snap['next_round']} rounds, the run "
            f"asks for {xc.rounds}")


def resume_smoke_config(rounds: int, num_clients: int = 8
                        ) -> ExperimentConfig:
    """The small online run of the resume-determinism checks (the
    reference's shape)."""
    return ExperimentConfig(model="mlp", dataset=2, num_clients=num_clients,
                            rounds=rounds, capacity=(12, 24), arrivals=4,
                            batch=8, seed=5)


def _draw(stream, n, dataset):
    return (stream.draw_dataset1(n) if dataset == 1
            else stream.draw_dataset2(n))


def _stacked_setup(alg: str, xc: ExperimentConfig, eval_samples: int,
                   device: torch.device, stale_scores: bool = False,
                   mesh=None) -> SimpleNamespace:
    """Deterministic run setup of the stacked and pod engines: the scenario
    (bound to the population), population and request streams,
    capacities, the server (with the sparse cohort's initial residents
    seated), the FIFO buffers' initial fill (residents only), the eval set
    and the client system parameters, drawing the host RNG in the
    reference's order. ``stale_scores`` (the pod stale engine's one-round
    score lag) goes to the server's ``FLConfig`` and touches no RNG.
    ``mesh`` lays the FIFO buffer, the server's contribution buffer and,
    on the sparse path, the per-user tables over its client rows (this
    rank's rows of each); every draw, the initial fill's too, stays the
    whole cohort's, so it changes none."""
    stacked_req = xc.request_backend == "stacked"
    model, U = xc.model, xc.num_clients
    sparse = xc.cohort_size > 0
    C = xc.cohort_size if sparse else U
    K = int(xc.num_clusters)
    # the scenario's hooks fire only where a perturbation applies, so ""
    # and "null" keep the run's own path
    scn = parse_scenario(xc.scenario, seed=xc.seed)
    if scn is not None:
        scn.bind(U)
    arr_width = scn.arrival_width(xc.arrivals) if scn else xc.arrivals
    cat, streams = make_population(xc.seed, U, topk=xc.topk)
    rstream = (StackedRequestStream.from_streams(cat, streams, seed=xc.seed,
                                                 device=device)
               if stacked_req else None)
    rng = np.random.default_rng(xc.seed)
    feat_shape, dtype = dataset_layout(xc.dataset)
    lo, hi = xc.capacity
    caps = rng.integers(lo, max(hi, lo + 1), size=U)
    if scn is not None:
        caps = scn.setup_capacities(caps)
    fl = FLConfig(num_clients=U, local_lr=xc.local_lr,
                  global_lr=(xc.global_lr if alg in ("osafl", "afa_cd")
                             else 1.0),
                  algorithm=alg, engine="stacked",
                  request_backend=xc.request_backend,
                  round_backend=xc.round_backend,
                  resource_backend=xc.resource_backend,
                  cohort_size=xc.cohort_size,
                  participation=xc.participation,
                  num_clusters=K, scenario=xc.scenario,
                  score_sketch_dim=xc.score_sketch_dim,
                  stale_scores=stale_scores)
    server = make_server(init_small(xc.seed, model, device), fl, U,
                         seed=xc.seed, device=device, mesh=mesh)
    if sparse:
        # the first C users (under the hierarchy the first C/K members of
        # each cluster), arange(C) at K <= 1: the parity anchors
        server.admit(server.initial_residents())
    cohort0 = server.cohort if sparse else np.arange(U)
    sbuf = StackedOnlineBuffer.create(
        caps[cohort0] if sparse else caps, feat_shape, 100,
        stage_capacity=arr_width, dtype=dtype, device=device,
        # slot storage must fit any later-admitted resident's capacity
        depth=int(caps.max()) if sparse else None, mesh=mesh)
    # initial fill (residents only): FIFO commits compose, so ingest the
    # cap_u seed samples in arrival-width chunks through the staging area
    if stacked_req:
        filled = np.zeros(U, np.int64)
        target = np.zeros(U, np.int64)
        target[cohort0] = caps[cohort0]
        rows = torch.as_tensor(cohort0, device=device)
        while (filled < target).any():
            chunk = np.minimum(target - filled, xc.arrivals)
            xs, ys, cnt = rstream.draw(chunk, xc.dataset, xc.arrivals)
            if sparse:
                xs, ys, cnt = xs[rows], ys[rows], cnt[cohort0]
            sbuf.stage(xs, ys, cnt)
            sbuf.commit()
            filled += chunk
    else:
        init = [_draw(streams[u], int(caps[u]), xc.dataset)
                for u in cohort0]
        for off in range(0, int(caps[cohort0].max()), xc.arrivals):
            chunk = [(x[off:off + xc.arrivals], y[off:off + xc.arrivals])
                     if off < len(y) else None for x, y in init]
            sbuf.stage(*pad_arrival_batch(chunk, xc.arrivals, xc.dataset))
            sbuf.commit()
    p_ac = np.array([s.user.p_ac for s in streams])

    per = max(eval_samples // U, 4)
    if stacked_req:
        ex, ey, _ = rstream.draw(np.full(U, per), xc.dataset, per)
        test_batch = {"x": ex.reshape((U * per,) + tuple(ex.shape[2:])),
                      "y": ey.reshape(U * per)}
    else:
        tests = [_draw(s, per, xc.dataset) for s in streams]
        test_batch = {
            "x": torch.as_tensor(np.concatenate([t[0] for t in tests]),
                                 device=device),
            "y": torch.as_tensor(np.concatenate([t[1] for t in tests]),
                                 device=device)}

    sysb = stack_clients(make_clients(rng, U,
                                      cell_radius_m=xc.cell_radius_m))
    if scn is not None:
        sysb = scn.setup_system(sysb)
    return SimpleNamespace(
        stacked_req=stacked_req, model=model, U=U, streams=streams,
        rstream=rstream, rng=rng, caps=caps, sbuf=sbuf, p_ac=p_ac,
        test_batch=test_batch, fl=fl, server=server,
        codec=server.codec, device=device, scn=scn, arr_width=arr_width,
        grad_fn=torch.func.grad(lambda p, b: small_loss(p, b, model)[0]),
        weights_alg=alg in ("fedavg", "fedprox", "feddisco"),
        prox_mu=fl.fedprox_mu if alg == "fedprox" else 0.0,
        net=NetworkConfig(), sysb=sysb,
        n_params=MODEL_PARAMS.get(model, 1_000_000),
        # the sparse cohort's bookkeeping (dense: C = U, no sample);
        # m_active is the flat participation target, of which the
        # clustered sampler seats at most m + K - 1
        sparse=sparse, C=C, K=K,
        m_active=max(1, int(round(xc.participation * C))),
        resample=sparse and (C < U or xc.participation < 1.0))


def _resume_stacked(s: SimpleNamespace, snap: dict) -> tuple:
    """Overwrite the deterministic setup's mutable state from a RunState
    snapshot (already ``_check_snapshot``-ed); returns the history and the
    next round."""
    checkpoint.set_generator_state(s.rng, snap["rng"])
    s.server.load_state_dict(snap["server"])
    s.sbuf.load_state_dict(snap["buffer"])
    if s.stacked_req:
        s.rstream.load_state_dict(snap["streams"])
    else:
        load_streams_state(s.streams, snap["streams"])
    return list(snap["history"]), int(snap["next_round"])


def _gather_sys(sysb, rows):
    """The cohort's rows of a ``ClientSystemBatch`` (every field is
    (U,))."""
    return dataclasses.replace(
        sysb, **{f.name: getattr(sysb, f.name)[rows]
                 for f in dataclasses.fields(sysb)})


def _admitted(s: SimpleNamespace, users, res) -> None:
    """Reset the dataset rows of the slots an admission newly seated to
    the incoming users' capacities (the evicted residents' data is lost);
    over client rows each rank resets the slots of its own block."""
    if res is not None and res.newly.any():
        s.sbuf.reset_rows(res.slots[res.newly],
                          s.caps[np.asarray(users)[res.newly]])


def _draw_round_inputs(s: SimpleNamespace, xc: ExperimentConfig,
                       t: int) -> tuple:
    """One round of host draws, in the reference's order: (sparse only)
    the scenario's cluster moves, the round-active sample and the slot
    admissions; the arrival counts and samples (staged and committed
    FIFO), the resource solve's kappas, the straggler mask and the
    local-SGD batch slots. Returns ``(req_s, kappas, active, slots)``, all
    slot-indexed (width C; dense runs are the C = U identity); ``req_s``
    covers the draws of the admissions and the samples, synchronized when
    the stacked sampler runs on the card. The scenario perturbs the
    cluster map, the sample (availability, selection weights), the
    arrival process, the resource rows and the active mask, each from its
    own seeded streams; a hook that does not fire leaves its input as it
    was, so ``"null"`` draws the host RNG as a run without a scenario."""
    t0 = time.perf_counter()
    scn = s.scn
    if s.sparse and s.K >= 1 and scn is not None and scn.moves_clusters:
        # membership moves first: the sample and the admissions see the
        # round-t cluster map
        mv = scn.round_cluster_moves(t, s.U, s.K)
        if mv is not None:
            _admitted(s, *s.server.apply_cluster_moves(*mv))
    avail = scn.round_available(t, s.U) if scn is not None else None
    sel = None
    if s.sparse:
        if s.resample:
            weights = (scn.round_selection_weights(t, s.U)
                       if scn is not None else None)
            if s.K >= 1:
                sel = sample_participants_clustered(
                    s.rng, s.server.assign, s.K, s.m_active, s.C // s.K,
                    weights=weights, available=avail)
            else:
                sel = sample_participants(s.rng, s.U, s.m_active,
                                          weights=weights, available=avail)
            _admitted(s, sel, s.server.admit(sel))
        cohort = s.server.cohort
        p_ac = s.p_ac[cohort]
    else:
        cohort, p_ac = None, s.p_ac
    e_u = xc.arrivals
    if scn is not None:
        e_u, p_ac = scn.round_arrivals(t, e_u, p_ac)
    if avail is not None:
        # departed users generate no arrivals this round
        p_ac = p_ac * (avail[cohort] if s.sparse else avail)
    counts = binomial_arrivals_batched(s.rng, e_u, p_ac)
    if s.stacked_req:
        if s.sparse:
            # the stream's state stays (U,)-wide; non-residents draw a
            # zero count, so their streams do not advance
            full = np.zeros(s.U, counts.dtype)
            full[cohort] = counts
            xs, ys, cnt = s.rstream.draw(full, xc.dataset, s.arr_width)
            rows = torch.as_tensor(cohort, device=s.device)
            arrivals = (xs[rows], ys[rows], cnt[cohort])
        else:
            arrivals = s.rstream.draw(counts, xc.dataset, s.arr_width)
        _synchronize(s.device)
    else:
        streams = ([s.streams[u] for u in cohort] if s.sparse
                   else s.streams)
        arrivals = draw_arrival_batch(streams, counts, xc.dataset,
                                      width=s.arr_width)
    req_s = time.perf_counter() - t0
    s.sbuf.stage(*arrivals)
    s.sbuf.commit()
    if xc.use_resource_opt:
        sysb = s.sysb
        if scn is not None:
            sysb = scn.round_system(t, sysb)
        if s.sparse:
            sysb = _gather_sys(sysb, cohort)
        kappas = optimize_round_batched(s.rng, s.net, sysb, s.n_params,
                                        backend=xc.resource_backend,
                                        device=s.device).kappa
    else:
        kappas = np.full(s.C, s.fl.kappa_max)
    active = kappas >= 1                    # kappa = 0 => straggler
    if avail is not None:
        # departed users do not report an update either
        active = active & (avail[cohort] if s.sparse else avail)
    if sel is not None:
        # only the sampled users train; carried residents idle, and a
        # freshly seated slot with no arrivals has nothing to train on
        sel_mask = np.zeros(s.C, bool)
        sel_mask[s.server.pool.user_slot[sel]] = True
        active = active & sel_mask & (s.sbuf.sizes > 0)
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


def _round_times(mesh, device, req_s: float, round_s: float) -> tuple:
    """``(request_gen_s, round_s)`` every rank reports: the slowest rank's
    (the gather is the round's closing barrier); a run without a process
    group reports its own."""
    if mesh is None or not grouped():
        return req_s, round_s
    both = row_max(torch.tensor([req_s, round_s], dtype=torch.float64,
                                device=device), mesh)
    return tuple(float(x) for x in both.cpu())


def _run_rounds(alg: str, xc: ExperimentConfig, eval_samples: int,
                device: torch.device, s: SimpleNamespace, local_sgd,
                engine: str, shape: dict, save_every_k, checkpoint_dir,
                resume_from, checkpoint_async: bool, keep_last,
                mesh=None) -> list:
    """The dispatch round of the stacked and pod engines over the setup
    ``s``; ``local_sgd(slots, kappas) -> (d, w)`` is the engine's local
    SGD. One history row per round, and a snapshot tagged ``engine`` after
    every ``save_every_k``-th round. ``shape`` holds the engine's run-shape
    keys outside ``ExperimentConfig`` (the pod engine's flavour and mesh):
    they go into the snapshot's config, its metadata takes the flavour,
    and a resume compares them. Over the client rows of ``mesh`` each rank
    writes and resumes its rows, and each round's times are the slowest
    rank's."""
    writer = _make_ckpt_writer(save_every_k, checkpoint_async, keep_last,
                               mesh, device)
    many = mesh is not None and client_rows(mesh) > 1
    history, start_round = [], 0
    if resume_from is not None:
        # over rows each rank reads its own rows of the sharded leaves, of
        # each leaf's width (U users, C slots)
        rows = {"block": client_sharding(mesh)} if many else {}
        snap = checkpoint.load_run_state(resume_from, **rows)
        _check_snapshot(snap, engine, alg, xc, eval_samples, extra=shape)
        history, start_round = _resume_stacked(s, snap)
        del snap
    meta = {"pod_engine": shape["pod_engine"]} if shape else {}
    try:
        for t in range(start_round, xc.rounds):
            t_start = time.perf_counter()
            req_s, kappas, active, slots = _draw_round_inputs(s, xc, t)
            d, w = local_sgd(slots, torch.as_tensor(kappas, device=device))
            upd = s.codec.flatten_stacked(w if s.weights_alg else d)
            del d, w
            _server_round(s, alg, upd, active, kappas)
            del upd
            loss, m = small_loss(s.server.params, s.test_batch, s.model)
            _synchronize(device)     # round_s covers all of the round's work
            req_s, round_s = _round_times(mesh, device, req_s,
                                          time.perf_counter() - t_start)
            history.append({"round": t, "test_loss": float(loss),
                            "test_acc": float(m["accuracy"]),
                            "participants": int(active.sum()),
                            "request_gen_s": req_s,
                            "round_s": round_s})
            if save_every_k and (t + 1) % save_every_k == 0:
                writer.submit(
                    checkpoint_path(checkpoint_dir, t + 1),
                    {"engine": engine, "alg": alg,
                     "config": dict(_run_shape(xc, eval_samples), **shape),
                     "next_round": t + 1,
                     "rng": checkpoint.generator_state(s.rng),
                     "server": s.server.state_dict(),
                     "buffer": s.sbuf.state_dict(),
                     "streams": (s.rstream.state_dict() if s.stacked_req
                                 else streams_state_dict(s.streams)),
                     "history": history},
                    metadata={"engine": engine, "alg": alg, "round": t + 1,
                              **meta})
        if writer is not None:
            writer.close()          # drain barrier: all snapshots committed
            if many:                # ... by rank 0, for every rank
                row_max(torch.zeros(1, device=device), mesh)
    finally:
        if writer is not None:
            writer.shutdown()
    return history


def _run_stacked(alg: str, xc: ExperimentConfig, eval_samples: int,
                 device: torch.device, save_every_k=None, checkpoint_dir=None,
                 resume_from=None, checkpoint_async: bool = True,
                 keep_last=None) -> list:
    """The dispatch-round stacked engine: the whole cohort's local SGD
    under one ``torch.func.vmap`` on the gathered batches."""
    s = _stacked_setup(alg, xc, eval_samples, device)
    local_step = make_vmapped_local_train(s.grad_fn, s.fl.local_lr,
                                          s.fl.kappa_max, prox_mu=s.prox_mu)

    def local_sgd(slots, kappas):
        return local_step(s.server.params, s.sbuf.gather(slots), kappas)
    return _run_rounds(alg, xc, eval_samples, device, s, local_sgd,
                       "stacked", {}, save_every_k, checkpoint_dir,
                       resume_from, checkpoint_async, keep_last)


def _make_pod_step(pod_engine: str, s: SimpleNamespace, mesh):
    """The online pod local-train step of one engine flavour; all four
    sample their minibatches from the buffer's storage rows through
    ``make_pod_batch_fn`` (``core/pod.py`` online mode)."""
    kw = dict(batch_fn=make_pod_batch_fn(), grad_fn=s.grad_fn,
              prox_mu=s.prox_mu)
    if pod_engine == "exact_tp":
        return make_tp_train_step(None, s.fl, mesh, **kw)
    if pod_engine == "recompute":
        return make_recompute_train_step(None, s.fl, mesh, s.U, **kw)
    if pod_engine == "stale":
        return make_stale_score_train_step(None, s.fl, mesh, s.U, **kw)
    if pod_engine == "fedavg":
        return make_fedavg_train_step(None, s.fl, mesh, **kw)
    raise ValueError(pod_engine)   # run() validates the flavour up front


def _run_pod(alg: str, xc: ExperimentConfig, pod_engine: str,
             eval_samples: int, mesh, device: torch.device,
             save_every_k=None, checkpoint_dir=None, resume_from=None,
             checkpoint_async: bool = True, keep_last=None) -> list:
    """The pod engine: the stacked round (FIFO arrivals, the batched
    resource solve, straggler masking, the stacked server) with each
    client's minibatches gathered from its own storage row inside the
    ``pod_engine`` flavour's online step. ``mesh=None`` is
    ``make_host_mesh()`` on ``device``. ``xc.num_clients``, and
    ``xc.cohort_size`` and ``xc.num_clusters`` (K > 1) where set, must be
    multiples of the mesh's client rows, as in the reference. A mesh of R
    > 1 rows runs as R ranks of the process group, each on its rows of
    the buffers, slots and kappas."""
    if mesh is None:
        mesh = make_host_mesh(device=device)
    rows = client_rows(mesh)
    check_ranks(mesh)
    if xc.num_clients % rows:
        raise ValueError(
            f"num_clients {xc.num_clients} is not divisible by the mesh's "
            f"{rows} client rows {mesh.shape}")
    if xc.cohort_size and xc.cohort_size % rows:
        raise ValueError(
            f"cohort_size {xc.cohort_size} is not divisible by the mesh's "
            f"{rows} client rows (the slot-indexed buffer shards over the "
            "client axes; each shard must own whole slots)")
    if xc.num_clusters > 1 and xc.num_clusters % rows:
        raise ExperimentConfigError(
            "hier-mesh",
            f"num_clusters {xc.num_clusters} is not a multiple of the "
            f"mesh's {rows} client rows: with K>1 each mesh shard must own "
            "whole cluster slot blocks (K=1 spans shards exactly like the "
            "flat buffer and is exempt)")
    s = _stacked_setup(alg, xc, eval_samples, device,
                       stale_scores=pod_engine == "stale", mesh=mesh)
    pod_step = _make_pod_step(pod_engine, s, mesh)

    def local_sgd(slots, kappas):
        # every rank drew every client's slots and kappas; it trains its own
        slots = torch.as_tensor(slots, device=device)
        return pod_step(s.server.params, s.sbuf.state.x, s.sbuf.state.y,
                        client_sharding(mesh, slots.dim()).block(slots),
                        client_sharding(mesh).block(kappas))
    shape = {"pod_engine": pod_engine,
             "mesh_axes": list(mesh.axis_names),
             "mesh_shape": [int(mesh.shape[a]) for a in mesh.axis_names]}
    return _run_rounds(alg, xc, eval_samples, device, s, local_sgd, "pod",
                       shape, save_every_k, checkpoint_dir, resume_from,
                       checkpoint_async, keep_last, mesh)


def build_fused_engine(alg: str, xc: ExperimentConfig,
                       eval_samples: int = 400, device=None) -> tuple:
    """The deterministic setup and a ``core/round_fused.FusedEngine`` over
    it: ``(engine, s)``, ``s`` the ``_stacked_setup`` namespace whose
    server, buffer and stream the engine's carries are made from and
    written back to. Validates the fused shape of the compatibility matrix
    first, whatever ``xc.round_backend`` says: calling this is choosing
    the fused round. ``device=None`` is the CUDA device."""
    resolve(alg, dataclasses.replace(xc, engine="stacked",
                                     round_backend="fused"))
    device = resolve_device(device)
    s = _stacked_setup(alg, xc, eval_samples, device)
    engine = FusedEngine(
        fl=s.fl, codec=s.codec, model=s.model, consts=s.rstream.consts,
        topk=s.rstream.topk, dataset=xc.dataset, arrivals=xc.arrivals,
        batch=xc.batch, p_ac=s.p_ac, sysb=s.sysb, net=s.net,
        n_params=s.n_params, test_batch=s.test_batch, alphas=s.server.alphas,
        sketch_key=s.server._sketch_key, seed=xc.seed,
        use_resource_opt=xc.use_resource_opt,
        resource_backend=xc.resource_backend, device=device)
    return engine, s


def _run_fused(alg: str, xc: ExperimentConfig, eval_samples: int,
               device: torch.device, save_every_k=None, checkpoint_dir=None,
               resume_from=None, checkpoint_async: bool = True,
               keep_last=None) -> list:
    """The ``round_backend="fused"`` body of the stacked engine: the same
    trajectory state and RunState snapshots, but rounds run in segments of
    up to ``xc.rounds_per_dispatch``, cut at checkpoint boundaries (the
    draws are keyed on the absolute round, so the cut does not show in the
    trajectory). History rows are the dispatch round's; there are no
    per-round host draws, so ``request_gen_s`` is 0, and ``round_s`` is the
    synchronized segment's wall clock divided by its length."""
    engine, s = build_fused_engine(alg, xc, eval_samples, device)
    writer = _make_ckpt_writer(save_every_k, checkpoint_async, keep_last)
    history, start_round = [], 0
    if resume_from is not None:
        snap = checkpoint.load_run_state(resume_from)
        _check_snapshot(snap, "stacked", alg, xc, eval_samples)
        history, start_round = _resume_stacked(s, snap)
        del snap
    carry = engine.init_carry(s.server, s.sbuf, s.rstream, start_round)
    t, outs = start_round, None
    try:
        while t < xc.rounds:
            seg = min(xc.rounds_per_dispatch, xc.rounds - t)
            if save_every_k:
                boundary = (t // save_every_k + 1) * save_every_k
                seg = min(seg, boundary - t)
            t_start = time.perf_counter()
            carry, outs = engine.run_segment(carry, seg)
            _synchronize(device)
            seg_s = time.perf_counter() - t_start
            engine.check_outputs(outs)
            for i in range(seg):
                history.append({"round": t + i,
                                "test_loss": float(outs["test_loss"][i]),
                                "test_acc": float(outs["test_acc"][i]),
                                "participants": int(outs["participants"][i]),
                                "request_gen_s": 0.0,
                                "round_s": seg_s / seg})
            t += seg
            if save_every_k and t % save_every_k == 0:
                engine.write_back(carry, outs, s.server, s.sbuf, s.rstream)
                writer.submit(
                    checkpoint_path(checkpoint_dir, t),
                    {"engine": "stacked", "alg": alg,
                     "config": _run_shape(xc, eval_samples), "next_round": t,
                     "rng": checkpoint.generator_state(s.rng),
                     "server": s.server.state_dict(),
                     "buffer": s.sbuf.state_dict(),
                     "streams": s.rstream.state_dict(),
                     "history": history},
                    metadata={"engine": "stacked", "alg": alg, "round": t})
        if writer is not None:
            writer.close()          # drain barrier: all snapshots committed
    finally:
        engine.release()            # the graphs' memory goes with the run
        if writer is not None:
            writer.shutdown()
    if outs is not None:
        engine.write_back(carry, outs, s.server, s.sbuf, s.rstream)
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
              device: torch.device, save_every_k=None, checkpoint_dir=None,
              resume_from=None, keep_last=None) -> list:
    """The per-client loop oracle; one history row per round. Each round
    solves every client's resources, then for each client in turn draws its
    arrivals and runs ``local_train`` unless it is a straggler (kappa < 1),
    and hands the list of ``ClientUpdate``s to the loop server. Snapshots
    are always blocking v1 (the reference's write-path anchor)."""
    model, U = xc.model, xc.num_clients
    streams, rng, bufs, test_batch = _client_setup(xc, eval_samples, device)
    grad_fn = torch.func.grad(lambda p, b: small_loss(p, b, model)[0])
    fl = FLConfig(num_clients=U, local_lr=xc.local_lr,
                  global_lr=(xc.global_lr if alg in ("osafl", "afa_cd")
                             else 1.0),
                  algorithm=alg, engine="loop",
                  score_sketch_dim=xc.score_sketch_dim)
    server = make_server(init_small(xc.seed, model, device), fl, U,
                         seed=xc.seed, device=device)
    net = NetworkConfig()
    clients_sys = make_clients(rng, U, cell_radius_m=xc.cell_radius_m)
    n_params = MODEL_PARAMS.get(model, 1_000_000)
    prox_mu = fl.fedprox_mu if alg == "fedprox" else 0.0
    writer = _make_ckpt_writer(save_every_k, False, keep_last)
    history, start_round = [], 0
    if resume_from is not None:
        snap = checkpoint.load_run_state(resume_from)
        _check_snapshot(snap, "loop", alg, xc, eval_samples)
        checkpoint.set_generator_state(rng, snap["rng"])
        server.load_state_dict(snap["server"])
        for b, sd in zip(bufs, snap["buffers"]):
            b.load_state_dict(sd)
        load_streams_state(streams, snap["streams"])
        history = list(snap["history"])
        start_round = int(snap["next_round"])
    for t in range(start_round, xc.rounds):
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
        if save_every_k and (t + 1) % save_every_k == 0:
            writer.submit(
                checkpoint_path(checkpoint_dir, t + 1),
                {"engine": "loop", "alg": alg,
                 "config": _run_shape(xc, eval_samples), "next_round": t + 1,
                 "rng": checkpoint.generator_state(rng),
                 "server": server.state_dict(),
                 "buffers": [b.state_dict() for b in bufs],
                 "streams": streams_state_dict(streams),
                 "history": history},
                metadata={"engine": "loop", "alg": alg, "round": t + 1})
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
    must exist, or the device of a ``make_host_mesh(device=...)`` mesh;
    ``"cpu"`` runs on the CPU) and return per-round metrics: ``round``,
    ``test_loss``, ``test_acc``, ``participants``, ``request_gen_s`` and
    ``round_s`` (the genie's rows have no ``participants``).

    ``alg`` is one of ``ALL_ALGS`` on the stacked engine (``xc.engine``
    ``"stacked"``, or ``"auto"`` with no mesh), on the pod engine
    (``xc.engine="pod"``, or ``"auto"`` with a mesh; ``pod_engine`` or
    ``xc.pod_engine`` picks the local-train flavour of ``POD_ENGINES``, and
    ``mesh`` defaults to ``make_host_mesh()``, one client row on the run's
    card) or on the per-client loop oracle (``xc.engine="loop"``), or
    ``"centralized"`` (or ``xc.engine="centralized"``) for the pooled-data
    genie. The whole configuration is validated up front
    (``repro_torch.harness.compat``). A mesh of R > 1 client rows runs the
    pod engine on R ranks of the ``torch.distributed`` process group, each
    calling ``run`` with its ``make_host_mesh()``; a sparse cohort or edge
    clusters on more than one row raise ``ExperimentConfigError``.

    ``save_every_k``/``checkpoint_dir`` write a RunState snapshot
    (``checkpoint_path(checkpoint_dir, t)``) after every k-th round;
    ``resume_from`` restores one and continues the trajectory bit for bit;
    ``keep_last`` prunes all but the newest N committed snapshots. The
    stacked and pod engines write v2 snapshots on a background thread
    (``checkpoint_async=False``: blocking v1); the loop engine always
    writes blocking v1; a run over R > 1 rows writes v2 only, one shard
    file per rank. A ``"pod"`` snapshot resumes only into the same
    ``pod_engine`` and mesh shape. The genie does not checkpoint."""
    plan = resolve(alg, xc, mesh=mesh, pod_engine=pod_engine)
    _LOG.info("resolved experiment plan: %s", plan.describe())
    if plan.engine == "centralized":
        if (save_every_k or checkpoint_dir is not None
                or resume_from is not None or keep_last is not None):
            raise ValueError(
                "the centralized genie does not checkpoint (it is a "
                "baseline, not a trajectory to resume); drop the "
                "save_every_k/checkpoint_dir/resume_from/keep_last args")
    else:
        _validate_ckpt_args(save_every_k, checkpoint_dir, keep_last)
    if isinstance(mesh, HostMesh) and mesh.device is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device={device!r} and the mesh's device "
                             f"{mesh.device} disagree")
        device = mesh.device
    device = resolve_device(device)
    with full_f32_convolutions(), deterministic_convolutions():
        if plan.engine == "centralized":
            return _run_centralized(xc, eval_samples, device)
        if plan.engine == "loop":
            return _run_loop(alg, xc, eval_samples, device, save_every_k,
                             checkpoint_dir, resume_from, keep_last)
        if plan.engine == "pod":
            return _run_pod(alg, xc, plan.pod_engine, eval_samples, mesh,
                            device, save_every_k, checkpoint_dir,
                            resume_from, checkpoint_async, keep_last)
        body = _run_fused if plan.round_backend == "fused" else _run_stacked
        return body(alg, xc, eval_samples, device, save_every_k,
                    checkpoint_dir, resume_from, checkpoint_async, keep_last)


# ---------------------------------------------------------------------------
# deprecated entry points (thin shims over run())
# ---------------------------------------------------------------------------

def run_experiment(alg: str, xc: ExperimentConfig, eval_samples: int = 400,
                   save_every_k: int = None, checkpoint_dir=None,
                   resume_from=None, keep_last: int = None, device=None):
    """Deprecated: use ``run(alg, xc)`` with ``xc.engine="loop"``, the
    per-client loop oracle (blocking v1 snapshots)."""
    return run(alg, dataclasses.replace(xc, engine="loop"),
               eval_samples=eval_samples, device=device,
               save_every_k=save_every_k, checkpoint_dir=checkpoint_dir,
               resume_from=resume_from, keep_last=keep_last)


def run_vectorized_experiment(alg: str, xc: ExperimentConfig,
                              eval_samples: int = 400,
                              save_every_k: int = None, checkpoint_dir=None,
                              resume_from=None, checkpoint_async: bool = True,
                              keep_last: int = None, device=None):
    """Deprecated: use ``run(alg, xc)`` with ``xc.engine="stacked"`` (or
    ``"auto"``), the stacked engine."""
    return run(alg, dataclasses.replace(xc, engine="stacked"),
               eval_samples=eval_samples, device=device,
               save_every_k=save_every_k, checkpoint_dir=checkpoint_dir,
               resume_from=resume_from, checkpoint_async=checkpoint_async,
               keep_last=keep_last)


def run_pod_online_experiment(alg: str, xc: ExperimentConfig,
                              eval_samples: int = 400, mesh=None,
                              pod_engine: str = "exact_tp",
                              save_every_k: int = None, checkpoint_dir=None,
                              resume_from=None, checkpoint_async: bool = True,
                              keep_last: int = None, device=None):
    """Deprecated: use ``run(alg, xc, mesh=...)`` with ``xc.engine="pod"``
    and ``xc.pod_engine`` (or a mesh under ``engine="auto"``), the pod
    engine on one client row."""
    return run(alg, dataclasses.replace(xc, engine="pod"),
               eval_samples=eval_samples, device=device, mesh=mesh,
               pod_engine=pod_engine, save_every_k=save_every_k,
               checkpoint_dir=checkpoint_dir, resume_from=resume_from,
               checkpoint_async=checkpoint_async, keep_last=keep_last)


def run_centralized_sgd(xc: ExperimentConfig, eval_samples: int = 400,
                        device=None):
    """Deprecated: use ``run("centralized", xc)``, the pooled-data genie."""
    return run("centralized", dataclasses.replace(xc, engine="centralized"),
               eval_samples=eval_samples, device=device)
