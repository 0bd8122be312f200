"""Pod-scale OSAFL train steps and the serving steps of the transformer zoo
(``repro/core/pod.py``), one process per client row.

The reference maps clients onto the client axes ('pod', 'data') of a TPU
mesh. Here each client row is one rank of the default
``torch.distributed`` process group (``launch/mesh.make_host_mesh``), and
its ``psum``s and ``pmax``es are ``core/shmap``'s rank-ordered
collectives; with one row and no group they are the identity. Each rank
passes its own block of the batch (``shmap.client_sharding``). The
stationary-batch engines are ported as the reference computes them:

exact_tp    one client per row: its gradient d, d_mean = psum(d) / U,
            cos(d, d_mean), lambda = (chi + cos) / (chi + 1) and the
            update psum(lambda d) / U, the two-phase scored all-reduce (a
            count-sketch cosine against the psum of the sketches with
            ``sketch_dim``).
recompute   each row's clients in sequence, two backwards: pass 1 sums d_u
            (summed across rows), pass 2 recomputes each d_u, scores it
            against d_mean and sums lambda_u d_u (summed across rows); f32
            accumulators (bf16 with ``REPRO_ACCUM_BF16=1``).
stale       one backward: round t is weighted by round t-1's lambdas, and
            this round's count sketches give round t+1's.
fedavg      the unscored data-parallel step (the rows' gradients averaged).

Each step returns new parameters and leaves its inputs alone; the
accumulators of a step are summed in place (they are the step's own).

Online mode: every factory also takes ``batch_fn``/``grad_fn``. With
``batch_fn`` set, the step takes the storage of a ``StackedOnlineBuffer``
and sampled slots instead of a batch, gathers each client's local-SGD
minibatches from the client's own storage row (``make_pod_batch_fn``) and
runs the paper's masked kappa_u-step local SGD
(``client.make_local_train_body``) for each client:
``step(params, bx, by, slots, kappas) -> (d, w)``, stacked over the
clients. Over R rows each rank passes its rows of the storage, slots and
kappas and gets its (U/R, ...) rows back; the step is row-local. exact_tp,
stale and fedavg run the rank's clients under one ``torch.func.vmap``;
recompute runs them one at a time and writes each client's ``d_u``/``w_u``
into preallocated (U/R, ...) trees, so no U-wide SGD state is live.
Aggregation stays with the stacked servers (``repro_torch.harness.run`` on
the pod engine; stale's one-round score lag is the server's
``FLConfig.stale_scores``).

A mesh of R > 1 rows needs a process group of R ranks (``ValueError``
otherwise). The count-sketch signs are the port's
(``core/scores.sketch_signs_int8`` under ``SKETCH_KEY``), equal to the
reference's ``PRNGKey(17)`` signs only in distribution.
"""
from __future__ import annotations

import os
from typing import Callable

import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.client import make_local_train_body
from repro_torch.core.flatten import (tree_from_leaves, tree_get, tree_map,
                                      tree_paths)
from repro_torch.core.scores import sketch_tree, tree_dot, tree_norm
from repro_torch.core.shmap import (check_ranks, client_rows,
                                    client_sharding, row_cat, row_max,
                                    row_mean, row_min, row_sum, shard_map)
from repro_torch.models.transformer import decode_step, forward, loss_fn

# the (2,) uint32 words of the reference's PRNGKey(17)
SKETCH_KEY = (0, 17)


def num_pod_clients(mesh=None) -> int:
    """Client rows of the layout (clients of exact_tp, one a row): the
    mesh's R, 1 with no mesh."""
    if mesh is None:
        return 1
    if not hasattr(mesh, "axis_names"):
        raise TypeError(f"{mesh!r} is not a mesh; pass "
                        "repro_torch.launch.mesh.make_host_mesh()")
    return client_rows(mesh)


def _rows(mesh) -> int:
    """The layout's client rows, each a rank of the process group."""
    R = num_pod_clients(mesh)
    if mesh is not None:
        check_ranks(mesh)
    return R


def _block(mesh, U: int) -> tuple:
    """This row's ``(lo, hi)`` of U clients, each a rank of the process
    group."""
    _rows(mesh)
    return (0, U) if mesh is None else client_sharding(mesh).bounds(U)


# ---------------------------------------------------------------------------
# online mode: each client samples its minibatches from its own storage row
# of a StackedOnlineBuffer (the paper's FIFO arrivals on the pod engines)
# ---------------------------------------------------------------------------

def make_pod_batch_fn() -> Callable:
    """``batch_fn(bx, by, slots)``: each client row's local-SGD minibatches
    gathered from that client's own storage rows. ``bx``/``by`` are the
    buffer's storage (U, D, *feat) / (U, D) and ``slots`` the
    (U, kappa_max, B) live-window slots of
    ``StackedOnlineBuffer.sample_slots``; returns the ``{"x", "y"}`` batch
    with leaves (U, kappa_max, B, ...) that ``client.make_local_train_body``
    consumes (the indexing of ``StackedOnlineBuffer.gather``)."""
    def batch_fn(bx, by, slots):
        U = bx.shape[0]
        idx = torch.as_tensor(slots, dtype=torch.long, device=bx.device)
        uu = torch.arange(U, device=bx.device).reshape(
            (U,) + (1,) * (idx.ndim - 1))
        return {"x": bx[uu, idx], "y": by[uu, idx]}
    return batch_fn


def _online_grad_fn(grad_fn, cfg):
    """The caller's ``grad_fn``, else the gradient of the zoo's
    ``loss_fn`` (which reads ``batch["tokens"]`` and ``["labels"]``, so a
    caller pairs it with a batch function that gives them)."""
    if grad_fn is not None:
        return grad_fn
    return torch.func.grad(lambda p, b: loss_fn(p, b, cfg)[0])


def _make_online_step(fl: FLConfig, mesh, batch_fn: Callable,
                      grad_fn: Callable, *, scan: bool = False,
                      prox_mu: float = 0.0) -> Callable:
    """The online step of the four factories: ``step(params, bx, by, slots,
    kappas) -> (d, w)``, ``d``/``w`` trees with a leading client axis.
    ``scan=False`` (exact_tp, stale, fedavg) runs every client under one
    ``torch.func.vmap``; ``scan=True`` (recompute) runs one client at a
    time and writes its outputs into preallocated (U, ...) trees. Both run
    ``client.make_local_train_body``'s masked local SGD, so kappa_u = 0
    stragglers give d_u = 0 and the forms agree to rounding. Over R rows
    the step takes and returns this rank's rows: it needs no collective."""
    _rows(mesh)
    one_client = make_local_train_body(grad_fn, fl.local_lr, fl.kappa_max,
                                       prox_mu=prox_mu)

    if scan:
        def step(params, bx, by, slots, kappas):
            batch = batch_fn(bx, by, slots)
            U = int(kappas.shape[0])
            d = w = None
            for u in range(U):
                d_u, w_u = one_client(params,
                                      tree_map(lambda b: b[u], batch),
                                      kappas[u])
                if d is None:
                    d, w = (tree_map(lambda x: x.new_empty(
                        (U,) + tuple(x.shape)), t) for t in (d_u, w_u))
                for out, one in ((d, d_u), (w, w_u)):
                    for p in tree_paths(out):
                        tree_get(out, p)[u].copy_(tree_get(one, p))
            return d, w
        return step

    many = torch.func.vmap(one_client, in_dims=(None, 0, 0))

    def body(params, bx, by, slots, kappas):
        return many(params, batch_fn(bx, by, slots), kappas)
    return shard_map(body, mesh=mesh)


def _lambda(chi, cos):
    return (chi + cos) / (chi + 1.0)


def _scored_metrics(lam, loss, mesh, U: int) -> dict:
    """The reference's metrics from each row's lambda and loss: psums over
    the rows / U, and pmin, pmax."""
    return {"loss": row_sum(loss, mesh) / U,
            "lambda_mean": row_sum(lam, mesh) / U,
            "lambda_min": row_min(lam, mesh),
            "lambda_max": row_max(lam, mesh)}


def _loss_and_grad(params, batch, cfg: ModelConfig):
    """``loss_fn``'s loss (detached) and its gradient tree at ``params``."""
    paths = tree_paths(params)
    leaves = [tree_get(params, p).detach().requires_grad_() for p in paths]
    with torch.enable_grad():
        loss, _ = loss_fn(tree_from_leaves(paths, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_from_leaves(paths, grads)


def _check_clients(batch: dict, n: int) -> None:
    """A stationary step's batch holds this row's n clients."""
    got = {int(x.shape[0]) for x in batch.values()}
    if got != {n}:
        raise ValueError(f"the batch's leading (client) dimension is "
                         f"{sorted(got)}; this row runs {n} clients")


def _apply(params, update, lr_eff: float):
    return tree_map(lambda w, u: w - lr_eff * u.to(w.dtype), params, update)


def _add_(acc, tree, scale=None) -> None:
    """acc += (scale *) tree, leaf by leaf in acc's dtype, in place; the
    product is taken in f32 first, as the reference casts it."""
    for p in tree_paths(acc):
        a, x = tree_get(acc, p), tree_get(tree, p)
        a.add_(x.to(a.dtype) if scale is None
               else (scale * x.float()).to(a.dtype))


# ---------------------------------------------------------------------------
# exact_tp (one client a row, the two-phase scored all-reduce)
# ---------------------------------------------------------------------------

def make_tp_train_step(cfg: ModelConfig, fl: FLConfig, mesh=None, *,
                       sketch_dim: int = 0, batch_fn: Callable = None,
                       grad_fn: Callable = None,
                       prox_mu: float = 0.0) -> Callable:
    """``step(params, batch) -> (new params, metrics)``, each row's
    ``batch`` its own block of the global batch (its client's data);
    ``kappa_max`` > 1 splits it into that many microbatches whose
    gradients are averaged. With ``batch_fn``, the online step (module
    docstring)."""
    if batch_fn is not None:
        return _make_online_step(fl, mesh, batch_fn,
                                 _online_grad_fn(grad_fn, cfg),
                                 prox_mu=prox_mu)
    U = _rows(mesh)
    lr_eff = fl.global_lr * fl.local_lr
    chi = fl.chi

    def local_update(params, batch):
        if fl.kappa_max <= 1:
            return _loss_and_grad(params, batch, cfg)
        kappa = fl.kappa_max
        split = {k: x.reshape((kappa, -1) + tuple(x.shape[1:]))
                 for k, x in batch.items()}
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        g = tree_map(torch.zeros_like, params)
        for tau in range(kappa):
            l, g_tau = _loss_and_grad(params, {k: x[tau] for k, x in
                                               split.items()}, cfg)
            loss = loss + l / kappa
            g = tree_map(lambda a, x: a + x * (1.0 / kappa), g, g_tau)
        return loss, g

    def step(params, batch):
        loss, g = local_update(params, batch)
        if sketch_dim:
            sk = sketch_tree(g, SKETCH_KEY, sketch_dim)
            sk_mean = row_sum(sk, mesh) / U
            cos = torch.vdot(sk, sk_mean) / torch.clamp(
                torch.linalg.vector_norm(sk)
                * torch.linalg.vector_norm(sk_mean), min=1e-12)
        else:
            d_mean = tree_map(lambda x: row_sum(x, mesh) / U, g)
            cos = tree_dot(g, d_mean) / torch.clamp(
                tree_norm(g) * tree_norm(d_mean), min=1e-12)
        lam = _lambda(chi, cos)
        update = tree_map(lambda x: row_sum(lam * x, mesh) / U, g)
        return (_apply(params, update, lr_eff),
                _scored_metrics(lam, loss, mesh, U))
    return step


# ---------------------------------------------------------------------------
# exact_recompute (clients in sequence, 2 backwards)
# ---------------------------------------------------------------------------

def make_recompute_train_step(cfg: ModelConfig, fl: FLConfig, mesh,
                              num_clients: int, grad_specs=None, *,
                              batch_fn: Callable = None,
                              grad_fn: Callable = None,
                              prox_mu: float = 0.0) -> Callable:
    """``step(params, batch) -> (new params, metrics)``, batch leaves
    (U / R, b, ...): this row's clients. ``grad_specs`` (the reference's
    sharding pins) is taken and has nothing to pin: each rank holds whole
    parameters. With ``batch_fn``, the online step in its
    one-client-at-a-time form (module docstring)."""
    if batch_fn is not None:
        return _make_online_step(fl, mesh, batch_fn,
                                 _online_grad_fn(grad_fn, cfg),
                                 scan=True, prox_mu=prox_mu)
    lr_eff = fl.global_lr * fl.local_lr
    chi = fl.chi
    U = num_clients
    lo, hi = _block(mesh, U)
    n_loc = hi - lo
    acc_dtype = (torch.bfloat16 if os.environ.get("REPRO_ACCUM_BF16") == "1"
                 else torch.float32)

    def zeros(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                              device=p.device), params)

    def client(batch, u):
        return {k: x[u] for k, x in batch.items()}

    def step(params, batch):
        _check_clients(batch, n_loc)
        sum_d, losses = zeros(params), []
        for u in range(n_loc):                   # pass 1: sum of d_u
            loss, g = _loss_and_grad(params, client(batch, u), cfg)
            _add_(sum_d, g)
            losses.append(loss)
        d_mean = tree_map(lambda x: row_sum(x, mesh) * (1.0 / U), sum_d)
        del sum_d
        nm = tree_norm(d_mean)
        wsum, lams = zeros(params), []
        for u in range(n_loc):                   # pass 2: lambda_u d_u
            _, g = _loss_and_grad(params, client(batch, u), cfg)
            g = tree_map(lambda x: x.to(acc_dtype), g)
            cos = tree_dot(g, d_mean) / torch.clamp(tree_norm(g) * nm,
                                                    min=1e-12)
            lam = _lambda(chi, cos)
            _add_(wsum, g, lam)
            lams.append(lam)
        update = tree_map(lambda x: row_sum(x, mesh) * (1.0 / U), wsum)
        lams = torch.stack(lams)
        metrics = {"loss": row_mean(torch.stack(losses), mesh),
                   "lambda_mean": row_mean(lams, mesh),
                   "lambda_min": row_min(lams.min(), mesh),
                   "lambda_max": row_max(lams.max(), mesh)}
        return _apply(params, update, lr_eff), metrics
    return step


# ---------------------------------------------------------------------------
# stale scores (1 backward; round t weighted by round t-1's lambdas)
# ---------------------------------------------------------------------------

def make_stale_score_train_step(cfg: ModelConfig, fl: FLConfig, mesh,
                                num_clients: int, grad_specs=None,
                                sketch_dim: int = 1024, *,
                                batch_fn: Callable = None,
                                grad_fn: Callable = None,
                                prox_mu: float = 0.0) -> Callable:
    """``step(params, lam_prev (U,), batch) -> (new params, lam_next (U,),
    metrics)``, batch leaves (U / R, b, ...): this row's clients. With
    ``batch_fn``, exact_tp's online step: the one-round score lag is the
    server's (``FLConfig.stale_scores``)."""
    if batch_fn is not None:
        return _make_online_step(fl, mesh, batch_fn,
                                 _online_grad_fn(grad_fn, cfg),
                                 prox_mu=prox_mu)
    lr_eff = fl.global_lr * fl.local_lr
    chi = fl.chi
    U = num_clients
    lo, hi = _block(mesh, U)

    def step(params, lam_prev, batch):
        _check_clients(batch, hi - lo)
        wsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        losses, sketches = [], []
        for u in range(hi - lo):
            loss, g = _loss_and_grad(params, {k: x[u] for k, x in
                                              batch.items()}, cfg)
            g = tree_map(lambda x: x.float(), g)
            sketches.append(sketch_tree(g, SKETCH_KEY, sketch_dim))
            _add_(wsum, g, lam_prev[lo + u])
            losses.append(loss)
        update = tree_map(lambda x: row_sum(x, mesh) * (1.0 / U), wsum)
        sketches = torch.stack(sketches)
        mean_sk = row_mean(sketches, mesh)
        cos = (sketches @ mean_sk) / torch.clamp(
            torch.linalg.vector_norm(sketches, dim=1)
            * torch.linalg.vector_norm(mean_sk), min=1e-12)
        lam_next = row_cat(_lambda(chi, cos), mesh)
        metrics = {"loss": row_mean(torch.stack(losses), mesh),
                   "lambda_mean": lam_next.mean(),
                   "lambda_min": lam_next.min(),
                   "lambda_max": lam_next.max()}
        return _apply(params, update, lr_eff), lam_next, metrics
    return step


# ---------------------------------------------------------------------------
# plain data-parallel step (the M-FedAvg pod baseline)
# ---------------------------------------------------------------------------

def make_fedavg_train_step(cfg: ModelConfig, fl: FLConfig, mesh=None, *,
                           batch_fn: Callable = None,
                           grad_fn: Callable = None,
                           prox_mu: float = 0.0) -> Callable:
    """``step(params, batch) -> (new params, {"loss"})``: the unscored
    baseline, each row's ``batch`` its block of the global batch and the
    gradient the rows' mean. With ``batch_fn``, exact_tp's online step:
    unscored averaging is the stacked FedAvg server's."""
    if batch_fn is not None:
        return _make_online_step(fl, mesh, batch_fn,
                                 _online_grad_fn(grad_fn, cfg),
                                 prox_mu=prox_mu)
    lr_eff = fl.global_lr * fl.local_lr
    R = _rows(mesh)

    def step(params, batch):
        loss, g = _loss_and_grad(params, batch, cfg)
        if R > 1:
            g = tree_map(lambda x: row_sum(x, mesh) / R, g)
            loss = row_sum(loss, mesh) / R
        return _apply(params, g, lr_eff), {"loss": loss}
    return step


# ---------------------------------------------------------------------------
# serving steps (decode shapes)
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig) -> Callable:
    """One KV-cache decode step: (params, cache, tokens (B, 1), pos,
    memory=None) -> (next tokens (B, 1) int32, cache), greedy; ``memory``
    is whisper's encoder output or the vision decoder's projected
    patches."""
    def serve_step(params, cache, tokens, pos, memory=None):
        logits, new_cache = decode_step(params, cache, tokens, pos, cfg,
                                        memory=memory)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache
    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """The prompt's forward: (params, {"tokens": (B, S)} [+ "frames" or
    "patches"]) -> the greedy next token (B,) int32."""
    def prefill(params, batch):
        logits, _ = forward(params, batch, cfg)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    return prefill
