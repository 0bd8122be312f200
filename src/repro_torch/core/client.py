"""Client-side local training (paper eqs. 14-16), one client at a time
(``local_train``, the loop engine's) or the whole cohort at once
(``make_vmapped_local_train``, the stacked engine's).

A client starts from the global model, takes kappa_u mini-batch SGD steps on
its FIFO dataset and returns the normalized accumulated gradient
d_u = (w^{t,0} - w^{t,kappa_u}) / (eta * kappa_u), with the FedProx
proximal term as an option (Algorithm 7). ``repro/core/client.py`` is the
reference.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.buffer import OnlineBuffer
from repro_torch.core.flatten import tree_get, tree_map, tree_paths
from repro_torch.core.scores import tree_scale, tree_sub


def _sgd_step(params, batch, lr, grad_fn, prox_mu=0.0, global_params=None):
    g = grad_fn(params, batch)
    if prox_mu:
        g = tree_map(lambda gg, w, w0: gg + prox_mu * (w - w0),
                     g, params, global_params)
    return tree_map(lambda w, gg: w - lr * gg, params, g)


def local_train(global_params, grad_fn: Callable, buffer: OnlineBuffer,
                kappa: int, lr: float, batch_size: int,
                rng: np.random.Generator, prox_mu: float = 0.0
                ) -> Tuple[dict, dict]:
    """Run kappa local SGD steps on batches drawn from ``buffer`` with
    ``rng``, in the reference's order, each copied once to the weights'
    device. Returns (d_u, w_final)."""
    device = tree_get(global_params, tree_paths(global_params)[0]).device
    params = global_params
    for _ in range(kappa):
        bx, by = buffer.sample_batch(rng, batch_size)
        batch = {"x": torch.as_tensor(bx, device=device),
                 "y": torch.as_tensor(by, device=device)}
        params = _sgd_step(params, batch, lr, grad_fn, prox_mu=prox_mu,
                           global_params=global_params if prox_mu else None)
    d = tree_scale(tree_sub(global_params, params), 1.0 / (lr * kappa))
    return d, params


def make_local_train_body(grad_fn: Callable, lr: float, kappa_max: int,
                          prox_mu: float = 0.0) -> Callable:
    """One client's masked local SGD,
    ``one_client(global_params, batch_u, kappa_u) -> (d_u, w_u)`` with
    ``batch_u`` leaves of shape (kappa_max, B, ...) and ``kappa_u`` a 0-d
    integer tensor: steps with ``t >= kappa_u`` are no-ops, and a straggler
    (``kappa_u == 0``) gives ``d_u = 0`` through the ``max(kappa_u, 1)``
    denominator. ``grad_fn(params, batch)`` returns the loss gradient tree.
    """

    def one_client(global_params, batch_u, kappa_u):
        params = global_params
        for t in range(kappa_max):
            batch_t = tree_map(lambda b: b[t], batch_u)
            stepped = _sgd_step(params, batch_t, lr, grad_fn, prox_mu,
                                global_params)
            params = tree_map(lambda n, o: torch.where(t < kappa_u, n, o),
                              stepped, params)
        denom = lr * torch.clamp(kappa_u, min=1).float()
        d = tree_map(lambda w0, w: (w0 - w) / denom, global_params, params)
        return d, params

    return one_client


def make_vmapped_local_train(grad_fn: Callable, lr: float, kappa_max: int,
                             prox_mu: float = 0.0) -> Callable:
    """``fn(global_params, batches, kappas) -> (d, w)`` for a whole cohort:
    ``make_local_train_body`` under ``torch.func.vmap``, so every client runs
    its steps in lockstep as batched products. ``batches`` leaves are
    (U, kappa_max, B, ...), ``kappas`` is (U,) int in [0, kappa_max], and
    ``d``/``w`` are trees with a leading client axis."""
    one_client = make_local_train_body(grad_fn, lr, kappa_max, prox_mu)
    return torch.func.vmap(one_client, in_dims=(None, 0, 0))
