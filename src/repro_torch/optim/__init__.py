"""Minimal functional optimizers on parameter trees (``repro/optim``): the
paper's algorithms use plain SGD; Adam serves the centralized baselines
and examples. The state keeps the reference's names (``mu``; ``m``, ``v``,
``t``), so it converts leaf for leaf. Updates return new tensors."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.flatten import tree_get, tree_map, tree_paths


class Optimizer(NamedTuple):
    init: Callable
    update: Callable          # (grads, state, params) -> (updates, state)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params)}
        return {}

    def update(grads, state, params=None):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr * m, mu), {"mu": mu}
        return tree_map(lambda g: -lr * g, grads), state
    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        device = tree_get(params, tree_paths(params)[0]).device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        # f32 bias corrections, as jax computes b ** t for an int32 t
        c1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
        upd = tree_map(lambda m_, v_: -lr * (m_ / c1)
                       / (torch.sqrt(v_ / c2) + eps), m, v)
        return upd, {"m": m, "v": v, "t": t}
    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
