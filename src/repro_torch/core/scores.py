"""Online scores (paper eqs. 19-21, 34-35) on parameter trees, and the tree
arithmetic the loop servers are built from (``repro/core/scores.py``).

Exact scores: lambda_u = (chi + cos(d_mean, d_u)) / (chi + 1), Delta_u =
lambda_u. Every tree op returns new tensors and never writes in place: the
loop servers start with one tree shared by all U buffer slots.

The sketched scores (``sketch_tree``, ``lambda_scores_sketched``,
``sketch_stacked``) are not ported yet: their signs come from jax's
threefry (ROADMAP A6).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.flatten import tree_get, tree_map, tree_paths


def tree_dot(a, b) -> torch.Tensor:
    """Sum of f32 dot products over the leaves, in sorted-key order (the
    reference's leaf order); a 0-d tensor."""
    return sum(torch.vdot(tree_get(a, p).reshape(-1).float(),
                          tree_get(b, p).reshape(-1).float())
               for p in tree_paths(a))


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def cosine(a, b, eps: float = 1e-12) -> torch.Tensor:
    return tree_dot(a, b) / torch.clamp(tree_norm(a) * tree_norm(b), min=eps)


def lambda_scores(updates: Sequence, chi: float = 1.0) -> np.ndarray:
    """Paper eqs. 19-21: d_mean = (1/U) sum_u d_u; lambda in [0, 1]. Each
    lambda is computed in f32 on the updates' device, as the reference
    computes it, and the U of them reach the host in one copy."""
    U = len(updates)
    d_mean = tree_scale(updates[0], 1.0 / U)
    for d in updates[1:]:
        d_mean = tree_add(d_mean, tree_scale(d, 1.0 / U))
    lam = torch.stack([(chi + cosine(d_mean, d)) / (chi + 1.0)
                       for d in updates])
    return lam.cpu().numpy().astype(np.float64)

