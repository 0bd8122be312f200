"""Codec between parameter trees and flat (N,) f32 vectors.

A parameter tree is a nested dict of tensors. Leaves are ordered by sorted
keys at every level, which is ``jax.tree.leaves`` order for dicts, and each
leaf keeps the reference layout; so a flat row of the port's (U, N)
contribution buffer compares element for element with a row of the
reference's (``repro/core/flatten.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_paths(tree, prefix: tuple = ()) -> list:
    """Key paths of every leaf, in sorted-key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], prefix + (k,))]
    return [prefix]


def tree_get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest]) for k in tree}
    return fn(tree, *rest)


def tree_from_leaves(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclass(frozen=True)
class FlatCodec:
    """Bijection between one tree layout and flat f32 vectors of length n."""
    n: int
    paths: Tuple[tuple, ...]
    shapes: Tuple[tuple, ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]

    def flatten(self, tree) -> torch.Tensor:
        """Tree -> (n,) float32."""
        return torch.cat([tree_get(tree, p).reshape(-1).float()
                          for p in self.paths])

    def unflatten(self, vec: torch.Tensor) -> dict:
        """(n,) vector -> tree of views with the template shapes/dtypes."""
        return tree_from_leaves(self.paths, [
            vec[o:o + s].reshape(sh).to(dt)
            for o, s, sh, dt in zip(self.offsets, self.sizes, self.shapes,
                                    self.dtypes)])

    def flatten_stacked(self, tree) -> torch.Tensor:
        """Tree whose leaves carry a leading client axis -> (U, n) f32."""
        leaves = [tree_get(tree, p) for p in self.paths]
        U = leaves[0].shape[0]
        return torch.cat([leaf.reshape(U, -1).float() for leaf in leaves],
                         dim=1)

    def unflatten_stacked(self, mat: torch.Tensor) -> dict:
        """(U, n) -> tree with leaves (U, *leaf_shape)."""
        U = mat.shape[0]
        return tree_from_leaves(self.paths, [
            mat[:, o:o + s].reshape((U,) + sh).to(dt)
            for o, s, sh, dt in zip(self.offsets, self.sizes, self.shapes,
                                    self.dtypes)])


def scatter_updates(codec: FlatCodec, updates, num_clients: int,
                    device=None):
    """Scatter a sparse list of client updates into a dense (U, n) float32
    matrix on ``device`` (``None``: the CUDA device) and a numpy bool
    participation mask. Each update needs ``.uid`` and ``.d``, where ``.d``
    is a tree of the codec's layout or an already-flat (n,) row. Every
    stacked server's list-API ``round`` goes through here."""
    dev = resolve_device(device)
    active = np.zeros(num_clients, bool)
    d_new = torch.zeros((num_clients, codec.n), dtype=torch.float32,
                        device=dev)
    for up in updates:
        row = (up.d if getattr(up.d, "ndim", None) == 1
               else codec.flatten(up.d))
        d_new[up.uid] = torch.as_tensor(row, dtype=torch.float32, device=dev)
        active[up.uid] = True
    return d_new, active


def make_codec(template) -> FlatCodec:
    paths = tuple(tree_paths(template))
    leaves = [tree_get(template, p) for p in paths]
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(leaf.numel() for leaf in leaves)
    offsets, total = [], 0
    for s in sizes:
        offsets.append(total)
        total += s
    return FlatCodec(n=total, paths=paths, shapes=shapes,
                     dtypes=tuple(leaf.dtype for leaf in leaves),
                     offsets=tuple(offsets), sizes=sizes)
