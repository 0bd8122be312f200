"""Parameter, batch and cache sharding rules for the production meshes
(``repro/launch/sharding.py``).

Rules are name-based on the last path component and applied to the
*trailing* dimensions (layer-stacking axes get leading Nones). Two
regimes:

  tp      tensor parallel over 'model', replicated over 'data' (+'pod').
          Used by the exact_tp OSAFL engine (clients = data rows need full
          replicas for client-local gradients).
  fsdp    tp + the largest remaining dim sharded over 'data' (ZeRO-3
          within a pod, replicated across pods). The reference's regime for
          the >100B MoE archs' recompute engine; the port computes its
          specs (the dry run records them) and runs the tp regime.

A spec is a tuple with one entry a dimension: ``None`` (whole), an axis
name, or a tuple of axis names (the dimension split over their product,
the first the major one), as the reference's ``PartitionSpec``; ``()``
is "whole everywhere". A mesh is anything with ``axis_names`` and a
``shape`` mapping each name to its size. The reference's XLA places each
shard; here each rank holds its own, which ``local_shard`` cuts from the
whole leaf (ranks laid out row-major over the mesh's axes, as
``launch/mesh`` lays them) and ``unshard`` puts back together.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.flatten import tree_get, tree_map, tree_paths
from repro_torch.core.shmap import model_axis

# trailing-dims spec per parameter name, tp regime
_TP_RULES = {
    # embeddings / heads
    "table": (None, "model"),
    "lm_head": (None, "model"),
    "vision_proj": (None, "model"),
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # MLA
    "wq_a": (None, None), "wq_b": (None, "model"),
    "wkv_a": (None, None), "wkv_b": (None, "model"),
    # MLP
    "w_up": (None, "model"), "w_gate": (None, "model"),
    "w_down": ("model", None),
    # MoE (expert-parallel over 'model'; router replicated)
    "router": (None, None),
    # mamba / xlstm
    "in_proj": (None, "model"), "out_proj": ("model", None),
    "up_proj": (None, "model"), "down_proj": ("model", None),
    "conv_w": (None, "model"), "conv_b": ("model",),
    "A_log": ("model",), "D": ("model",), "dt_bias": ("model",),
    "w_gates": (None, "model"),
    "wx": (None, "model"), "wh": (None, "model"),
    "w_in": (None, "model"), "r": ("model", None, None),
    # mtp
    "proj": (None, None),
}

# MoE expert tensors are stacked (E, d, f): expert axis over 'model'
_MOE_EXPERT = {"w_gate": ("model", None, None), "w_up": ("model", None, None),
               "w_down": ("model", None, None)}

# fsdp additions: shard this trailing dim index over 'data'
_FSDP_DIM = {
    "table": 0, "lm_head": 0, "wq": 0, "wk": 0, "wv": 0, "wo": 1,
    "w_up": 0, "w_gate": 0, "w_down": 1, "wq_b": 0, "wkv_b": 0,
    "in_proj": 0, "out_proj": 1, "up_proj": 0, "down_proj": 1,
}


def _axis_size(mesh, ax) -> int:
    shape = dict(mesh.shape)
    if isinstance(ax, tuple):
        return math.prod(shape[a] for a in ax)
    return shape[ax]


def param_spec(path, leaf, *, fsdp: bool = False, mesh=None) -> tuple:
    """The spec of the leaf at ``path`` (a tuple of key names, as
    ``core/flatten.tree_paths`` gives them); ``leaf`` needs ``ndim`` and
    ``shape``. With ``mesh``, an axis that does not divide its dimension
    is dropped (the dimension stays whole)."""
    names = [str(n) for n in path]
    name = names[-1] if names else ""
    in_moe = any(n in ("moe", "moe_layers") for n in names[:-1])
    if in_moe and name in _MOE_EXPERT and leaf.ndim >= 3:
        trailing = list(_MOE_EXPERT[name])
        if fsdp:
            # the expert axis over both mesh axes when it divides; else
            # experts over 'model' and dim 1 over 'data' (the reference's
            # fallback for arctic's 128 experts on 256 chips)
            E = leaf.shape[leaf.ndim - 3]
            shape = dict(mesh.shape) if mesh is not None else {}
            nm, nd = shape.get("model", 1), shape.get("data", 1)
            if mesh is not None and E % (nm * nd) == 0:
                trailing[0] = ("model", "data")
            else:
                trailing[1] = "data"
    else:
        trailing = list(_TP_RULES.get(name, ()))
        if not trailing or leaf.ndim < len(trailing):
            return ()
        if fsdp and name in _FSDP_DIM:
            i = _FSDP_DIM[name]
            if trailing[i] is None:
                trailing[i] = "data"
    spec = [None] * (leaf.ndim - len(trailing)) + trailing
    if mesh is not None:
        for i, ax in enumerate(spec):
            if ax is not None and leaf.shape[i] % _axis_size(mesh, ax):
                spec[i] = None
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple


def param_shardings(params, mesh, *, fsdp: bool = False):
    """The tree of ``NamedSharding``s of a parameter tree (tensors, meta
    tensors included)."""
    out = {}
    for path in tree_paths(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = NamedSharding(mesh, param_spec(
            path, tree_get(params, path), fsdp=fsdp, mesh=mesh))
    return out


def batch_axes(mesh) -> tuple:
    """Client/data axes present in the mesh ('pod' first if multi-pod)."""
    return tuple(n for n in ("pod", "data") if n in mesh.axis_names)


def _entry(axes: tuple):
    """A spec entry over ``axes``: one axis by its name (as
    ``PartitionSpec`` normalises it), several as a tuple."""
    return axes[0] if len(axes) == 1 else axes


def batch_shardings(batch, mesh, *, shard_batch_dim: bool = True):
    """Each batch leaf's leading dimension over the client axes."""
    axes = _entry(batch_axes(mesh))

    def spec(leaf):
        return NamedSharding(mesh, (
            axes if shard_batch_dim and leaf.ndim else None,)
            + (None,) * (leaf.ndim - 1))
    return tree_map(spec, batch)


def cache_shardings(cache, mesh, batch_size: int):
    """KV and SSM caches: the batch dimension over the client axes where
    it divides (the first dimension of ``batch_size``); the rest whole."""
    axes = batch_axes(mesh)
    n_dev = math.prod(dict(mesh.shape)[a] for a in axes)

    def spec(leaf):
        for i, s in enumerate(leaf.shape):
            if s == batch_size and batch_size % n_dev == 0 and n_dev > 1:
                return NamedSharding(mesh, (None,) * i + (_entry(axes),)
                                     + (None,) * (leaf.ndim - i - 1))
        return NamedSharding(mesh, ())
    return tree_map(spec, cache)


# ---------------------------------------------------------------------------
# each rank's shard of a whole leaf, and back
# ---------------------------------------------------------------------------

def _coords(mesh, rank: int) -> dict:
    shape = dict(mesh.shape)
    idx = np.unravel_index(int(rank), tuple(shape[a]
                                            for a in mesh.axis_names))
    return dict(zip(mesh.axis_names, (int(i) for i in idx)))


def _part(ax, coords: dict, mesh) -> tuple:
    """(index, count) of a dimension split over ``ax`` at ``coords``."""
    axes = ax if isinstance(ax, tuple) else (ax,)
    shape = dict(mesh.shape)
    index = 0
    for a in axes:
        index = index * shape[a] + coords[a]
    return index, math.prod(shape[a] for a in axes)


def _full_spec(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_shard(leaf, spec: tuple, mesh, rank: int = None):
    """Rank ``rank``'s part of the whole ``leaf`` under ``spec`` (a view;
    ``rank`` defaults to this process's, ``mesh.rank``)."""
    if rank is None:
        rank = mesh.rank
    coords = _coords(mesh, rank)
    out = leaf
    for dim, ax in enumerate(_full_spec(spec, leaf.ndim)):
        if ax is None:
            continue
        i, n = _part(ax, coords, mesh)
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} does "
                             f"not split into {n} parts")
        w = out.shape[dim] // n
        out = out.narrow(dim, i * w, w)
    return out


def unshard(shards, spec: tuple, mesh):
    """The whole leaf from every rank's shard (``shards[rank]``, in rank
    order): ``local_shard``'s inverse. Ranks holding a replica agree by
    construction; the first one's is used."""
    ndim = shards[0].ndim
    full = _full_spec(spec, ndim)
    shape = list(shards[0].shape)
    for dim, ax in enumerate(full):
        if ax is not None:
            shape[dim] *= _part(ax, _coords(mesh, 0), mesh)[1]
    out = torch.empty(shape, dtype=shards[0].dtype, device=shards[0].device)
    for rank, part in enumerate(shards):
        local_shard(out, spec, mesh, rank).copy_(part)
    return out


def shard_params(params, mesh, *, fsdp: bool = False):
    """This rank's shard of every leaf of a whole parameter tree, each a
    contiguous copy (so the whole tree can be freed)."""
    specs = param_shardings(params, mesh, fsdp=fsdp)
    return tree_map(lambda w, s: local_shard(w, s.spec, mesh).contiguous(),
                    params, specs)


def init_shards(gen, cfg, mesh):
    """This rank's shard of every leaf of ``init_model(gen, cfg)``, with
    the same numbers, drawn without the whole tree: each leaf is drawn
    whole in ``init_model``'s order from ``gen``, this rank's shard kept
    (a contiguous copy) and the whole leaf freed before the next one is
    drawn. A rank's peak is its shards plus the largest leaf (at
    deepseek-v3-671b's width one (1, 256, 7168, 2048) bf16 expert stack,
    7.5 GB) where ``shard_params`` of the whole tree would hold all of it
    (31.6 GB at four layers). The leaves drawn with no number (the norms'
    ones, zero biases) are cut from the whole afterwards."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_model
    order: list = []
    with layers.keep_drawn(lambda t: order.append(t) or t):
        template = init_model(None, cfg)
    path_of = {id(tree_get(template, p)): p for p in tree_paths(template)}
    drawn = [path_of[id(t)] for t in order]
    specs = param_shardings(template, mesh)

    def cut(whole, path):
        return local_shard(whole, tree_get(specs, path).spec, mesh).clone(
            memory_format=torch.contiguous_format)
    todo = iter(drawn)
    with layers.keep_drawn(lambda whole: cut(whole, next(todo))):
        tree = init_model(gen, cfg)
    for p in set(tree_paths(tree)) - set(drawn):
        node = tree_get(tree, p[:-1])
        node[p[-1]] = cut(node[p[-1]], p)
    return tree


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class ModelLayout:
    """How a parameter tree lies over a mesh's 'model' axis: each leaf's
    tp spec and whole shape by path, and this rank's ``ModelAxis``. The
    scores (``core/scores.py``) read it to act on the logical tree: a
    split leaf's local terms are model-summed, a whole leaf counts once."""
    mesh: object
    specs: dict
    shapes: dict
    axis: object

    def split(self, path) -> bool:
        """Whether the leaf at ``path`` is split over the model axis."""
        return any("model" in _axes(e) for e in self.specs[tuple(path)])

    def flat_index(self, path, device=None) -> torch.Tensor:
        """The whole leaf's flat (row-major) indices of this rank's shard,
        in the shard's own row-major order (int64)."""
        shape = self.shapes[tuple(path)]
        whole = torch.arange(math.prod(shape), device=device).view(shape)
        return local_shard(whole, self.specs[tuple(path)],
                           self.mesh).reshape(-1)


def model_layout(params, mesh):
    """The ``ModelLayout`` of a whole-shape parameter tree (meta tensors
    serve) on ``mesh``, or None where the mesh has one model column."""
    axis = model_axis(mesh)
    if axis is None:
        return None
    paths = tree_paths(params)
    return ModelLayout(
        mesh, {p: param_spec(p, tree_get(params, p), mesh=mesh)
               for p in paths},
        {p: tuple(tree_get(params, p).shape) for p in paths}, axis)


def gather_params(tree, whole, mesh):
    """``shard_params``'s inverse through collectives: every rank of a row
    gets the whole tree from its row's shards (``tree``, tp rules; each
    split leaf's parts concatenated along its split dimension with
    ``core/shmap.model_cat``). ``whole`` is any tree of the whole shapes
    (meta tensors serve)."""
    from repro_torch.core.shmap import model_cat
    specs = param_shardings(whole, mesh)

    def one(leaf, s):
        dims = [i for i, e in enumerate(s.spec) if e is not None]
        if not dims:
            return leaf
        if [s.spec[i] for i in dims] != ["model"]:
            raise ValueError(f"gather_params takes the tp rules' specs, "
                             f"got {s.spec}")
        return model_cat(leaf, mesh, dim=dims[0])
    return tree_map(one, tree, specs)
