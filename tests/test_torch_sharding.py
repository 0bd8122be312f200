"""The sharding rules (``repro_torch.launch.sharding``) against the
reference's ``repro/launch/sharding.py`` on the CPU: ``param_spec`` for
every leaf of every architecture, tp and fsdp, on the production meshes
(16, 16) and (2, 16, 16) and on the small (1, 2) and (2, 2) ones (shapes
from ``jax.eval_shape`` of the reference's init beside the port's meta
init, which must agree); ``batch_shardings`` and ``cache_shardings``; and
each rank's shard of a leaf (``local_shard``) put back whole by
``unshard``. The reference's ``NamedSharding`` is replaced by its spec
(its meshes here are shape mappings, not devices)."""
import importlib
import types

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import TRANSFORMER_ARCHS, get_config
from repro_torch.core.flatten import tree_get, tree_paths
from repro_torch.launch import sharding
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import transformer
from test_torch_oracle import reference  # noqa: F401

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x2": {"data": 1, "model": 2},
          "2x2": {"data": 2, "model": 2}}


@pytest.fixture(scope="module")
def ref_sharding(reference):
    mod = importlib.import_module("repro.launch.sharding")
    before = mod.NamedSharding
    mod.NamedSharding = lambda mesh, spec: spec
    yield mod
    mod.NamedSharding = before


@pytest.fixture(scope="module")
def shapes(reference):
    """Each arch's reference leaves {path names: ShapeDtypeStruct}."""
    out = {}
    for arch in TRANSFORMER_ARCHS:
        cfg = reference.configs.get_config(arch)
        tree = jax.eval_shape(lambda k: reference.transformer.init_model(
            k, cfg), jax.random.PRNGKey(0))
        out[arch] = {tuple(p.key for p in path): leaf for path, leaf in
                     jax.tree_util.tree_flatten_with_path(tree)[0]}
    return out


def _mesh(shape: dict):
    """A mesh as both packages read it: axis names and a shape mapping."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _host_mesh(shape: dict) -> HostMesh:
    return HostMesh(np.full(tuple(shape.values()), None, dtype=object),
                    tuple(shape))


@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_param_spec_is_the_references_on_every_leaf(ref_sharding, shapes,
                                                    arch, fsdp):
    meta = transformer.init_model(None, get_config(arch))
    want = shapes[arch]
    assert set(want) == set(tree_paths(meta))
    for path in tree_paths(meta):
        assert tuple(tree_get(meta, path).shape) == want[path].shape, path
    for name, shape in MESHES.items():
        mesh = _mesh(shape)
        for path in tree_paths(meta):
            keys = [jax.tree_util.DictKey(k) for k in path]
            ref = tuple(ref_sharding.param_spec(keys, want[path], fsdp=fsdp,
                                                mesh=mesh))
            got = sharding.param_spec(path, tree_get(meta, path), fsdp=fsdp,
                                      mesh=mesh)
            assert got == ref, (name, path)
        # without a mesh no axis is dropped
        for path in tree_paths(meta):
            keys = [jax.tree_util.DictKey(k) for k in path]
            assert sharding.param_spec(path, tree_get(meta, path),
                                       fsdp=False) == tuple(
                ref_sharding.param_spec(keys, want[path], fsdp=False))


@pytest.mark.parametrize("mesh_name", tuple(MESHES))
def test_batch_and_cache_shardings_are_the_references(ref_sharding,
                                                      reference, mesh_name):
    mesh = _mesh(MESHES[mesh_name])
    assert sharding.batch_axes(mesh) == ref_sharding.batch_axes(mesh)
    batch = {"tokens": np.zeros((32, 8), np.int32),
             "labels": np.zeros((32, 8), np.int32),
             "pos": np.zeros((), np.int32)}
    for shard_batch_dim in (True, False):
        got = sharding.batch_shardings(batch, mesh,
                                       shard_batch_dim=shard_batch_dim)
        want = ref_sharding.batch_shardings(batch, mesh,
                                            shard_batch_dim=shard_batch_dim)
        for k in batch:
            assert got[k].spec == tuple(want[k]), k
    cfg = get_config("qwen1.5-4b").reduced()
    jcfg = reference.configs.get_config("qwen1.5-4b").reduced()
    for B in (32, 3):
        cache = transformer.init_cache(cfg, B, 16, device="meta")
        jcache = jax.eval_shape(
            lambda: reference.transformer.init_cache(jcfg, B, 16))
        got = sharding.cache_shardings(cache, mesh, B)
        want = ref_sharding.cache_shardings(jcache, mesh, B)
        for path in tree_paths(cache):
            assert tree_get(got, path).spec == tuple(tree_get(want, path)), \
                (B, path)


@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("mesh_name", ("1x2", "2x2", "2x16x16"))
def test_shards_gather_back_to_the_whole_leaf(mesh_name, fsdp):
    """Every rank's shard of each leaf of a reduced deepseek-coder-33b
    (and of an arctic MoE stack, whose fsdp spec splits one dimension
    over two axes), put back in rank order, is the leaf bit for bit; a
    shard has the leaf's size over the product of its split axes."""
    shape = MESHES[mesh_name]
    mesh = _host_mesh(shape)
    n = int(np.prod(list(shape.values())))
    gen = torch.Generator().manual_seed(0)
    trees = [transformer.init_model(gen, get_config(a).reduced())
             for a in ("deepseek-coder-33b", "arctic-480b")]
    for tree in trees:
        specs = sharding.param_shardings(tree, mesh, fsdp=fsdp)
        for path in tree_paths(tree):
            leaf, spec = tree_get(tree, path), tree_get(specs, path).spec
            parts = [sharding.local_shard(leaf, spec, mesh, rank=r)
                     for r in range(n)]
            split = 1
            for entry in spec:
                for ax in (entry if isinstance(entry, tuple)
                           else (entry,) if entry else ()):
                    split *= shape[ax]
            assert parts[0].numel() * split == leaf.numel(), path
            assert torch.equal(sharding.unshard(parts, spec, mesh), leaf), \
                path


def test_shard_params_is_this_ranks_part(reference):
    """``shard_params`` and ``params_from_numpy(..., mesh=)`` give the
    rank's shards: column 1 of a (2, 2) mesh holds the second half of
    each split dimension and whole norms."""
    cfg = get_config("qwen1.5-4b").reduced()
    gen = torch.Generator().manual_seed(1)
    whole = transformer.init_model(gen, cfg)
    mesh = HostMesh(np.full((2, 2), None, dtype=object), row=1, col=1)
    local = sharding.shard_params(whole, mesh)
    wq = tree_get(whole, ("dense_layers", "attn", "wq"))
    assert torch.equal(tree_get(local, ("dense_layers", "attn", "wq")),
                       wq[..., wq.shape[-1] // 2:])
    wo = tree_get(whole, ("dense_layers", "attn", "wo"))
    assert torch.equal(tree_get(local, ("dense_layers", "attn", "wo")),
                       wo[:, wo.shape[1] // 2:])
    ln = tree_get(whole, ("final_norm", "scale"))
    assert torch.equal(tree_get(local, ("final_norm", "scale")), ln)
    numpy_tree = {}
    for path in tree_paths(whole):
        node = numpy_tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = tree_get(whole, path).numpy()
    carried = transformer.params_from_numpy(numpy_tree, cfg, device="cpu",
                                            mesh=mesh)
    for path in tree_paths(local):
        assert torch.equal(tree_get(carried, path), tree_get(local, path))
        assert tree_get(carried, path).is_contiguous()
