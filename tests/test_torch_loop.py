"""The per-client loop engine and the list-API server round against the JAX
reference on the CPU: the tree scores, ``scatter_updates``, the loop
servers, the stacked servers' ``round(updates)`` against the port's own loop
servers, ``local_train``, the scalar resource solve, and whole
``run(alg, engine="loop")`` runs against live reference loop runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.osafl as tosafl
import repro_torch.harness.experiments as tex
from repro_torch.configs.base import FLConfig
from repro_torch.core import resource as tres
from repro_torch.core.baselines import SERVERS, STACKED_SERVERS, make_server
from repro_torch.core.buffer import OnlineBuffer
from repro_torch.core.client import local_train
from repro_torch.core.flatten import (make_codec, scatter_updates, tree_get,
                                      tree_map, tree_paths)
from repro_torch.core.osafl import ClientUpdate, OSAFLServer
from repro_torch.core.scores import cosine, lambda_scores
from repro_torch.harness import ExperimentConfig, run
from repro_torch.harness.compat import ALL_ALGS
from repro_torch.models.small import params_from_numpy, small_loss
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401


def _np_tree(rng, scale=1.0):
    """A seeded tree whose dict order is not its sorted-key order."""
    f32 = np.float32
    return {"z": (scale * rng.normal(size=13)).astype(f32),
            "a": {"y": (scale * rng.normal(size=(4, 5))).astype(f32),
                  "b": (scale * rng.normal(size=(3,))).astype(f32)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(got, want, atol):
    """``got`` a port tree, ``want`` a reference tree, leaf by leaf."""
    assert tree_paths(got) == tree_paths(to_numpy_tree(want))
    for p in tree_paths(got):
        np.testing.assert_allclose(tree_get(got, p).numpy(),
                                   np.asarray(tree_get(want, p)), rtol=0,
                                   atol=atol, err_msg=".".join(p))


# -- core/scores.py ---------------------------------------------------------

@pytest.mark.parametrize("case", ["u1", "u5", "zeros"])
def test_lambda_scores_and_cosine_match_reference(reference, case):
    rng = np.random.default_rng(3)
    U = 1 if case == "u1" else 5
    trees = [_np_tree(rng, 0.0 if case == "zeros" else 1.0)
             for _ in range(U)]
    for chi in (1.0, 0.5, 3.0):
        want = reference.scores.lambda_scores([_jax(t) for t in trees], chi)
        got = lambda_scores([_torch(t) for t in trees], chi)
        assert got.dtype == np.float64 and got.shape == (U,)
        # the u=1 score sits an ulp above 1 (1.0000001) in both packages
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        if case == "zeros" and chi == 1.0:   # the eps guard: cos = 0
            np.testing.assert_array_equal(got, 0.5)
    a, b = trees[0], trees[-1]
    np.testing.assert_allclose(
        float(cosine(_torch(a), _torch(b))),
        float(reference.scores.cosine(_jax(a), _jax(b))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("flat", [False, True])
def test_scatter_updates_matches_reference(reference, flat):
    rng = np.random.default_rng(4)
    template = _np_tree(rng)
    rcodec = reference.flatten.make_codec(_jax(template))
    codec = make_codec(_torch(template))
    trees = {u: _np_tree(rng) for u in (4, 1, 4)}     # a repeated uid
    rups = [reference.osafl.ClientUpdate(
        u, np.asarray(rcodec.flatten(_jax(t))) if flat else _jax(t), 1)
        for u, t in trees.items()]
    ups = [ClientUpdate(u, codec.flatten(_torch(t)) if flat else _torch(t), 1)
           for u, t in trees.items()]
    want, want_mask = reference.flatten.scatter_updates(rcodec, rups, 6)
    got, mask = scatter_updates(codec, ups, 6, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (6, codec.n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert mask.dtype == bool
    np.testing.assert_array_equal(mask, want_mask)


# -- the loop servers against the reference's -------------------------------

def _updates(rng, U, params=None):
    """One round's random partial participation; weight-holding servers get
    the current weights plus a small step."""
    ups = []
    for u in rng.choice(U, size=rng.integers(1, U), replace=False):
        d = _np_tree(rng, 0.1)
        if params is not None:
            d = jax.tree.map(lambda w, x: np.asarray(w) + x,
                             to_numpy_tree(params), d)
        h = None
        if u % 3:
            h = rng.dirichlet(np.ones(10))
        ups.append((int(u), d, int(rng.integers(1, 6)),
                    int(rng.integers(5, 50)), h))
    return ups


@pytest.mark.parametrize("literal", [False, True])
@pytest.mark.parametrize("stale", [False, True])
def test_osafl_loop_round_matches_reference(reference, literal, stale):
    U = 5
    rng = np.random.default_rng(5)
    w0 = _np_tree(rng)
    kw = dict(num_clients=U, local_lr=0.1, global_lr=2.0,
              literal_init_buffer=literal, stale_scores=stale)
    jsrv = reference.osafl.OSAFLServer(_jax(w0), reference.base.FLConfig(**kw),
                                       U)
    tsrv = OSAFLServer(_torch(w0), FLConfig(**kw), U, device="cpu")
    for r in range(4):
        ups = _updates(rng, U)
        want = jsrv.round([reference.osafl.ClientUpdate(u, _jax(d), k, n, h)
                           for u, d, k, n, h in ups])
        got = tsrv.round([ClientUpdate(u, _torch(d), k, n, h)
                          for u, d, k, n, h in ups])
        _assert_trees_close(got, want, atol=1e-5)
        np.testing.assert_allclose(tsrv.last_scores, jsrv.last_scores,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tsrv.participated, jsrv.participated)


@pytest.mark.parametrize("alg", sorted(SERVERS))
@pytest.mark.parametrize("literal", [False, True])
def test_loop_baselines_match_reference(reference, alg, literal):
    U = 6
    rng = np.random.default_rng(6)
    w0 = _np_tree(rng)
    kw = dict(num_clients=U, local_lr=0.1, global_lr=2.0, algorithm=alg,
              literal_init_buffer=literal)
    jsrv = reference.baselines.SERVERS[alg](
        _jax(w0), reference.base.FLConfig(**kw), U)
    tsrv = make_server(_torch(w0), FLConfig(**kw), U, device="cpu")
    assert type(tsrv) is SERVERS[alg]
    for r in range(4):
        ups = _updates(rng, U, jsrv.params if tsrv.buffers_hold_weights
                       else None)
        want = jsrv.round([reference.osafl.ClientUpdate(u, _jax(d), k, n, h)
                           for u, d, k, n, h in ups])
        got = tsrv.round([ClientUpdate(u, _torch(d), k, n, h)
                          for u, d, k, n, h in ups])
        _assert_trees_close(got, want, atol=1e-5)
        np.testing.assert_array_equal(tsrv.participated, jsrv.participated)
        for tm, jm in zip(tsrv.meta, jsrv.meta):       # sticky metadata
            assert (tm is None) == (jm is None)
            if tm is not None:
                assert (tm.uid, tm.kappa, tm.data_size) == (
                    jm.uid, jm.kappa, jm.data_size)
                assert (tm.label_hist is None) == (jm.label_hist is None)
                if tm.label_hist is not None:
                    np.testing.assert_array_equal(tm.label_hist,
                                                  jm.label_hist)


# -- the stacked servers' list API against the port's loop servers ----------

@pytest.mark.parametrize("alg", ["osafl"] + sorted(STACKED_SERVERS))
def test_stacked_list_round_matches_loop(monkeypatch, alg):
    """The reference's loop-against-stacked check
    (tests/test_stacked_engine.py), within the port: atol 1e-5. The stacked
    OSAFL round scores through ``scored_reduce`` once a round, the loop
    server never."""
    calls = []
    real = tosafl.scored_reduce

    def spy(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(tosafl, "scored_reduce", spy)
    U = 5
    rng = np.random.default_rng(7)
    w0 = _np_tree(rng)
    kw = dict(num_clients=U, local_lr=0.1, global_lr=2.0, algorithm=alg)
    loop = make_server(_torch(w0), FLConfig(engine="loop", **kw), U,
                       device="cpu")
    stacked = make_server(_torch(w0), FLConfig(engine="stacked", **kw), U,
                          device="cpu")
    for r in range(4):
        ups = _updates(rng, U, loop.params
                       if getattr(loop, "buffers_hold_weights", False)
                       else None)
        a = loop.round([ClientUpdate(u, _torch(d), k, n, h)
                        for u, d, k, n, h in ups])
        b = stacked.round([ClientUpdate(u, _torch(d), k, n, h)
                           for u, d, k, n, h in ups])
        for p in tree_paths(a):
            np.testing.assert_allclose(tree_get(a, p).numpy(),
                                       tree_get(b, p).numpy(), rtol=0,
                                       atol=1e-5)
    if alg == "osafl":
        np.testing.assert_allclose(loop.last_scores, stacked.last_scores,
                                   rtol=0, atol=1e-5)
    assert len(calls) == (4 if alg == "osafl" else 0)


# -- core/client.py::local_train --------------------------------------------

@pytest.mark.parametrize("prox_mu", [0.0, 0.9])
def test_local_train_matches_reference(reference, prox_mu):
    model, cap = "mlp", 40
    data = np.random.default_rng(8)
    x = data.integers(0, 100, size=(cap + 7, 10))
    y = data.integers(0, 100, size=cap + 7)
    jbuf = reference.buffer.OnlineBuffer.create(cap, (10,), 100,
                                                dtype=np.int64)
    tbuf = OnlineBuffer.create(cap, (10,), 100, dtype=np.int64)
    for b in (jbuf, tbuf):               # past capacity: the FIFO wraps
        b.stage(x, y)
        b.commit()
    w0 = reference.small.init_small(jax.random.PRNGKey(2), model)
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    jd, jw = reference.client.local_train(
        w0, jax.grad(lambda p, b: reference.small.small_loss(p, b, model)[0]),
        jbuf, 3, 0.1, 8, jrng, prox_mu=prox_mu)
    td, tw = local_train(
        params_from_numpy(model, to_numpy_tree(w0), "cpu"),
        torch.func.grad(lambda p, b: small_loss(p, b, model)[0]),
        tbuf, 3, 0.1, 8, trng, prox_mu=prox_mu)
    _assert_trees_close(td, jd, atol=2e-5)
    _assert_trees_close(tw, jw, atol=2e-5)
    assert trng.bit_generator.state == jrng.bit_generator.state


# -- core/resource.py: the scalar solve -------------------------------------

@pytest.mark.parametrize("n_params", [18_000, 3_900_000])
def test_optimize_round_matches_reference(reference, n_params):
    """64 clients, the MLP's and the FCN's model sizes (the FCN's leaves
    stragglers): float64 numpy in both, so the decisions agree to the last
    bit but for a 1e-12 margin."""
    jrng, trng = np.random.default_rng(10), np.random.default_rng(10)
    jsys = reference.resource.make_clients(jrng, 64, cell_radius_m=600.0)
    tsys = tres.make_clients(trng, 64, cell_radius_m=600.0)
    want = reference.resource.optimize_round(
        jrng, reference.resource.NetworkConfig(), jsys, n_params)
    got = tres.optimize_round(trng, tres.NetworkConfig(), tsys, n_params)
    assert [g.kappa for g in got] == [w.kappa for w in want]
    assert [g.feasible for g in got] == [w.feasible for w in want]
    for key in ("f", "p", "t_total", "e_total"):
        np.testing.assert_allclose([getattr(g, key) for g in got],
                                   [getattr(w, key) for w in want],
                                   rtol=1e-12, atol=0, err_msg=key)
    assert trng.bit_generator.state == jrng.bit_generator.state
    assert 0 < sum(g.feasible for g in got) <= 64


# -- the whole slice: run(alg, engine="loop") against a live reference ------

MLP = dict(model="mlp", dataset=2, num_clients=16, rounds=3,
           capacity=(16, 32), engine="loop")
LOOP_SLICES = {
    **{f"{alg}-mlp-d2-u16": (alg, MLP) for alg in ALL_ALGS},
    "osafl-fcn-d1-u4": ("osafl", dict(model="fcn", dataset=1, num_clients=4,
                                      rounds=2, capacity=(16, 32),
                                      engine="loop")),
    # global_lr=1: see test_torch_harness.py's CONV
    "osafl-cnn-d1-u4": ("osafl", dict(model="cnn", dataset=1, num_clients=4,
                                      rounds=2, capacity=(16, 32),
                                      global_lr=1.0, engine="loop")),
}
EVAL = 64


@pytest.mark.parametrize("slice_", sorted(LOOP_SLICES))
def test_loop_run_matches_live_reference(reference, monkeypatch, slice_):
    alg, kw = LOOP_SLICES[slice_]
    want = reference.harness.run(
        alg, reference.harness.ExperimentConfig(**kw), eval_samples=EVAL)
    w0 = to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(0),
                                                  kw["model"]))
    monkeypatch.setattr(tex, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, w0, device))
    got = run(alg, ExperimentConfig(**kw), eval_samples=EVAL, device="cpu")
    n_eval = kw["num_clients"] * max(EVAL // kw["num_clients"], 20)
    assert len(got) == len(want) == kw["rounds"]
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"request_gen_s"}
        assert g["round"] == w["round"]
        assert g["participants"] == w["participants"]
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=1e-4)
        assert abs(g["test_acc"] - w["test_acc"]) <= 1.0 / n_eval + 1e-9
    assert any(g["participants"] for g in got)
    if slice_.startswith("osafl-fcn"):   # the FCN's size leaves stragglers
        assert any(g["participants"] < kw["num_clients"] for g in got)
