"""The port's stacked servers against the reference on identical inputs:
the OSAFL round with both score backends, and the five baselines."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.baselines import SERVERS, STACKED_SERVERS, make_server
from repro_torch.core.osafl import (OSAFLServer, StackedOSAFLServer,
                                    make_stacked_round_body)
from repro_torch.models import small
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401


def _round_inputs(U=6, N=300, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(w=rng.normal(size=N).astype(f32),
                buf=rng.normal(size=(U, N)).astype(f32),
                part_prev=np.array([1, 0, 1, 0, 0, 1], bool)[:U],
                lam_prev=rng.uniform(0.2, 1.0, size=U).astype(f32),
                d_new=rng.normal(size=(U, N)).astype(f32),
                active=np.array([0, 1, 1, 0, 0, 0], bool)[:U],
                alphas=np.full(U, 1.0 / U, f32))


@pytest.mark.parametrize("score_backend", ["kernel", "reference"])
@pytest.mark.parametrize("literal", [False, True])
@pytest.mark.parametrize("stale", [False, True])
def test_round_body_matches_reference(reference, score_backend, literal,
                                      stale):
    kw = dict(local_lr=0.1, global_lr=16.0, chi=1.0, engine="stacked",
              score_backend=score_backend, literal_init_buffer=literal,
              stale_scores=stale)
    inp = _round_inputs()
    jout = reference.osafl.make_stacked_round_body(
        reference.base.FLConfig(**kw))(
        *[jnp.asarray(v) for v in inp.values()], jax.random.PRNGKey(0))
    tout = make_stacked_round_body(FLConfig(**kw))(
        *[torch.from_numpy(v.copy()) for v in inp.values()])
    names = ("w", "buf", "part", "lam_use", "lam")
    for name, a, e in zip(names, tout, jout):
        a, e = a.numpy(), np.asarray(e)
        if name in ("buf", "part"):
            np.testing.assert_array_equal(a, e, err_msg=name)
        else:       # f32 reductions in another order
            np.testing.assert_allclose(a, e, rtol=2e-5, atol=2e-6,
                                       err_msg=name)


def test_stacked_server_rounds_match_reference(reference):
    U, name = 5, "mlp"
    w0 = to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(4),
                                                  name))
    fl = dict(num_clients=U, local_lr=0.1, global_lr=16.0, engine="stacked")
    jsrv = reference.osafl.StackedOSAFLServer(
        jax.tree.map(jnp.asarray, w0), reference.base.FLConfig(**fl), U)
    tsrv = StackedOSAFLServer(small.params_from_numpy(name, w0, "cpu"),
                              FLConfig(**fl), U, device="cpu")
    rng = np.random.default_rng(5)
    N = tsrv.codec.n
    for t in range(3):
        d_new = (0.01 * rng.normal(size=(U, N))).astype(np.float32)
        active = rng.uniform(size=U) < 0.6
        jsrv.round_stacked(jnp.asarray(d_new), active)
        tsrv.round_stacked(torch.from_numpy(d_new), active)
        np.testing.assert_allclose(tsrv.w.numpy(), np.asarray(jsrv.w),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tsrv.last_scores, jsrv.last_scores,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tsrv.participated.numpy(),
                                      np.asarray(jsrv.participated))
    np.testing.assert_array_equal(tsrv.d_buffer.numpy(),
                                  np.asarray(jsrv.d_buffer))
    flat = small.params_from_numpy(name, w0, "cpu")
    assert set(tsrv.params) == set(flat)


@pytest.mark.parametrize("alg", sorted(STACKED_SERVERS))
@pytest.mark.parametrize("literal", [False, True])
def test_stacked_baseline_rounds_match_reference(reference, alg, literal):
    """Four rounds of random partial participation with sticky sizes,
    kappas and (FedDisco) label histograms; atol 1e-5, the reference's own
    loop-against-stacked bound."""
    U, name = 6, "mlp"
    w0 = to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(7),
                                                  name))
    fl = dict(num_clients=U, local_lr=0.1, global_lr=4.0, engine="stacked",
              algorithm=alg, literal_init_buffer=literal)
    jsrv = reference.baselines.STACKED_SERVERS[alg](
        jax.tree.map(jnp.asarray, w0), reference.base.FLConfig(**fl), U)
    tsrv = make_server(small.params_from_numpy(name, w0, "cpu"),
                       FLConfig(**fl), U, device="cpu")
    assert type(tsrv) is STACKED_SERVERS[alg]
    rng = np.random.default_rng(8)
    N = tsrv.codec.n
    for t in range(4):
        d_new = rng.normal(size=(U, N)).astype(np.float32)
        if tsrv.buffers_hold_weights:
            d_new = np.asarray(jsrv.w) + 0.01 * d_new
        active = rng.uniform(size=U) < 0.5
        meta = {}
        if alg in ("fednova", "feddisco"):
            meta["sizes"] = rng.integers(5, 50, size=U)
        if alg == "fednova":
            meta["kappas"] = rng.integers(0, 6, size=U)
        if alg == "feddisco":
            meta["hists"] = rng.dirichlet(np.ones(10), size=U)
        jsrv.round_stacked(jnp.asarray(d_new), active, **meta)
        tsrv.round_stacked(torch.from_numpy(d_new), active, **meta)
        np.testing.assert_allclose(tsrv.w.numpy(), np.asarray(jsrv.w),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tsrv.buffer.numpy(),
                                      np.asarray(jsrv.buffer))
        np.testing.assert_array_equal(tsrv.participated, jsrv.participated)
        for key in ("sizes", "kappas", "hists", "has_hist"):
            np.testing.assert_array_equal(getattr(tsrv, key),
                                          getattr(jsrv, key), err_msg=key)
    assert set(tsrv.params) == set(w0)


@pytest.mark.parametrize("alg", ["osafl"] + sorted(STACKED_SERVERS))
def test_make_server_returns_each_stacked_server(alg):
    p = small.init_small(0, "mlp", device="cpu")
    srv = make_server(p, FLConfig(engine="stacked", algorithm=alg), 4,
                      device="cpu")
    want = StackedOSAFLServer if alg == "osafl" else STACKED_SERVERS[alg]
    assert type(srv) is want
    assert srv.w.shape == (srv.codec.n,) and srv.w.dtype == torch.float32


@pytest.mark.parametrize("change", [
    dict(engine="pod"), dict(cohort_size=4), dict(num_clusters=1),
    dict(engine="loop", score_sketch_dim=64),
])
def test_make_server_rejects_what_is_not_ported(change):
    fl = dataclasses.replace(FLConfig(engine="stacked"), **change)
    p = small.init_small(0, "mlp", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        make_server(p, fl, 4, device="cpu")
    assert isinstance(make_server(p, FLConfig(engine="stacked"), 4,
                                  device="cpu"), StackedOSAFLServer)


@pytest.mark.parametrize("alg", ["osafl"] + sorted(SERVERS))
def test_make_server_returns_each_loop_server(alg):
    p = small.init_small(0, "mlp", device="cpu")
    srv = make_server(p, FLConfig(engine="loop", algorithm=alg), 4,
                      device="cpu")
    assert type(srv) is (OSAFLServer if alg == "osafl" else SERVERS[alg])
    assert len(srv.d_buffer if alg == "osafl" else srv.buffer) == 4
    assert set(srv.params) == set(p)


def test_sketched_scores_are_refused():
    with pytest.raises(NotImplementedError, match="threefry"):
        make_stacked_round_body(FLConfig(score_sketch_dim=64))
