"""The edge-cluster tier (``core/hierarchy.py``) of the port against the
reference: the two-tier round body on the same numpy inputs, one score
reduction per cluster block and one for the aggregates, K=1 bit for bit
against the flat round for every algorithm, K=2 harness runs against live
reference runs, and the cluster pool's moves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.osafl as tosafl
from repro_torch.configs.base import FLConfig
from repro_torch.core.baselines import make_server
from repro_torch.core.hierarchy import (ClusterSlotPool, HIER_SERVERS,
                                        HierStackedOSAFLServer,
                                        contiguous_clusters,
                                        make_hier_round_body,
                                        sample_participants_clustered)
from repro_torch.harness import ExperimentConfig, run
from test_torch_oracle import reference, run_both  # noqa: F401

ALGS = ("osafl", "fedavg", "fedprox", "fednova", "afa_cd", "feddisco")
METRICS = ("round", "test_loss", "test_acc", "participants")
SMALL = dict(model="mlp", dataset=2, num_clients=8, rounds=3,
             capacity=(12, 24), arrivals=4, batch=8, seed=5)


def _inputs(U, N, K, seed):
    rng = np.random.default_rng(seed)
    return dict(
        w=rng.normal(size=N).astype(np.float32),
        buf=rng.normal(size=(U, N)).astype(np.float32),
        part=rng.random(U) < 0.5,
        lam=rng.random(U).astype(np.float32),
        clam=rng.random(K).astype(np.float32),
        d=rng.normal(size=(U, N)).astype(np.float32),
        active=rng.random(U) < 0.6,
        alphas=np.full(U, 1.0 / U, np.float32))


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("fl_kw", [
    {}, dict(stale_scores=True), dict(literal_init_buffer=True),
    dict(score_backend="reference")], ids=["exact", "stale", "literal",
                                            "reference-backend"])
def test_hier_round_body_matches_reference(reference, K, fl_kw):
    U, N = 8, 301
    x = _inputs(U, N, K, seed=K)
    fl = dict(num_clients=U, global_lr=4.0, num_clusters=K, **fl_kw)
    want = reference.hierarchy.make_hier_round_body(
        reference.base.FLConfig(**fl), K)(
        jnp.asarray(x["w"]), jnp.asarray(x["buf"]), jnp.asarray(x["part"]),
        jnp.asarray(x["lam"]), jnp.asarray(x["clam"]), jnp.asarray(x["d"]),
        jnp.asarray(x["active"]), jnp.asarray(x["alphas"]),
        reference.hierarchy.jax.random.PRNGKey(0))
    buf = torch.as_tensor(x["buf"]).clone()
    got = make_hier_round_body(FLConfig(**fl), K)(
        torch.as_tensor(x["w"]), buf, torch.as_tensor(x["part"]),
        torch.as_tensor(x["lam"]), torch.as_tensor(x["clam"]),
        torch.as_tensor(x["d"]), torch.as_tensor(x["active"]),
        torch.as_tensor(x["alphas"]))
    assert got[1] is buf                        # written in place
    for g, w, name in zip(got, want, ("w", "buf", "part", "lam_use", "lam",
                                      "clam_use", "clam")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_hier_round_reduces_each_block_and_the_aggregates(monkeypatch, K):
    """One ``scored_reduce`` call per cluster block, on a contiguous row
    view of the buffer, and one more on the (K, N) aggregates when K > 1;
    none when the scores are sketched."""
    calls = []
    real = tosafl.scored_reduce

    def spy(d, mean):
        calls.append((tuple(d.shape), d.is_contiguous()))
        return real(d, mean)

    monkeypatch.setattr(tosafl, "scored_reduce", spy)
    U, N = 8, 50
    x = _inputs(U, N, K, seed=1)
    args = [torch.as_tensor(x[k]) for k in ("w", "buf", "part", "lam",
                                            "clam", "d", "active",
                                            "alphas")]
    make_hier_round_body(FLConfig(num_clusters=K), K)(*args)
    want = [((U // K, N), True)] * K + ([((K, N), True)] if K > 1 else [])
    assert calls == want
    calls.clear()
    make_hier_round_body(FLConfig(num_clusters=K, score_sketch_dim=16), K)(
        *args, key=np.array([0, 3], np.uint32))
    assert calls == []


@pytest.mark.parametrize("alg", ALGS)
def test_one_cluster_is_bit_exact_against_flat(alg):
    flat = run(alg, ExperimentConfig(**SMALL), eval_samples=32,
               device="cpu")
    one = run(alg, ExperimentConfig(**SMALL, num_clusters=1),
              eval_samples=32, device="cpu")
    for a, b in zip(flat, one):
        for k in METRICS:
            assert a[k] == b[k], (alg, k, a, b)


def test_one_cluster_is_bit_exact_with_a_sparse_cohort():
    kw = dict(SMALL, cohort_size=4, participation=0.5)
    flat = run("osafl", ExperimentConfig(**kw), eval_samples=32,
               device="cpu")
    one = run("osafl", ExperimentConfig(**kw, num_clusters=1),
              eval_samples=32, device="cpu")
    assert [[r[k] for k in METRICS] for r in flat] == [
        [r[k] for k in METRICS] for r in one]


@pytest.mark.parametrize("alg", ["osafl", "fedavg", "fednova", "feddisco"])
def test_two_clusters_match_live_reference(reference, monkeypatch, alg):
    run_both(reference, monkeypatch, alg, dict(SMALL, num_clusters=2))


def test_sparse_clusters_match_live_reference(reference, monkeypatch):
    run_both(reference, monkeypatch, "osafl",
             dict(SMALL, num_clients=16, cohort_size=8, participation=0.5,
                  num_clusters=4))


def test_sample_participants_clustered_matches_reference(reference):
    assign = contiguous_clusters(12, 3)
    np.testing.assert_array_equal(
        assign, reference.hierarchy.contiguous_clusters(12, 3))
    assign[[0, 5]] = [2, 0]                     # a moved map
    for seed in range(3):
        for K, kw in ((3, {}), (1, {}),
                      (3, dict(weights=np.arange(1.0, 13.0))),
                      (3, dict(available=np.arange(12) % 4 != 1))):
            ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
            a = assign if K > 1 else np.zeros(12, np.int32)
            got = sample_participants_clustered(ra, a, K, 5, 3, **kw)
            want = reference.hierarchy.sample_participants_clustered(
                rb, a, K, 5, 3, **kw)
            np.testing.assert_array_equal(got, want)
            assert ra.bit_generator.state == rb.bit_generator.state


def _same(a, b):
    np.testing.assert_array_equal(a.user_slot, b.user_slot)
    np.testing.assert_array_equal(a.slot_user, b.slot_user)
    np.testing.assert_array_equal(a.assign, b.assign)
    sa, sb = a.state_dict(), b.state_dict()
    assert int(sa["num_clusters"]) == int(sb["num_clusters"])
    for pa, pb in zip(sa["pools"], sb["pools"]):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_cluster_pool_reassign_matches_reference(reference):
    """Admissions, moves of residents and non-residents (and of users to
    their own cluster), evictions: the returned movers, the admission
    results and the whole pool equal after every step; a snapshot loads
    into either package."""
    U, C, K = 12, 6, 3
    rng = np.random.default_rng(4)
    got = ClusterSlotPool(U, C, contiguous_clusters(U, K), K)
    want = reference.hierarchy.ClusterSlotPool(
        U, C, reference.hierarchy.contiguous_clusters(U, K), K)
    for step in range(30):
        if step % 3 == 0:
            users = rng.choice(U, size=4, replace=False)
            dest = rng.integers(0, K, 4)
            np.testing.assert_array_equal(got.reassign(users, dest),
                                          want.reassign(users, dest))
        elif step % 3 == 1:
            users = np.flatnonzero(got.assign == rng.integers(0, K))[:2]
            g, w = got.admit(users), want.admit(users)
            for field in ("slots", "newly", "evicted"):
                np.testing.assert_array_equal(getattr(g, field),
                                              getattr(w, field))
        else:
            users = rng.choice(U, size=2, replace=False)
            np.testing.assert_array_equal(got.evict(users),
                                          want.evict(users))
        got.check()
        _same(got, want)
    clone = ClusterSlotPool(U, C, contiguous_clusters(U, K), K)
    clone.load_state_dict(want.state_dict())
    _same(clone, want)
    for args in ((np.array([0, 1]), np.array([1])),
                 (np.array([0]), np.array([K]))):
        with pytest.raises(ValueError) as w:
            want.reassign(*args)
        with pytest.raises(ValueError) as g:
            got.reassign(*args)
        assert str(g.value) == str(w.value)


def test_hier_servers_and_their_refusals(reference):
    p = {"a": torch.arange(8, dtype=torch.float32)}
    for alg in ALGS:
        srv = make_server(p, FLConfig(engine="stacked", algorithm=alg,
                                      num_clusters=2), 4, device="cpu")
        assert isinstance(srv, HierStackedOSAFLServer if alg == "osafl"
                          else HIER_SERVERS[alg])
    for ctor, ref_ctor in (
            (lambda: HierStackedOSAFLServer(p, FLConfig(num_clusters=3), 4,
                                            device="cpu"),
             lambda: reference.hierarchy.HierStackedOSAFLServer(
                 {"a": jnp.arange(8.0)}, reference.base.FLConfig(
                     num_clusters=3), 4)),
            (lambda: contiguous_clusters(10, 3),
             lambda: reference.hierarchy.contiguous_clusters(10, 3))):
        with pytest.raises(ValueError) as w:
            ref_ctor()
        with pytest.raises(ValueError) as g:
            ctor()
        assert str(g.value) == str(w.value)
    fl = dict(engine="loop", num_clusters=2)
    with pytest.raises(ValueError) as w:
        reference.baselines.make_server({"a": jnp.arange(8.0)},
                                        reference.base.FLConfig(**fl), 4)
    with pytest.raises(ValueError) as g:
        make_server(p, FLConfig(**fl), 4, device="cpu")
    assert str(g.value) == str(w.value)
