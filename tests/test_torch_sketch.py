"""Sketched scores (``core/scores.py``): the count-sketch fed the
reference's own threefry signs against the reference, the port's own signs
(Philox counters under ``sketch_key``, drawn on the leaf's device and kept
as int8, so equal to the reference's only in distribution) checked for
what they must be, sketched
scores against exact ones, and the sketched rounds and harness runs
against the reference on shared signs."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import binomtest

import repro_torch.core.osafl as tosafl
import repro_torch.core.scores as tsc
from repro_torch.configs.base import FLConfig
from repro_torch.core.flatten import tree_map
from repro_torch.core.osafl import OSAFLServer, StackedOSAFLServer, seed_key
from repro_torch.harness import ExperimentConfig, run
from repro_torch.models.small import params_from_numpy
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

KEY = seed_key(3)


def _ref_signs(key, i, n, k):
    """The reference's signs of leaf i: Rademacher under fold_in(key, i),
    over the leaf padded to a multiple of k."""
    lk = jax.random.fold_in(jnp.asarray(np.asarray(key, np.uint32)), i)
    return np.array(jax.random.rademacher(lk, (n + (-n) % k,),
                                            jnp.float32))


@pytest.fixture
def reference_signs(monkeypatch):
    """Route the port's sign draws to the reference's threefry signs (for
    sketches of width ``k``, the one the test sets)."""
    k = {"k": None}

    def signs(key, i, n, device="cpu"):
        return torch.as_tensor(_ref_signs(key, i, n, k["k"])).to(device)

    monkeypatch.setattr(tsc, "sketch_signs_int8", signs)
    return k


@pytest.mark.parametrize("U,N,k", [(4, 1000, 16), (3, 1024, 256),
                                   (5, 100, 256), (2, 4099, 64), (1, 7, 3)])
@pytest.mark.parametrize("blocked", [False, True])
def test_sketch_stacked_on_reference_signs_matches_reference(
        reference, monkeypatch, U, N, k, blocked):
    """Whole buckets as a strided view plus the ragged tail, in row blocks
    (``blocked`` makes each block one row), against the reference's padded
    sum, to 1e-6 of the sketch's largest entry (the two sum each bucket in
    another order)."""
    if blocked:
        monkeypatch.setattr(tsc, "_BLOCK_ELEMS", 1)
    x = np.random.default_rng(N).normal(size=(U, N)).astype(np.float32)
    want = np.asarray(reference.scores.sketch_stacked(jnp.asarray(x), KEY,
                                                      k))
    signs = _ref_signs(KEY, 0, N, k)
    got = tsc.sketch_stacked(torch.as_tensor(x), KEY, k, signs=signs)
    assert got.shape == (U, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_sketch_tree_on_reference_signs_matches_reference(reference):
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(4, 5)).astype(np.float32),
            "a": rng.normal(size=13).astype(np.float32),
            "c": {"w": rng.normal(size=(3, 70)).astype(np.float32)}}
    k = 16
    want = np.asarray(reference.scores.sketch_tree(
        jax.tree.map(jnp.asarray, tree), KEY, k))
    leaves = jax.tree.leaves(tree)              # the reference's leaf order
    signs = [_ref_signs(KEY, i, leaf.size, k)
             for i, leaf in enumerate(leaves)]
    got = tsc.sketch_tree(jax.tree.map(torch.as_tensor, tree), KEY, k,
                          signs=signs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_lambda_scores_sketched_matches_reference(reference):
    sk = np.random.default_rng(1).normal(size=(6, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tsc.lambda_scores_sketched(torch.as_tensor(sk)),
        np.asarray(reference.scores.lambda_scores_sketched(jnp.asarray(sk))),
        rtol=1e-6, atol=1e-6)


def test_signs_are_fixed_per_key_and_leaf_and_balanced():
    """+-1 only, float32 from ``sketch_signs`` over the int8 cache; the
    same (key, leaf, n) gives the same signs, twice and after the cache is
    cleared; another leaf or key gives other signs; a two-sided binomial
    test of balance passes at 1e-3 for each of several streams."""
    n = 200_003
    a = tsc.sketch_signs(KEY, 0, n)
    assert a.dtype == torch.float32 and a.shape == (n,)
    assert set(torch.unique(a).tolist()) == {-1.0, 1.0}
    assert torch.equal(a, tsc.sketch_signs(KEY, 0, n))
    assert torch.equal(a, tsc.sketch_signs_int8(KEY, 0, n).float())
    tsc._signs_cached.cache_clear()
    assert torch.equal(a, tsc.sketch_signs(KEY, 0, n))
    assert torch.equal(a, tsc.sketch_signs(np.array(KEY), 0, n))
    streams = [a, tsc.sketch_signs(KEY, 1, n), tsc.sketch_signs(
        seed_key(4), 0, n), tsc.sketch_signs([1, 3], 0, n)]
    for i, s in enumerate(streams):
        if i:
            assert not torch.equal(s, a)
            # independent streams agree on about half the entries
            agree = int((s == a).sum())
            assert binomtest(agree, n, 0.5).pvalue > 1e-3
        plus = int((s > 0).sum())
        assert binomtest(plus, n, 0.5).pvalue > 1e-3


def test_sign_cache_holds_int8_drawn_without_a_host_generator(monkeypatch):
    """The cache holds the signs as int8 +-1, one byte a sign, and no
    ``torch.Generator`` takes part in drawing them (Philox counters);
    a shorter n is the longer stream's prefix."""
    monkeypatch.setattr(torch, "Generator", None)
    tsc._signs_cached.cache_clear()
    s = tsc.sketch_signs_int8(KEY, 2, 1_000)
    assert s.dtype == torch.int8 and s.shape == (1_000,)
    assert set(torch.unique(s).tolist()) == {-1, 1}
    k = np.asarray(KEY, np.uint32)
    assert tsc._signs_cached(int(k[0]), int(k[1]), 2, 1_000, "cpu") is s
    assert torch.equal(tsc.sketch_signs_int8(KEY, 2, 700), s[:700])


def test_signs_do_not_depend_on_the_draw_block(monkeypatch):
    """Drawn in blocks of ``_BLOCK_ELEMS`` signs: a small block (several
    blocks and a ragged last one) gives the same bits."""
    n = 5_000
    tsc._signs_cached.cache_clear()
    want = tsc.sketch_signs_int8(KEY, 1, n).clone()
    monkeypatch.setattr(tsc, "_BLOCK_ELEMS", 384)
    tsc._signs_cached.cache_clear()
    assert torch.equal(tsc.sketch_signs_int8(KEY, 1, n), want)
    tsc._signs_cached.cache_clear()


@pytest.mark.parametrize("N,k", [(1000, 16), (4099, 64), (7, 3)])
def test_bucket_sums_on_int8_signs_equal_the_f32_product(N, k):
    """The int8 signs enter the f32 sums exactly: the same sketch, bit for
    bit, as the same signs in float32."""
    x = torch.as_tensor(np.random.default_rng(N).normal(size=(3, N))
                        .astype(np.float32))
    s8 = tsc.sketch_signs_int8(KEY, 0, N)
    assert torch.equal(tsc._bucket_sums(x, s8, k),
                       tsc._bucket_sums(x, s8.float(), k))


def _tree(i, scale=1.0):
    g = torch.Generator().manual_seed(i)
    return {"a": scale * torch.randn(13, generator=g),
            "b": scale * torch.randn((4, 5), generator=g)}


def test_sketched_scores_approximate_exact():
    """The reference's contract (``tests/test_fl_core.py``), on the port's
    own signs: k >> 1 keeps the scores' structure."""
    updates = [_tree(i, scale=1 + 0.1 * i) for i in range(6)]
    lam = tsc.lambda_scores(updates, chi=1.0)
    sk = torch.stack([tsc.sketch_tree(d, KEY, 64) for d in updates])
    lam_sk = tsc.lambda_scores_sketched(sk, chi=1.0)
    assert np.corrcoef(lam, lam_sk)[0, 1] > 0.5 or np.allclose(
        lam, lam_sk, atol=0.15)


def test_sketched_stacked_scores_track_exact_ones_at_width():
    """At a width where the estimator concentrates (N = 20,000, k = 512),
    the sketched scores of a buffer with one opposed row stay within 0.05
    of the exact ones and rank the opposed row last."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn(20_000, generator=g)
    rows = torch.stack([base + 0.5 * torch.randn(20_000, generator=g)
                        for _ in range(7)] + [-base])
    fl = FLConfig(num_clients=8)
    exact = tosafl.make_scores_fn(fl)(rows, None)
    sk = tosafl.make_scores_fn(dataclasses.replace(
        fl, score_sketch_dim=512))(rows, KEY)
    assert float((exact - sk).abs().max()) < 0.05
    assert int(torch.argmin(sk)) == 7


def _w0(model="mlp"):
    """The port's seeded weights as a tree of numpy arrays."""
    import repro_torch.models.small as small
    return tree_map(lambda t: t.numpy(),
                    small.init_small(0, model, device="cpu"))


@pytest.mark.parametrize("stale", [False, True])
def test_sketched_stacked_round_matches_reference(reference, reference_signs,
                                                  monkeypatch, stale):
    """StackedOSAFLServer with 32-dim sketches and the reference's signs,
    four rounds on the same updates: weights and scores within 1e-6, and
    no ``scored_reduce`` call."""
    calls = []
    monkeypatch.setattr(tosafl, "scored_reduce",
                        lambda *a: calls.append(a))
    reference_signs["k"] = 32
    U = 6
    w0 = _w0()
    fl = dict(num_clients=U, global_lr=4.0, score_sketch_dim=32,
              stale_scores=stale, engine="stacked")
    got = StackedOSAFLServer(tree_map(torch.as_tensor, w0), FLConfig(**fl),
                             U, seed=3, device="cpu")
    want = reference.osafl.StackedOSAFLServer(
        jax.tree.map(jnp.asarray, w0), reference.base.FLConfig(**fl), U,
        seed=3)
    rng = np.random.default_rng(2)
    N = got.codec.n
    for _ in range(4):
        d = rng.normal(size=(U, N)).astype(np.float32) * 0.01
        active = rng.random(U) < 0.7
        got.round_stacked(torch.as_tensor(d), active)
        want.round_stacked(jnp.asarray(d), active)
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.last_scores, want.last_scores,
                                   rtol=1e-6, atol=1e-6)
    assert calls == []


def test_sketched_loop_round_matches_reference(reference, reference_signs):
    """OSAFLServer sketches every slot's tree leaf by leaf (leaf i under
    signs i): scores within 1e-6 of the reference's on its signs."""
    reference_signs["k"] = 16
    U = 4
    w0 = _w0()
    fl = dict(num_clients=U, score_sketch_dim=16, engine="loop")
    got = OSAFLServer(tree_map(torch.as_tensor, w0), FLConfig(**fl), U,
                      seed=3, device="cpu")
    want = reference.osafl.OSAFLServer(jax.tree.map(jnp.asarray, w0),
                                       reference.base.FLConfig(**fl), U,
                                       seed=3)
    rng = np.random.default_rng(5)
    ups_t, ups_j = [], []
    for u in (0, 2, 3):
        d = tree_map(lambda v: rng.normal(size=v.shape).astype(np.float32),
                     w0)
        ups_t.append(reference.osafl.ClientUpdate(
            u, tree_map(torch.as_tensor, d), 3))
        ups_j.append(reference.osafl.ClientUpdate(
            u, jax.tree.map(jnp.asarray, d), 3))
    got.round(ups_t)
    want.round(ups_j)
    np.testing.assert_allclose(got.last_scores, want.last_scores,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, dict(num_clusters=2),
                                dict(cohort_size=4, participation=0.5),
                                dict(engine="loop")],
                         ids=["dense", "clusters", "sparse", "loop"])
def test_sketched_run_matches_reference_on_its_signs(
        reference, reference_signs, monkeypatch, kw):
    """The reference's harness does not pass ``score_sketch_dim`` on; with
    its ``FLConfig`` set to 16-dim sketches and the port's signs routed to
    the reference's, the two runs agree: participants exact, the loss
    within 1e-4. The sketched run differs from the exact one."""
    import repro_torch.harness.experiments as tex
    reference_signs["k"] = 16
    base = dict(model="mlp", dataset=2, num_clients=8, rounds=3,
                capacity=(12, 24), arrivals=4, batch=8, seed=5, **kw)
    monkeypatch.setattr(reference.harness.experiments, "FLConfig",
                        functools.partial(reference.base.FLConfig,
                                          score_sketch_dim=16))
    want = reference.harness.run(
        "osafl", reference.harness.ExperimentConfig(**base), eval_samples=32)
    w0 = to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(5),
                                                  "mlp"))
    monkeypatch.setattr(tex, "init_small", lambda seed, name, device:
                        params_from_numpy(name, w0, device))
    got = run("osafl", ExperimentConfig(**base, score_sketch_dim=16),
              eval_samples=32, device="cpu")
    exact = run("osafl", ExperimentConfig(**base), eval_samples=32,
                device="cpu")
    for g, w in zip(got, want):
        assert g["participants"] == w["participants"]
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=1e-4)
    assert [h["test_loss"] for h in got] != [h["test_loss"] for h in exact]


def test_negative_sketch_width_is_refused():
    with pytest.raises(ValueError, match="score_sketch_dim"):
        OSAFLServer(tree_map(torch.as_tensor, _w0()),
                    FLConfig(score_sketch_dim=-2), 2, device="cpu")
