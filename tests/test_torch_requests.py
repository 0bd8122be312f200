"""The port's batched Gumbel-max request model
(``repro_torch/data/video_caching_stacked.py``) against the reference.

  * Logic: fed the reference's own noise (drawn from its threefry key as
    the reference's ``_draw_block`` draws it), the port's ``_draw_block``
    gives the reference's blocks and next state bit for bit: Dataset-1 and
    Dataset-2, cold and warm cohorts, topk 1 and 2, zero counts.
  * Distribution: the chi-squared cases of ``tests/test_request_stacked.py``
    on the port's own generator (first request, exploit top-K, explore,
    branch frequency at the eps bounds, chain statistics against the
    per-user oracle).
  * State: a mid-stream snapshot round trip continues bit for bit.
  * Harness: ``request_backend="stacked"`` with the noise replaying the
    reference's key lineage matches a live reference run (rtol 1e-4 on
    ``test_loss``, participants exact).

The chi-squared thresholds (p > 1e-3) are the reference's; every case is
fixed-seed.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import repro_torch.harness.experiments as tex
from repro_torch import checkpoint
from repro_torch.data import video_caching_stacked as tvs
from repro_torch.data.video_caching import (F_FILES, FILES_PER_GENRE,
                                            G_GENRES, SEQ_LEN, Catalog,
                                            RequestStream, UserModel,
                                            dataset1_sample, make_population,
                                            zipf_mandelbrot_pmf)
from repro_torch.data.video_caching_stacked import (StackedRequestStream,
                                                    StreamState, _draw_block)
from repro_torch.harness import ExperimentConfig, run
from repro_torch.models.small import params_from_numpy
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401


def _reference_noise(key, L, U, topk):
    """The reference's four bulk draws of one block, from its state key
    (``repro/data/video_caching_stacked.py:121-128``): the next key and the
    noise as CPU tensors."""
    key, k_br, k_genre, k_rank, k_top = jax.random.split(key, 5)
    noise = (jax.random.uniform(k_br, (L, U), jnp.float32),
             jax.random.gumbel(k_genre, (L, U, G_GENRES), jnp.float32),
             jax.random.gumbel(k_rank, (L, U, FILES_PER_GENRE), jnp.float32),
             jax.random.gumbel(k_top, (L, U, topk), jnp.float32))
    return key, tuple(torch.from_numpy(np.array(n)) for n in noise)


def _port_state(jstate) -> StreamState:
    def get(k, dtype):
        return torch.as_tensor(np.array(getattr(jstate, k)), dtype=dtype)
    return StreamState(genre=get("genre", torch.int64),
                       file=get("file", torch.int64),
                       has_last=get("has_last", torch.bool),
                       hist=get("hist", torch.int64),
                       hist_len=get("hist_len", torch.int64))


@pytest.mark.parametrize("dataset", [1, 2])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("topk", [1, 2])
def test_draw_block_is_bit_identical_on_the_reference_noise(
        reference, dataset, warm, topk):
    jvs = reference.video_caching_stacked
    U, width = 12, 5
    jcat, jstreams = reference.video_caching.make_population(4, U, topk=topk)
    cat, streams = make_population(4, U, topk=topk)
    jst = jvs.StackedRequestStream.from_streams(jcat, jstreams, seed=8)
    tst = StackedRequestStream.from_streams(cat, streams, seed=8,
                                            device="cpu")
    rng = np.random.default_rng(topk)
    if warm:                    # advance the reference cohort past warm-up
        for _ in range(3):
            jst.draw(rng.integers(0, width + 1, U), dataset, width)
    state = _port_state(jst.state)
    for k in ("genre", "file", "has_last", "hist", "hist_len"):
        if not warm:            # the cold cohorts start from the same state
            np.testing.assert_array_equal(getattr(tst.state, k).numpy(),
                                          np.asarray(getattr(jst.state, k)))
    for counts in (rng.integers(0, width + 1, U), np.zeros(U, int),
                   np.full(U, width)):
        warmup = jvs.warmup_deficit(jst.state, dataset)
        assert warmup == tvs.warmup_deficit(state, dataset)
        assert warm or warmup > 0
        L = width + warmup
        _, noise = _reference_noise(jst.state.key, L, U, jst.topk)
        jnew, jx, jy = jvs._draw_block(
            jst.consts, jst.state, jnp.asarray(counts, jnp.int32), width,
            warmup, dataset, jst.topk)
        state, tx, ty = _draw_block(
            tst.consts, state, torch.as_tensor(counts), width, warmup,
            dataset, tst.topk, noise)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert tx.dtype == (torch.float32 if dataset == 1 else torch.int64)
        for k in ("genre", "file", "has_last", "hist", "hist_len"):
            np.testing.assert_array_equal(getattr(state, k).numpy(),
                                          np.asarray(getattr(jnew, k)),
                                          err_msg=k)
        jst.state = jnew


def test_stream_constants_match_reference(reference):
    jcat, jstreams = reference.video_caching.make_population(2, 5, topk=3)
    cat, streams = make_population(2, 5, topk=3)
    jst = reference.video_caching_stacked.StackedRequestStream.from_streams(
        jcat, jstreams, seed=1)
    tst = StackedRequestStream.from_streams(cat, streams, seed=1,
                                            device="cpu")
    assert tst.topk == jst.topk
    for k in tvs.StreamConsts._fields:
        np.testing.assert_allclose(getattr(tst.consts, k).numpy(),
                                   np.asarray(getattr(jst.consts, k)),
                                   rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# distribution level, on the port's own generator
# ---------------------------------------------------------------------------

def _chi2_ok(f_obs, f_exp, alpha=1e-3) -> bool:
    f_obs, f_exp = np.asarray(f_obs, float), np.asarray(f_exp, float)
    f_exp = f_exp * (f_obs.sum() / f_exp.sum())
    stat = float(np.sum((f_obs - f_exp) ** 2 / f_exp))
    return stats.chi2.sf(stat, len(f_obs) - 1) > alpha


def _assert_pmf_match(pmf, labels, n):
    """Chi-squared of observed label counts against an analytic pmf, cells
    with expectation under 5 lumped."""
    obs = np.bincount(labels, minlength=F_FILES).astype(float)
    exp = pmf * n
    assert obs[exp == 0].sum() == 0, "draw outside the branch support"
    big = exp >= 5
    f_obs = np.concatenate([obs[big], [obs[~big].sum()]])
    f_exp = np.concatenate([exp[big], [exp[~big].sum()]])
    keep = f_exp > 0
    assert _chi2_ok(f_obs[keep], f_exp[keep])


_RNG = np.random.default_rng(0)
CAT = Catalog.create(_RNG)
USER = UserModel.create(_RNG, topk=3)          # K=3: the exploit draw is random
N_COHORT = 6000


def _clone_cohort(U, genre, file, eps=None, topk=None):
    """U streams of one user pinned at one Markov state, Dataset-2 windows
    warm (the per-branch pmfs condition on exactly this)."""
    streams = []
    for u in range(U):
        um = UserModel(genre_pref=USER.genre_pref.copy(),
                       eps=USER.eps if eps is None else eps,
                       p_ac=USER.p_ac,
                       topk=USER.topk if topk is None else topk)
        um._genre, um._file = genre, file
        s = RequestStream(CAT, um, np.random.default_rng(u))
        s._history = [0] * SEQ_LEN
        streams.append(s)
    return streams


def _one_draw(streams, seed):
    """One request per user through the port's sampler: (U,) labels."""
    stk = StackedRequestStream.from_streams(CAT, streams, seed=seed,
                                            device="cpu")
    _, ys, _ = stk.draw_dataset2(np.ones(len(streams), int), 1)
    return ys[:, 0].numpy()


def test_first_request_pmf():
    z = zipf_mandelbrot_pmf(FILES_PER_GENRE)
    pmf = np.zeros(F_FILES)
    for g in range(G_GENRES):
        for r in range(FILES_PER_GENRE):
            pmf[g * FILES_PER_GENRE + CAT.popularity[g][r]] += \
                USER.genre_pref[g] * z[r]
    _assert_pmf_match(pmf, _one_draw(_clone_cohort(N_COHORT, -1, -1), 7),
                      N_COHORT)


def test_exploit_pmf_topk():
    g0, f0 = 2, 47
    lo = g0 * FILES_PER_GENRE
    members = np.arange(lo, lo + FILES_PER_GENRE)
    members = members[members != f0]
    sims = CAT.cos_sim[f0, members]
    probs = np.exp(sims - sims.max())
    probs /= probs.sum()
    order = np.argsort(-probs)[:USER.topk]
    pmf = np.zeros(F_FILES)
    pmf[members[order]] = probs[order] / probs[order].sum()
    labels = _one_draw(_clone_cohort(N_COHORT, g0, f0, eps=1.0), 18)
    _assert_pmf_match(pmf, labels, N_COHORT)


def test_exploit_topk1_is_argmax():
    streams = _clone_cohort(256, 1, 33, eps=1.0, topk=1)
    labels = _one_draw(streams, 4)
    expect = streams[0].user.next_request(np.random.default_rng(0), CAT)
    assert np.all(labels == expect)


def test_explore_pmf():
    g0, f0 = 2, 47
    z = zipf_mandelbrot_pmf(FILES_PER_GENRE)
    others = [g for g in range(G_GENRES) if g != g0]
    pref = USER.genre_pref[others] / USER.genre_pref[others].sum()
    pmf = np.zeros(F_FILES)
    for gg, pg in zip(others, pref):
        for r in range(FILES_PER_GENRE):
            pmf[gg * FILES_PER_GENRE + CAT.popularity[gg][r]] += pg * z[r]
    labels = _one_draw(_clone_cohort(N_COHORT, g0, f0, eps=0.0), 9)
    lo = g0 * FILES_PER_GENRE
    assert np.all((labels < lo) | (labels >= lo + FILES_PER_GENRE))
    _assert_pmf_match(pmf, labels, N_COHORT)


@pytest.mark.parametrize("eps", [0.4, 0.9])
def test_branch_frequency_at_eps_bounds(eps):
    g0, f0 = 2, 47
    labels = _one_draw(_clone_cohort(N_COHORT, g0, f0, eps=eps), 10)
    stay = int((labels // FILES_PER_GENRE == g0).sum())
    assert _chi2_ok([stay, N_COHORT - stay],
                    [eps * N_COHORT, (1 - eps) * N_COHORT])


def test_chain_level_statistics_match_oracle():
    """Whole chains against the per-user oracle on per-chain statistics
    (iid across chains): same-genre transitions and distinct files
    (Mann-Whitney), and the first labels (chi-squared two-sample)."""
    C, n = 400, 12

    def fresh(u):
        return RequestStream(CAT, UserModel(
            genre_pref=USER.genre_pref.copy(), eps=USER.eps, p_ac=USER.p_ac,
            topk=USER.topk), np.random.default_rng(5000 + u))

    scalar = np.stack([fresh(u).draw_dataset2(n)[1] for u in range(C)])
    stk = StackedRequestStream.from_streams(
        CAT, [fresh(u) for u in range(C)], seed=42, device="cpu")
    stacked = stk.draw_dataset2(np.full(C, n), n)[1].numpy()

    def same_genre(y):
        g = y // FILES_PER_GENRE
        return (g[:, 1:] == g[:, :-1]).sum(1)

    def distinct(y):
        return np.array([len(set(row)) for row in y])

    assert stats.mannwhitneyu(same_genre(scalar),
                              same_genre(stacked)).pvalue > 1e-3
    assert stats.mannwhitneyu(distinct(scalar),
                              distinct(stacked)).pvalue > 1e-3
    a = np.bincount(scalar[:, 0], minlength=F_FILES)
    b = np.bincount(stacked[:, 0], minlength=F_FILES)
    big = (a + b) >= 8
    tbl = np.stack([np.concatenate([a[big], [a[~big].sum()]]),
                    np.concatenate([b[big], [b[~big].sum()]])]).astype(float)
    tbl = tbl[:, tbl.sum(0) > 0]
    assert stats.chi2_contingency(tbl).pvalue > 1e-3


# ---------------------------------------------------------------------------
# structure: layouts, windows, features, frozen users, seeds
# ---------------------------------------------------------------------------

def test_padded_layout_windows_and_features():
    cat, streams = make_population(3, 6)
    stk = StackedRequestStream.from_streams(cat, streams, seed=5,
                                            device="cpu")
    counts = np.array([3, 0, 2, 5, 5, 1])
    xs1, ys1, c = stk.draw_dataset1(counts, 5)
    assert xs1.shape == (6, 5, 3168) and ys1.shape == (6, 5)
    assert np.array_equal(c, counts)
    for u, n in enumerate(counts):              # rows past counts are padding
        assert torch.all(ys1[u, n:] == 0) and torch.all(xs1[u, n:] == 0)
        for i in range(n - 1):                  # x_{i+1} = sample(y_i)
            want = dataset1_sample(cat, streams[u].user, int(ys1[u, i]))
            np.testing.assert_allclose(xs1[u, i + 1].numpy(), want,
                                       rtol=1e-6, atol=1e-6)
    stk.draw_dataset2(np.full(6, 4), 4)         # consume the warm-up
    x, y, _ = stk.draw_dataset2(np.full(6, 6), 6)
    for u in range(6):
        for i in range(5):
            assert list(x[u, i + 1]) == list(x[u, i][1:]) + [y[u, i]]
    with pytest.raises(ValueError, match="pad width"):
        stk.draw_dataset2(np.full(6, 6), 5)
    with pytest.raises(ValueError, match="width"):
        stk.draw_dataset2(counts, 0)
    with pytest.raises(ValueError, match="counts shape"):
        stk.draw_dataset2(np.ones(5, int), 5)


def test_zero_counts_freeze_markov_state_and_seeds_differ():
    cat, streams = make_population(4, 6)
    stk = StackedRequestStream.from_streams(cat, streams, seed=6,
                                            device="cpu")
    stk.draw_dataset2(np.full(6, 3), 3)
    before = stk.state_dict()
    stk.draw_dataset2(np.zeros(6, int), 3)
    after = stk.state_dict()
    for k in before:
        if k != "key":                          # the generator advances
            np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    assert not torch.equal(before["key"], after["key"])
    other = StackedRequestStream.from_streams(cat, streams, seed=7,
                                              device="cpu")
    assert not torch.equal(other.generator.get_state(),
                           tvs.stream_generator(6).get_state())


@pytest.mark.parametrize("dataset", [1, 2])
def test_stream_snapshot_roundtrip(dataset):
    """snapshot -> save_run_state -> load -> restore onto a differently
    seeded stream: the two continue in bit-exact lockstep."""
    cat, streams = make_population(9, 4)
    s1 = StackedRequestStream.from_streams(cat, streams, seed=3,
                                           device="cpu")
    for n in (1, 4, 2):
        s1.draw(np.array([(n + u) % 5 for u in range(4)]), dataset, 4)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_run_state(d + "/s", {"stream": s1.state_dict()})
        loaded = checkpoint.load_run_state(d + "/s")
    assert loaded["stream"]["key"].dtype == np.uint8
    assert loaded["stream"]["hist"].dtype == np.int32
    s2 = StackedRequestStream.from_streams(cat, streams, seed=77,
                                           device="cpu")
    s2.load_state_dict(loaded["stream"])
    assert not checkpoint.diff_snapshots(s1.state_dict(), s2.state_dict(),
                                         skip=())
    counts = np.array([(3 + u) % 5 for u in range(4)])
    for a, b in zip(s1.draw(counts, dataset, 4)[:2],
                    s2.draw(counts, dataset, 4)[:2]):
        assert torch.equal(a, b)
    assert not checkpoint.diff_snapshots(s1.state_dict(), s2.state_dict(),
                                         skip=())


# ---------------------------------------------------------------------------
# the harness on replayed reference noise against a live reference run
# ---------------------------------------------------------------------------

def _replay_reference_noise(self, L):
    """``StackedRequestStream._noise`` replaced: the reference's key lineage
    (``fold_in(PRNGKey(seed), 0x726571)``, split once a block)."""
    key = getattr(self, "_jax_key", None)
    if key is None:
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed),
                                 tvs.NOISE_TAG)
    self._jax_key, noise = _reference_noise(key, L, self.num_users,
                                            self.topk)
    return noise


@pytest.mark.parametrize("kw", [
    dict(model="mlp", dataset=2, num_clients=8, rounds=3, capacity=(16, 32),
         seed=3),
    dict(model="fcn", dataset=1, num_clients=4, rounds=2, capacity=(16, 32),
         topk=2),
], ids=["mlp-d2-u8", "fcn-d1-u4"])
def test_stacked_requests_run_matches_live_reference(reference, monkeypatch,
                                                     kw):
    kw = dict(kw, request_backend="stacked")
    want = reference.harness.run(
        "osafl", reference.harness.ExperimentConfig(**kw), eval_samples=64)
    w0 = to_numpy_tree(reference.small.init_small(
        jax.random.PRNGKey(kw.get("seed", 0)), kw["model"]))
    monkeypatch.setattr(tex, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, w0, device))
    monkeypatch.setattr(StackedRequestStream, "_noise",
                        _replay_reference_noise)
    got = run("osafl", ExperimentConfig(**kw), eval_samples=64,
              device="cpu")
    assert len(got) == len(want) == kw["rounds"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["participants"] == w["participants"]
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=1e-4)
    assert any(g["participants"] for g in got)
