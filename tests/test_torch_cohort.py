"""The sparse cohort (``core/cohort.py``) and ``reset_rows`` of the port
against the reference: the participation sample, the slot pool's
admit/evict/readmit sequences, the server's admissions and rounds on the
same inputs, ``cohort_size = U`` bit for bit against the port's dense run
for every algorithm, and C < U runs against live reference runs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro_torch.configs.base import FLConfig
from repro_torch.core.baselines import make_server
from repro_torch.core.buffer_stacked import StackedOnlineBuffer
from repro_torch.core.cohort import (SlotPool, SparseCohortServer,
                                     sample_participants)
from repro_torch.harness import ExperimentConfig, run
from test_torch_oracle import reference, run_both  # noqa: F401

ALGS = ("osafl", "fedavg", "fedprox", "fednova", "afa_cd", "feddisco")
METRICS = ("round", "test_loss", "test_acc", "participants")
SMALL = dict(model="mlp", dataset=2, num_clients=8, rounds=3,
             capacity=(12, 24), arrivals=4, batch=8, seed=5)


@pytest.mark.parametrize("case", [
    dict(U=10, m=4), dict(U=10, m=10),
    dict(U=10, m=4, weights=np.arange(10.0)),
    dict(U=10, m=4, available=np.arange(10) % 3 != 0),
    dict(U=10, m=6, weights=np.linspace(1, 3, 10),
         available=np.arange(10) % 2 == 0),
    dict(U=10, m=3, available=np.zeros(10, bool)),
])
def test_sample_participants_matches_reference(reference, case):
    """Same ids and the same generator state after the draw: the sample is
    part of the host RNG order every later draw rests on."""
    case = dict(case)
    U, m = case.pop("U"), case.pop("m")
    for seed in range(4):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        got = sample_participants(ra, U, m, **case)
        want = reference.cohort.sample_participants(rb, U, m, **case)
        np.testing.assert_array_equal(got, want)
        assert ra.bit_generator.state == rb.bit_generator.state


def test_sample_participants_refuses_what_the_reference_refuses(reference):
    for kw in (dict(weights=np.ones(4)), dict(weights=-np.ones(10))):
        with pytest.raises(ValueError) as want:
            reference.cohort.sample_participants(
                np.random.default_rng(0), 10, 2, **kw)
        with pytest.raises(ValueError) as got:
            sample_participants(np.random.default_rng(0), 10, 2, **kw)
        assert str(got.value) == str(want.value)


def _same_pools(a, b):
    a.check()
    b.check()
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_slot_pool_sequences_match_reference(reference):
    """Random admit/evict/readmit sequences (several users an admission)
    through both pools: every ``AdmitResult``, every freed slot and the
    state after every step equal; a snapshot taken midway restores into a
    fresh pool of either package that goes on in lockstep."""

    @settings(max_examples=25, deadline=None)
    @given(st.integers(1, 5), st.integers(1, 8),
           st.lists(st.integers(0, 999), min_size=1, max_size=40))
    def check(C, extra, ops):
        U = C + extra
        got, want = SlotPool(U, C), reference.cohort.SlotPool(U, C)
        mid = len(ops) // 2
        for i, op in enumerate(ops):
            users = [(op + j * 7) % U for j in range(1 + op % min(C, 3))]
            users = list(dict.fromkeys(users))
            if (op // U) % 3 == 2:
                np.testing.assert_array_equal(got.evict(users),
                                              want.evict(users))
            else:
                g, w = got.admit(users), want.admit(users)
                for field in ("slots", "newly", "evicted"):
                    np.testing.assert_array_equal(getattr(g, field),
                                                  getattr(w, field))
            _same_pools(got, want)
            if i == mid:
                sd = got.state_dict()
                got = SlotPool(U, C)
                got.load_state_dict(sd)
                clone = reference.cohort.SlotPool(U, C)
                clone.load_state_dict(want.state_dict())
                want = clone
                _same_pools(got, want)

    check()


def test_slot_pool_refuses_what_the_reference_refuses(reference):
    pairs = []
    for make, call in (
            (lambda m: m.SlotPool(4, 5), None),
            (lambda m: m.SlotPool(8, 3), lambda p: p.admit([1, 1])),
            (lambda m: m.SlotPool(8, 3), lambda p: p.admit([8])),
            (lambda m: m.SlotPool(8, 3), lambda p: p.admit([0, 1, 2, 3]))):
        msgs = []
        for mod in (reference.cohort, __import__(
                "repro_torch.core.cohort", fromlist=["SlotPool"])):
            with pytest.raises(ValueError) as err:
                pool = make(mod)
                call(pool)
            msgs.append(str(err.value))
        pairs.append(msgs)
    for got, want in pairs:
        assert got == want
    pool = SlotPool(8, 3)
    pool.admit([1])
    pool.user_slot[1] = 2                       # break the bijection
    with pytest.raises(ValueError, match="slot aliasing"):
        pool.check()


def _buffers(reference, caps, depth, S=6):
    got = StackedOnlineBuffer.create(caps, (3,), 5, stage_capacity=S,
                                     depth=depth, device="cpu")
    want = reference.buffer_stacked.StackedOnlineBuffer.create(
        caps, (3,), 5, stage_capacity=S, depth=depth)
    return got, want


def _fill(bufs, rng, C, A=4):
    x = rng.normal(size=(C, A, 3)).astype(np.float32)
    y = rng.integers(0, 5, (C, A))
    n = rng.integers(0, A + 1, C)
    for b in bufs:
        b.stage(x, y, n)
        b.commit()


def test_reset_rows_matches_reference(reference):
    """Slots reassigned mid-stream: capacities, empty windows and staging,
    the storage left in place, then FIFO commits on top; every state array
    equal to the reference's, and the live windows equal."""
    rng = np.random.default_rng(0)
    caps = np.array([3, 5, 4, 6])
    got, want = _buffers(reference, caps, depth=7)
    for _ in range(3):
        _fill((got, want), rng, 4)
    x = rng.normal(size=(4, 2, 3)).astype(np.float32)
    for b in (got, want):                       # staged, not yet committed
        b.stage(x, np.ones((4, 2), np.int64), np.array([2, 1, 0, 2]))
    for b in (got, want):
        b.reset_rows([1, 3], [7, 2])
    for _ in range(3):
        _fill((got, want), rng, 4)
    for k, v in got.state._asdict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(getattr(want.state, k)),
                                      err_msg=k)
    for u in range(4):
        for a, b in zip(got.dataset(u), want.dataset(u)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.label_histograms(),
                               np.asarray(want.label_histograms()))


def test_reset_rows_refuses_what_the_reference_refuses(reference):
    got, want = _buffers(reference, np.array([3, 5]), depth=6)
    for args in (([0, 1], [3]), ([0], [7]), ([1], [0])):
        with pytest.raises(ValueError) as w:
            want.reset_rows(*args)
        with pytest.raises(ValueError) as g:
            got.reset_rows(*args)
        assert str(g.value) == str(w.value)
    state = got.state
    got.reset_rows([], [])                      # nothing to reset
    assert got.state is state


def _params():
    return {"a": torch.arange(6, dtype=torch.float32) / 7.0,
            "b": torch.ones((2, 3))}


def _fl(alg, U, C, **kw):
    return dict(num_clients=U, local_lr=0.1, global_lr=1.0, algorithm=alg,
                engine="stacked", cohort_size=C, **kw)


@pytest.mark.parametrize("alg", ["osafl", "fednova", "feddisco", "fedavg"])
@pytest.mark.parametrize("K", [0, 2])
def test_sparse_server_matches_reference(reference, alg, K):
    """The same admissions and slot-indexed rounds through both servers
    (U=8, C=4; K=2 clusters in front of the two-tier inner server): the
    weights within 1e-6, the slot maps, the per-user tables, the inner
    server's participation and the sticky metadata equal."""
    U, C, N = 8, 4, 12
    params = _params()
    got = make_server(params, FLConfig(**_fl(alg, U, C, num_clusters=K)), U,
                      device="cpu")
    want = reference.baselines.make_server(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        reference.base.FLConfig(**_fl(alg, U, C, num_clusters=K)), U)
    assert isinstance(got, SparseCohortServer)
    rng = np.random.default_rng(1)
    for srv in (got, want):
        srv.admit(srv.initial_residents())
    for t in range(6):
        if K:
            mv = (rng.choice(U, size=2, replace=False),
                  rng.integers(0, K, 2))
            for srv in (got, want):
                srv.apply_cluster_moves(*mv)
            np.testing.assert_array_equal(got.assign, want.assign)
            # at most a block's worth of each cluster
            sel = np.sort(np.concatenate([
                rng.permutation(np.flatnonzero(got.assign == k))[:2]
                for k in range(K)]))
        else:
            sel = np.sort(rng.choice(U, size=3, replace=False))
        rg, rw = got.admit(sel), want.admit(sel)
        np.testing.assert_array_equal(rg.slots, rw.slots)
        d = rng.normal(size=(C, N)).astype(np.float32)
        active = rng.random(C) < 0.7
        meta = {}
        if alg == "fednova":
            meta = dict(sizes=rng.integers(1, 9, C).astype(float),
                        kappas=rng.integers(0, 5, C).astype(float))
        elif alg == "feddisco":
            meta = dict(sizes=rng.integers(1, 9, C).astype(float),
                        hists=rng.dirichlet(np.ones(5), C))
        got.round_stacked(torch.as_tensor(d), active, **meta)
        want.round_stacked(jnp.asarray(d), active, **meta)
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got.cohort, want.cohort)
        for k in want.tables.keys():
            np.testing.assert_allclose(got.tables[k].numpy(),
                                       np.asarray(want.tables[k]),
                                       rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(np.asarray(got.inner.participated),
                                      np.asarray(want.inner.participated))
        if alg != "osafl":
            for k in ("sizes", "kappas", "has_hist"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k))
    if alg == "osafl":
        np.testing.assert_allclose(got.last_scores, want.last_scores,
                                   rtol=1e-6)


def test_admission_resets_the_slot_row_and_carries_the_tables():
    """An evicted user's slot row is reset to ``init_row`` in place (no
    alias of the old row survives, the buffer stays one tensor); a
    readmitted user finds its carried score, stale-score carry and
    participation as last written."""
    srv = make_server(_params(), FLConfig(**_fl("osafl", 6, 2)), 6,
                      device="cpu")
    buf = srv.inner.d_buffer
    srv.admit([0, 1])
    srv.round_stacked(torch.ones((2, 12)), np.array([True, True]))
    carried = {k: srv.tables[k][0].clone() for k in srv.tables.keys()}
    assert bool(carried["participated"])
    res = srv.admit([2, 3])                     # evicts 0 and 1
    assert sorted(res.evicted.tolist()) == [0, 1]
    assert srv.inner.d_buffer is buf
    assert torch.equal(buf, torch.zeros_like(buf))
    res = srv.admit([0])
    s = int(res.slots[0])
    assert bool(srv.inner.participated[s]) and float(
        srv.inner._lam_prev[s]) == float(carried["lam_prev"])
    assert float(srv.inner.last_scores[s]) == float(carried["scores"])


@pytest.mark.parametrize("alg", ALGS)
def test_cohort_size_U_is_bit_exact_against_dense(alg):
    """The anchor: at C = U the pool is the identity, the inner server is
    the dense one and the host RNG is drawn in the dense order."""
    dense = run(alg, ExperimentConfig(**SMALL), eval_samples=32,
                device="cpu")
    sparse = run(alg, ExperimentConfig(**SMALL, cohort_size=8),
                 eval_samples=32, device="cpu")
    for a, b in zip(dense, sparse):
        for k in METRICS:
            assert a[k] == b[k], (alg, k, a, b)


def test_cohort_size_U_is_bit_exact_with_stacked_requests():
    kw = dict(SMALL, request_backend="stacked")
    dense = run("osafl", ExperimentConfig(**kw), eval_samples=32,
                device="cpu")
    sparse = run("osafl", ExperimentConfig(**kw, cohort_size=8),
                 eval_samples=32, device="cpu")
    assert [[r[k] for k in METRICS] for r in dense] == [
        [r[k] for k in METRICS] for r in sparse]


@pytest.mark.parametrize("alg", ALGS)
def test_sparse_run_matches_live_reference(reference, monkeypatch, alg):
    """C < U with participation 0.5: every round's sample, admissions and
    arrivals as the reference draws them (participants exact), the loss
    within 1e-4."""
    got, _ = run_both(reference, monkeypatch, alg,
                      dict(SMALL, cohort_size=4, participation=0.5))
    assert any(r["participants"] for r in got)


def test_sparse_run_with_full_participation_matches_live_reference(
        reference, monkeypatch):
    run_both(reference, monkeypatch, "osafl",
             dict(SMALL, cohort_size=6, participation=1.0))


def test_sparse_server_state_dict_has_the_reference_keys(reference):
    def keys(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2 for k, v in tree.items()
                    for k2 in keys(v, f"{prefix}{k}/")} | {prefix}
        if isinstance(tree, list):
            return {k2 for i, v in enumerate(tree)
                    for k2 in keys(v, f"{prefix}{i}/")} | {prefix}
        return {prefix}

    for alg, K in (("osafl", 0), ("fednova", 0), ("osafl", 2),
                   ("feddisco", 2)):
        fl = _fl(alg, 8, 4, num_clusters=K)
        got = make_server(_params(), FLConfig(**fl), 8, device="cpu")
        want = reference.baselines.make_server(
            {k: jnp.asarray(v.numpy()) for k, v in _params().items()},
            reference.base.FLConfig(**fl), 8)
        assert keys(got.state_dict()) == keys(want.state_dict())


def test_make_server_refuses_a_cohort_off_the_stacked_engine(reference):
    fl = dict(_fl("osafl", 8, 4), engine="loop")
    with pytest.raises(ValueError) as want:
        reference.baselines.make_server(
            {"a": jnp.ones(3)}, reference.base.FLConfig(**fl), 8)
    with pytest.raises(ValueError) as got:
        make_server({"a": torch.ones(3)}, FLConfig(**fl), 8, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="cohort_size must satisfy"):
        make_server({"a": torch.ones(3)},
                    dataclasses.replace(FLConfig(**_fl("osafl", 8, 4)),
                                        cohort_size=9), 8, device="cpu")
