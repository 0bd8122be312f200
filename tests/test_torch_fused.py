"""The port's fused round (``repro_torch/core/round_fused.py``) on the CPU.

  * Replay parity: the dispatch round's components (stacked request
    stream, FIFO stage and commit, the batched solve, vmapped local SGD,
    the scored server round) driven with the fused engine's own draws are
    bit for bit the fused x64 segment: losses, participants, weights,
    contribution buffer, FIFO and stream state.
  * The f32 solve against x64 (the reference's tolerance), segment splits
    4 = 2+2 = 1+1+1+1 and a harness resume, bit for bit.
  * The fixed-shape forms a CUDA graph holds against the dispatch forms
    they stand for; a segment makes no host copy, host read or
    data-dependent shape.
  * The counter-based draws: Philox's published answers, balance, the
    transforms' moments, determinism and independent streams.
  * The slice against the JAX package: fed the reference's own draws
    (its round keys' uniforms and normals, its request stream's key
    lineage), a port fused run matches a live reference ``FusedEngine``
    run (rtol 1e-4 on ``test_loss``, participants exact).

The configuration is the reference's ``tests/test_round_fused.py:38-42``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import repro_torch.harness.experiments as tex
from repro_torch.configs.base import FLConfig
from repro_torch.core import round_fused as rf
from repro_torch.core.buffer_stacked import (StackedOnlineBuffer,
                                             commit_in_place, stage_in_place)
from repro_torch.core.client import make_vmapped_local_train
from repro_torch.core.osafl import write_back, write_back_masked
from repro_torch.core.resource import NetworkConfig, pathloss_linear
from repro_torch.core.resource_stacked import (ChannelBatch,
                                               ResourceSolveError,
                                               make_solver_core,
                                               optimize_clients_batched)
from repro_torch.data.video_caching import (FILES_PER_GENRE, G_GENRES,
                                            make_population)
from repro_torch.data.video_caching_stacked import StackedRequestStream
from repro_torch.harness import (ExperimentConfig, build_fused_engine,
                                 checkpoint_path, run)
from repro_torch.models.small import params_from_numpy, small_loss
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

R = 4
XC = ExperimentConfig(model="mlp", dataset=2, num_clients=8, rounds=R,
                      capacity=(12, 24), arrivals=4, batch=8, seed=5,
                      request_backend="stacked", round_backend="fused",
                      resource_backend="x64", rounds_per_dispatch=R)
F32 = dataclasses.replace(XC, resource_backend="f32")


def _engine(xc=XC, eval_samples=400):
    eng, s = build_fused_engine("osafl", xc, eval_samples, device="cpu")
    return eng, s, eng.init_carry(s.server, s.sbuf, s.rstream, 0)


@pytest.fixture(scope="module")
def x64_run():
    """One R-round fused segment on the x64 solve: (engine, carry, outs)."""
    eng, _, carry = _engine()
    carry, outs = eng.run_segment(carry, R)
    return eng, carry, outs


# ---------------------------------------------------------------------------
# replay parity, backends, segments, resume
# ---------------------------------------------------------------------------

def test_replay_bit_parity_x64(x64_run):
    """The dispatch round's components fed the fused engine's draws give
    the fused x64 segment bit for bit."""
    _, carry, outs = x64_run
    eng, s = build_fused_engine("osafl", XC, device="cpu")
    local_step = make_vmapped_local_train(s.grad_fn, s.fl.local_lr,
                                          s.fl.kappa_max)
    xi = pathloss_linear(s.sysb.distance)
    losses, accs, parts = [], [], []
    for t in range(R):
        dr = rf.round_draws(eng.spec, torch.tensor(t))
        counts = rf.draw_counts(dr.arrivals, eng.p_ac).numpy()
        s.rstream._noise = lambda L, noise=dr.noise: noise
        s.sbuf.stage(*s.rstream.draw(counts, XC.dataset, XC.arrivals))
        s.sbuf.commit()
        gamma = 10.0 ** (rf.draw_shadowing_db(dr.normals).double() / 10.0)
        dec = optimize_clients_batched(
            s.net, s.sysb, ChannelBatch(xi=xi, gamma=gamma.numpy()),
            s.n_params, backend="x64", device="cpu")
        kappas, active = dec.kappa, dec.kappa >= 1
        st = s.sbuf.state
        slots = rf.draw_slots(dr.slots, st.size, st.head, st.cap).numpy()
        d, _ = local_step(s.server.params, s.sbuf.gather(slots),
                          torch.as_tensor(kappas))
        s.server.round_stacked(s.codec.flatten_stacked(d), active)
        loss, m = small_loss(s.server.params, s.test_batch, s.model)
        losses.append(float(loss))
        accs.append(float(m["accuracy"]))
        parts.append(int(active.sum()))
    assert outs["test_loss"].tolist() == losses
    assert outs["test_acc"].tolist() == accs
    assert outs["participants"].tolist() == parts
    assert torch.equal(carry.w, s.server.w)
    assert torch.equal(carry.d_buffer, s.server.d_buffer)
    assert torch.equal(carry.participated, s.server.participated)
    for k in carry.buf._fields:
        assert torch.equal(getattr(carry.buf, k),
                           getattr(s.sbuf.state, k)), k
    for k in carry.stream._fields:
        assert torch.equal(getattr(carry.stream, k),
                           getattr(s.rstream.state, k)), k
    assert np.array_equal(outs["lam_use"][-1].numpy(),
                          np.asarray(s.server.last_scores, np.float32))


def test_f32_backend_matches_x64(x64_run):
    """The reference's tolerance: the same participants, ``test_loss``
    within 1e-5 relative, the weights within 1e-4."""
    _, carry, outs = x64_run
    eng, _, c32 = _engine(F32)
    c32, o32 = eng.run_segment(c32, R)
    assert o32["participants"].tolist() == outs["participants"].tolist()
    np.testing.assert_allclose(o32["test_loss"], outs["test_loss"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c32.w, carry.w, rtol=1e-4, atol=1e-5)
    assert not o32["bad_solve"].any()


@pytest.mark.parametrize("split", [(2, 2), (1, 1, 1, 1)],
                         ids=["2+2", "1+1+1+1"])
def test_segment_invariance(split):
    eng, _, carry = _engine(F32)
    carry, full = eng.run_segment(carry, R)
    eng2, _, c2 = _engine(F32)
    parts = [eng2.run_segment(c2, k)[1] for k in split]
    for k in ("test_loss", "test_acc", "participants", "lam_use",
              "bad_solve"):
        assert torch.equal(full[k], torch.cat([p[k] for p in parts])), k
    for a, b in ((carry.w, c2.w), (carry.t, c2.t),
                 (carry.d_buffer, c2.d_buffer), (carry.buf.x, c2.buf.x),
                 (carry.stream.hist, c2.stream.hist)):
        assert torch.equal(a, b)
    assert int(c2.t) == R


def test_harness_fused_checkpoint_resume(tmp_path):
    """Segments cut at checkpoint boundaries, a resume from round 2 and the
    direct engine segment agree bit for bit."""
    da, db = tmp_path / "a", tmp_path / "b"
    ha = run("osafl", F32, eval_samples=64, device="cpu", save_every_k=R,
             checkpoint_dir=da)
    run("osafl", dataclasses.replace(F32, rounds=2), eval_samples=64,
        device="cpu", save_every_k=2, checkpoint_dir=db)
    hb = run("osafl", F32, eval_samples=64, device="cpu", save_every_k=2,
             checkpoint_dir=db, resume_from=checkpoint_path(db, 2))
    keys = ("round", "test_loss", "test_acc", "participants")
    assert [[h[k] for k in keys] for h in ha] == \
        [[h[k] for k in keys] for h in hb]
    assert all(h["request_gen_s"] == 0.0 for h in ha)
    eng, _, carry = _engine(F32, eval_samples=64)
    _, outs = eng.run_segment(carry, R)
    assert [h["test_loss"] for h in ha] == outs["test_loss"].tolist()


def test_fused_snapshot_resumes_only_a_fused_run(tmp_path):
    run("osafl", dataclasses.replace(F32, rounds=2), eval_samples=64,
        device="cpu", save_every_k=2, checkpoint_dir=tmp_path)
    with pytest.raises(tex.CheckpointError, match="round_backend"):
        run("osafl", dataclasses.replace(F32, round_backend="dispatch"),
            eval_samples=64, device="cpu",
            resume_from=checkpoint_path(tmp_path, 2))


# ---------------------------------------------------------------------------
# refusals and errors
# ---------------------------------------------------------------------------

def test_check_outputs_raises_on_bad_solve():
    with pytest.raises(ResourceSolveError, match=r"round\(s\) \[1, 3\]"):
        rf.FusedEngine.check_outputs(
            {"bad_solve": np.array([False, True, False, True])})
    rf.FusedEngine.check_outputs({"bad_solve": np.zeros(4, bool)})
    with pytest.raises(ValueError, match=r"round\(s\) \[2\]"):
        rf.FusedEngine.check_outputs(
            {"bad_solve": np.zeros(3, bool),
             "overflow": np.array([False, False, True])})


def test_fused_validation_errors():
    with pytest.raises(ValueError, match="OSAFL scored round only"):
        build_fused_engine("fedavg", dataclasses.replace(
            XC, rounds_per_dispatch=1), device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        build_fused_engine("osafl", dataclasses.replace(
            XC, request_backend="python"), device="cpu")
    with pytest.raises(ValueError, match="resource backend"):
        build_fused_engine("osafl", dataclasses.replace(
            XC, resource_backend="f16"), device="cpu")
    with pytest.raises(ValueError, match="rounds_per_dispatch"):
        build_fused_engine("osafl", dataclasses.replace(
            XC, rounds_per_dispatch=0), device="cpu")
    with pytest.raises(ValueError, match="round_backend"):
        run("osafl", dataclasses.replace(XC, round_backend="turbo"),
            device="cpu")
    oracle_fused = dataclasses.replace(XC, request_backend="python")
    for engine in ("loop", "pod"):
        with pytest.raises(ValueError, match="dispatch"):
            run("osafl", dataclasses.replace(oracle_fused, engine=engine),
                device="cpu")


@pytest.mark.parametrize("change,match", [
    (dict(algorithm="fedavg"), "OSAFL scored round only"),
    (dict(request_backend="python"), "set request_backend='stacked'"),
    (dict(cohort_size=4), "dense-only"),
    ("f16", "unknown resource backend 'f16'"),
])
def test_engine_refuses_what_the_fused_body_cannot_run(change, match):
    _, s = build_fused_engine("osafl", XC, device="cpu")
    kw = dict(fl=s.fl, codec=s.codec, model=s.model,
              consts=s.rstream.consts, topk=s.rstream.topk,
              dataset=XC.dataset, arrivals=XC.arrivals, batch=XC.batch,
              p_ac=s.p_ac, sysb=s.sysb, net=s.net, n_params=s.n_params,
              test_batch=s.test_batch, alphas=s.server.alphas,
              sketch_key=s.server._sketch_key, seed=XC.seed, device="cpu")
    if change == "f16":
        kw["resource_backend"] = "f16"
    else:
        kw["fl"] = dataclasses.replace(s.fl, **change)
    with pytest.raises(ValueError, match=match):
        rf.FusedEngine(**kw)


def test_init_carry_refuses_cold_stream():
    eng, s = build_fused_engine("osafl", XC, device="cpu")
    cat, streams = make_population(XC.seed, XC.num_clients)
    cold = StackedRequestStream.from_streams(cat, streams, seed=XC.seed + 1,
                                             device="cpu")
    with pytest.raises(ValueError, match="warm"):
        eng.init_carry(s.server, s.sbuf, cold, 0)
    with pytest.raises(ValueError, match="segment length"):
        eng.run_segment(eng.init_carry(s.server, s.sbuf, s.rstream, 0), 0)


# ---------------------------------------------------------------------------
# the fixed-shape forms against the dispatch forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("literal", [False, True])
def test_masked_write_back_is_write_back(literal):
    fl = FLConfig(literal_init_buffer=literal)
    g = torch.Generator().manual_seed(1)
    buf = torch.randn(6, 9, generator=g)
    d_new, w = torch.randn(6, 9, generator=g), torch.randn(9, generator=g)
    prev = torch.tensor([1, 0, 0, 1, 0, 0], dtype=torch.bool)
    active = torch.tensor([0, 1, 0, 0, 0, 1], dtype=torch.bool)
    a, b = buf.clone(), buf.clone()
    pa = write_back(fl, w, a, prev, d_new, active)
    pb = write_back_masked(fl, w, b, prev, d_new, active)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert not torch.equal(a, buf)


@pytest.mark.parametrize("dataset", [1, 2])
def test_stage_and_commit_in_place_are_stage_and_commit(dataset):
    """Many rounds of random arrivals, with wrap-around and over-capacity
    commits, then an overflow of the staging area."""
    rng = np.random.default_rng(dataset)
    feat, dt = ((3,), np.float32) if dataset == 1 else ((10,), np.int64)
    caps = rng.integers(1, 6, size=5)
    a, b = (StackedOnlineBuffer.create(caps, feat, 100, stage_capacity=9,
                                       dtype=dt, device="cpu")
            for _ in range(2))
    for r in range(12):
        for _ in range(int(rng.integers(1, 3))):
            cnt = rng.integers(0, 5, size=5)
            if (a.state.staged_n.numpy() + cnt).max() > 9:
                cnt[:] = 0
            x = (rng.normal(size=(5, 4) + feat) * 10).astype(dt)
            y = rng.integers(0, 100, size=(5, 4))
            a.stage(x, y, cnt)
            assert not stage_in_place(b.state, torch.as_tensor(x),
                                      torch.as_tensor(y),
                                      torch.as_tensor(cnt))
        a.commit()
        commit_in_place(b.state)
        for k in a.state._fields:
            assert torch.equal(getattr(a.state, k), getattr(b.state, k)), \
                (k, r)
    full = (torch.zeros((5, 4) + feat, dtype=b.state.x.dtype),
            torch.zeros(5, 4, dtype=torch.int64), torch.full((5,), 4))
    flags = [bool(stage_in_place(b.state, *full)) for _ in range(3)]
    assert flags == [False, False, True]
    with pytest.raises(ValueError, match="stage_capacity"):
        for _ in range(3):
            a.stage(*[t.numpy() for t in full])


@pytest.mark.parametrize("backend", ["x64", "f32"])
def test_hoisted_solve_copies_nothing_from_the_host(monkeypatch, backend):
    """A solver prepared for its device makes no ``torch.tensor`` in its
    solve, and its decisions are the lazily built solver's."""
    rng = np.random.default_rng(0)
    from repro_torch.core.resource import make_clients
    from repro_torch.core.resource_stacked import (BACKEND_DTYPES,
                                                   sample_channels,
                                                   stack_clients)
    sysb = stack_clients(make_clients(rng, 16))
    ch = sample_channels(rng, sysb)
    dt = BACKEND_DTYPES[backend]
    cols = [torch.as_tensor(np.asarray(a, np.float64)).to(dt)
            for a in (sysb.c, sysb.s, sysb.f_max, sysb.p_max, sysb.e_bd,
                      ch.xi, ch.gamma)]
    want = make_solver_core(NetworkConfig(), backend)(*cols, 18_000)
    solve = make_solver_core(NetworkConfig(), backend, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("torch.tensor inside the solve")
    monkeypatch.setattr(torch, "tensor", refuse)
    got = solve(*cols, 18_000)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_segment_makes_no_host_copy_read_or_dynamic_shape(monkeypatch):
    """What breaks a CUDA graph capture, refused while a warm segment runs
    on the CPU: host copies (``torch.tensor``, ``as_tensor``), host reads
    (``item``, ``tolist``, ``numpy``, ``cpu``, a tensor's truth) and the
    data-dependent shapes of ``nonzero`` and boolean-mask indexing."""
    eng, _, carry = _engine(dataclasses.replace(F32, score_sketch_dim=16))
    eng.run_segment(carry, 1)                 # warm: the sketch sign cache

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} inside a fused segment")
        return fn
    for name in ("tensor", "as_tensor", "nonzero", "masked_select"):
        monkeypatch.setattr(torch, name, refuse(name))
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    get = torch.Tensor.__getitem__

    def no_mask(self, idx):
        parts = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(p, torch.Tensor) and p.dtype == torch.bool
               for p in parts):
            raise AssertionError("boolean-mask indexing inside a segment")
        return get(self, idx)
    monkeypatch.setattr(torch.Tensor, "__getitem__", no_mask)
    outs = eng._new_outs(2)
    eng._segment(carry, outs)
    monkeypatch.undo()
    assert int(carry.t) == 3 and bool(torch.isfinite(outs["test_loss"]).all())


# ---------------------------------------------------------------------------
# the counter-based draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """Random123's published answers for Philox-4x32-10."""
    got = rf.philox4x32([torch.tensor([c]) for c in counter], key)
    assert tuple(int(g) for g in got) == want


def test_counter_draws_are_balanced_and_deterministic():
    key = rf.fused_base_key(3)
    t = torch.tensor(7)
    w = rf.counter_words(key, t, 2, 200_000)
    assert torch.equal(w, rf.counter_words(key, t, 2, 200_000))
    assert int(w.min()) >= 0 and int(w.max()) < 2 ** 32
    bits = ((w[:, None] >> torch.arange(32)) & 1).double().mean(0)
    assert float((bits - 0.5).abs().max()) < 0.005
    u = rf.uniform(w)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    hist = torch.histc(u, bins=64, min=0.0, max=1.0).numpy()
    assert stats.chisquare(hist).pvalue > 1e-3
    z = rf.normal(w).double()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.var()) - 1) < 0.02
    assert stats.kstest(z.numpy(), "norm").pvalue > 1e-3
    g = rf.gumbel(w).double()
    assert abs(float(g.mean()) - np.euler_gamma) < 0.01
    assert stats.kstest(g.numpy(), "gumbel_r").pvalue > 1e-3


def test_counter_streams_rounds_and_seeds_are_independent():
    key = rf.fused_base_key(3)
    n = 50_000
    base = rf.uniform(rf.counter_words(key, torch.tensor(7), 2, n))
    others = [rf.uniform(rf.counter_words(key, torch.tensor(7), 3, n)),
              rf.uniform(rf.counter_words(key, torch.tensor(8), 2, n)),
              rf.uniform(rf.counter_words(key, torch.tensor(7 + 2 ** 32),
                                          2, n)),
              rf.uniform(rf.counter_words(rf.fused_base_key(4),
                                          torch.tensor(7), 2, n))]
    for o in others:
        assert not torch.equal(o, base)
        assert abs(float(np.corrcoef(o.numpy(), base.numpy())[0, 1])) < 0.02
    # a prefix of a stream is the stream's own start
    assert torch.equal(rf.counter_words(key, torch.tensor(7), 2, 9),
                       rf.counter_words(key, torch.tensor(7), 2, n)[:9])


def test_round_draws_shapes_and_ranges():
    eng, _, _ = _engine(F32)
    dr = rf.round_draws(eng.spec, torch.tensor(0))
    U, E = XC.num_clients, XC.arrivals
    assert dr.arrivals.shape == (U, E)
    assert dr.normals.shape == (U,)
    assert dr.slots.shape == (U, eng.fl.kappa_max, XC.batch)
    assert [tuple(n.shape) for n in dr.noise] == [
        (E, U), (E, U, G_GENRES), (E, U, FILES_PER_GENRE),
        (E, U, eng.topk)]
    assert all(t.dtype == torch.float32 for t in
               (dr.arrivals, dr.normals, dr.slots, *dr.noise))
    again = rf.round_draws(eng.spec, torch.tensor(0))
    assert all(torch.equal(a, b) for a, b in zip(
        (dr.arrivals, dr.normals, dr.slots, *dr.noise),
        (again.arrivals, again.normals, again.slots, *again.noise)))


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _reference_block_noise(key, L, U, topk):
    key, k_br, k_genre, k_rank, k_top = jax.random.split(key, 5)
    return key, (jax.random.uniform(k_br, (L, U), jnp.float32),
                 jax.random.gumbel(k_genre, (L, U, G_GENRES), jnp.float32),
                 jax.random.gumbel(k_rank, (L, U, FILES_PER_GENRE),
                                   jnp.float32),
                 jax.random.gumbel(k_top, (L, U, topk), jnp.float32))


def _reference_noise(key, L, U, topk):
    """The reference's four bulk draws of one request block from its
    stream key (``repro/data/video_caching_stacked.py:121-128``), as CPU
    tensors, and the next key."""
    key, noise = _reference_block_noise(key, L, U, topk)
    return key, tuple(torch.from_numpy(np.array(n)) for n in noise)


def _replay_reference_noise(self, L):
    """``StackedRequestStream._noise`` on the reference's stream key
    lineage (``fold_in(PRNGKey(seed), 0x726571)``, split once a block)."""
    key = getattr(self, "_jax_key", None)
    if key is None:
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), 0x726571)
    self._jax_key, noise = _reference_noise(key, L, self.num_users,
                                            self.topk)
    return noise


def _reference_round_draws(reference, seed, rstream):
    """``round_draws`` on the reference's draws: its round keys' uniforms
    and normals, and the request noise continuing ``rstream``'s replayed
    key lineage (one block a round, in order)."""
    jrf = reference.round_fused
    base = jrf.fused_base_key(seed)

    def draws(spec, t):
        k_arr, k_chan, k_slots = jrf.round_keys(base, int(t))
        U, E = spec.num_users, spec.width

        def host(a):
            return torch.from_numpy(np.array(a))
        rstream._jax_key, noise = _reference_noise(rstream._jax_key, E, U,
                                                   spec.topk)
        return rf.RoundDraws(
            arrivals=host(jax.random.uniform(k_arr, (U, E), jnp.float32)),
            normals=host(jax.random.normal(k_chan, (U,), jnp.float32)),
            slots=host(jax.random.uniform(
                k_slots, (U, spec.kappa_max, spec.batch), jnp.float32)),
            noise=noise)
    return draws


def test_draw_transforms_on_reference_uniforms_are_the_reference(reference):
    jrf = reference.round_fused
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(0)
    U, E = 9, 6
    p_ac = rng.uniform(0.05, 0.95, U).astype(np.float32)
    got = rf.draw_counts(torch.from_numpy(np.array(
        jax.random.uniform(key, (U, E), jnp.float32))), torch.from_numpy(p_ac))
    assert got.tolist() == np.asarray(
        jrf.draw_counts(key, jnp.asarray(p_ac), E)).tolist()
    db = rf.draw_shadowing_db(torch.from_numpy(np.array(
        jax.random.normal(key, (U,), jnp.float32))))
    assert np.array_equal(db.numpy(),
                          np.asarray(jrf.draw_shadowing_db(key, U)))
    size = rng.integers(0, 30, U).astype(np.int32)
    cap = np.maximum(size, rng.integers(1, 40, U)).astype(np.int32)
    head = (rng.integers(0, 100, U) % cap).astype(np.int32)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (U, 5, 8),
                                                     jnp.float32)))
    got = rf.draw_slots(u, *(torch.from_numpy(a) for a in (size, head, cap)))
    want = jrf.draw_slots(key, jnp.asarray(size), jnp.asarray(head),
                          jnp.asarray(cap), (5, 8))
    assert got.tolist() == np.asarray(want).tolist()


def test_fused_slice_matches_live_reference_run(reference, monkeypatch):
    kw = dataclasses.asdict(F32)
    kw.pop("score_sketch_dim")            # the port's own knob
    want_eng, ws = reference.harness.build_fused_engine(
        "osafl", reference.harness.ExperimentConfig(**kw))
    wc = want_eng.init_carry(ws.server, ws.sbuf, ws.rstream, 0)
    _, want = want_eng.run_segment(wc, R)
    want = jax.tree.map(np.asarray, want)
    w0 = to_numpy_tree(reference.small.init_small(
        jax.random.PRNGKey(XC.seed), XC.model))
    monkeypatch.setattr(tex, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, w0, device))
    monkeypatch.setattr(StackedRequestStream, "_noise",
                        _replay_reference_noise)
    eng, s = build_fused_engine("osafl", F32, device="cpu")
    monkeypatch.setattr(rf, "round_draws",
                        _reference_round_draws(reference, XC.seed, s.rstream))
    carry = eng.init_carry(s.server, s.sbuf, s.rstream, 0)
    _, got = eng.run_segment(carry, R)
    assert got["participants"].tolist() == want["participants"].tolist()
    np.testing.assert_allclose(got["test_loss"].numpy(), want["test_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["lam_use"].numpy(), want["lam_use"],
                               rtol=1e-4)
    assert not want["bad_solve"].any() and not got["bad_solve"].any()
