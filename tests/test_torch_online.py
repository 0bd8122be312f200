"""The port's online pipeline against the reference: request streams and
their snapshots, the per-client and stacked FIFO buffers and the batched
resource solve (x64 and f32)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import resource as tres
from repro_torch.core import resource_stacked as trs
from repro_torch.core.buffer import OnlineBuffer, binomial_arrivals
from repro_torch.core.buffer_stacked import StackedOnlineBuffer
from repro_torch.data import online as tonline
from repro_torch.data import video_caching as tvc
from test_torch_oracle import reference  # noqa: F401


@pytest.mark.parametrize("dataset", [1, 2])
def test_request_streams_are_bit_identical(reference, dataset):
    _, jstreams = reference.video_caching.make_population(7, 6, topk=2)
    _, tstreams = tvc.make_population(7, 6, topk=2)
    for n in (1, 5, 13):
        for js, ts in zip(jstreams, tstreams):
            draw = "draw_dataset1" if dataset == 1 else "draw_dataset2"
            jx, jy = getattr(js, draw)(n)
            tx, ty = getattr(ts, draw)(n)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    p_ac = np.array([s.user.p_ac for s in tstreams])
    cj = reference.online.binomial_arrivals_batched(rj, 8, p_ac)
    ct = tonline.binomial_arrivals_batched(rt, 8, p_ac)
    np.testing.assert_array_equal(ct, cj)
    for a, e in zip(tonline.draw_arrival_batch(tstreams, ct, dataset, 8),
                    reference.online.draw_arrival_batch(jstreams, cj,
                                                        dataset, 8)):
        np.testing.assert_array_equal(a, e)


@pytest.mark.parametrize("dataset", [1, 2])
def test_stacked_buffer_matches_reference_with_wraparound(reference,
                                                          dataset):
    rng = np.random.default_rng(11)
    U, A = 5, 6
    caps = np.array([3, 4, 5, 6, 2])              # small: commits wrap
    feat, dtype = tonline.dataset_layout(dataset)
    feat = (7,) if dataset == 1 else feat          # narrow features suffice
    kw = dict(stage_capacity=2 * A, dtype=dtype)
    jb = reference.buffer_stacked.StackedOnlineBuffer.create(
        caps, feat, 100, **kw)
    tb = StackedOnlineBuffer.create(caps, feat, 100, device="cpu", **kw)
    for t in range(6):
        for _ in range(1 + t % 2):                 # over-capacity rounds
            counts = rng.integers(0, A + 1, size=U)
            x = (rng.normal(size=(U, A) + feat).astype(dtype) if dataset == 1
                 else rng.integers(0, 100, size=(U, A) + feat))
            y = rng.integers(0, 100, size=(U, A))
            jb.stage(x, y, counts)
            tb.stage(x, y, counts)
        assert tb.commit() == jb.commit()
        for f in ("x", "y", "cap", "size", "head", "staged_n"):
            np.testing.assert_array_equal(
                getattr(tb.state, f).numpy(),
                np.asarray(getattr(jb.state, f)), err_msg=f)
        for u in range(U):
            for a, e in zip(tb.dataset(u), jb.dataset(u)):
                np.testing.assert_array_equal(a, e)
        np.testing.assert_allclose(tb.label_histograms(),
                                   jb.label_histograms(), rtol=1e-6)
        rj, rt = np.random.default_rng(t), np.random.default_rng(t)
        sj, st = jb.sample_slots(rj, (5, 3)), tb.sample_slots(rt, (5, 3))
        np.testing.assert_array_equal(st, sj)
        assert rt.bit_generator.state == rj.bit_generator.state
        gj, gt = jb.gather(sj), tb.gather(st)
        for k in ("x", "y"):
            np.testing.assert_array_equal(gt[k].numpy(), np.asarray(gj[k]))


@pytest.mark.parametrize("dataset", [1, 2])
def test_online_buffer_matches_reference_with_wraparound(reference, dataset):
    """The genie's per-client FIFO buffer: rounds of Binomial arrivals
    overfill the capacity; storage, pointers, histograms, the shift proxy
    and sampled batches are bit-identical."""
    _, jstreams = reference.video_caching.make_population(5, 1)
    _, tstreams = tvc.make_population(5, 1)
    draw = "draw_dataset1" if dataset == 1 else "draw_dataset2"
    feat, dtype = tonline.dataset_layout(dataset)
    jb = reference.buffer.OnlineBuffer.create(7, feat, 100, dtype=dtype)
    tb = OnlineBuffer.create(7, feat, 100, dtype=dtype)
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(6):
        n = binomial_arrivals(rt, 8, 0.6)
        assert n == reference.buffer.binomial_arrivals(rj, 8, 0.6)
        if n:
            tb.stage(*getattr(tstreams[0], draw)(n))
            jb.stage(*getattr(jstreams[0], draw)(n))
        assert tb.commit() == jb.commit() == n
        assert (tb.size, tb.head) == (jb.size, jb.head)
        for a, e in zip(tb.dataset(), jb.dataset()):
            np.testing.assert_array_equal(a, e)
        np.testing.assert_array_equal(tb.label_histogram(),
                                      jb.label_histogram())
        assert tb.distribution_shift() == jb.distribution_shift()
        for a, e in zip(tb.sample_batch(rt, 5), jb.sample_batch(rj, 5)):
            np.testing.assert_array_equal(a, e)
    assert tb.size == tb.capacity


def test_stage_overflow_raises():
    tb = StackedOnlineBuffer.create([3, 3], (2,), 100, stage_capacity=2,
                                    device="cpu")
    with pytest.raises(ValueError, match="stage_capacity"):
        tb.stage(np.zeros((2, 3, 2)), np.zeros((2, 3)), [3, 0])


@pytest.mark.parametrize("radius,n_params", [(600.0, 3_900_000),
                                             (1000.0, 18_000),
                                             (1500.0, 3_900_000)])
def test_resource_solve_matches_reference(reference, radius, n_params):
    U = 96
    sys_j = reference.resource.make_clients(np.random.default_rng(2), U,
                                            cell_radius_m=radius)
    sys_t = tres.make_clients(np.random.default_rng(2), U,
                              cell_radius_m=radius)
    sbj = reference.resource_stacked.stack_clients(sys_j)
    sbt = trs.stack_clients(sys_t)
    for f in ("c", "s", "f_max", "p_max", "e_bd", "distance"):
        np.testing.assert_array_equal(getattr(sbt, f), getattr(sbj, f))
    net = tres.NetworkConfig()
    jnet = reference.resource.NetworkConfig()
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        dj = reference.resource_stacked.optimize_round_batched(
            rj, jnet, sbj, n_params)
        dt = trs.optimize_round_batched(rt, net, sbt, n_params,
                                        device="cpu")
        # the reference's own contract (DESIGN.md): kappa and feasibility
        # exact, f and p to 1e-6 relative
        np.testing.assert_array_equal(dt.kappa, dj.kappa)
        np.testing.assert_array_equal(dt.feasible, dj.feasible)
        np.testing.assert_allclose(dt.f, dj.f, rtol=1e-6)
        np.testing.assert_allclose(dt.p, dj.p, rtol=1e-6)
        np.testing.assert_allclose(dt.t_total, dj.t_total, rtol=1e-6)
        np.testing.assert_allclose(dt.e_total, dj.e_total, rtol=1e-6)
    assert 0 < int((dt.kappa >= 1).sum())


def test_f32_resource_backend_is_refused():
    """The f32 backend is ported now: ``make_solver_core`` builds it and
    refuses only unknown backends."""
    net = tres.NetworkConfig()
    assert callable(trs.make_solver_core(net, "f32"))
    with pytest.raises(ValueError, match="unknown"):
        trs.make_solver_core(net, "f16")
    with pytest.raises(ValueError, match="unknown"):
        trs.optimize_clients_batched(net, trs.stack_clients(
            tres.make_clients(np.random.default_rng(0), 2)),
            trs.ChannelBatch(np.ones(2), np.ones(2)), 18_000,
            backend="bf16", device="cpu")


def _f32_against_x64(dx, df, U):
    """DESIGN.md's f32 contract against x64: feasibility exact, kappa flips
    on at most 10 % of lanes (each a valid kappa), median relative
    difference on f, p and e_total at most 1e-3. Returns the readings."""
    np.testing.assert_array_equal(df.feasible, dx.feasible)
    flips = df.kappa != dx.kappa
    assert flips.mean() <= 0.10, np.flatnonzero(flips)
    assert np.all((df.kappa[flips] >= 1) & (df.kappa[flips] <= 5))
    m = dx.feasible & ~flips
    assert m.any()
    med = {k: float(np.median(np.abs(getattr(df, k)[m] - getattr(dx, k)[m])
                              / np.abs(getattr(dx, k)[m])))
           for k in ("f", "p", "e_total")}
    assert max(med.values()) <= 1e-3, med
    for d in (dx, df):
        assert d.kappa.dtype == np.int64 and d.f.dtype == np.float64
    return dict(U=U, flips=float(flips.mean()), **med)


@pytest.mark.parametrize("n_params", [18_000, 381_284, 3_900_000])
@pytest.mark.parametrize("U,seed", [(64, 3), (256, 0), (256, 1)])
def test_f32_solve_matches_x64_within_design_tolerance(n_params, U, seed):
    """The port's f32 solve against its x64 solve on the same batch, at the
    reference test's size (U=64, seed 3) and at the paper's cohort, for the
    MLP's, LSTM's and FCN's payloads; ``-s`` prints the readings. Every
    f32 decision also satisfies the constraints."""
    net = tres.NetworkConfig()
    rng = np.random.default_rng(seed)
    sysb = trs.stack_clients(tres.make_clients(rng, U))
    chb = trs.sample_channels(rng, sysb)
    dx = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                      device="cpu")
    df = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                      backend="f32", device="cpu")
    print("f32 against x64", n_params, _f32_against_x64(dx, df, U))
    mm = df.feasible
    assert np.all(df.t_total[mm] <= net.t_th * (1 + 1e-4))
    assert np.all(df.e_total[mm] <= sysb.e_bd[mm] * (1 + 1e-4))
    assert np.all(df.p[mm] <= sysb.p_max[mm] * (1 + 1e-5))


@pytest.mark.parametrize("n_params", [18_000, 3_900_000])
def test_f32_solve_against_reference_f32(reference, n_params):
    """The port's f32 solve against the reference's on the same batch
    (U=64, seed 3, the reference test's). Feasibility agrees exactly; both
    meet the x64 contract. They differ where the reference's f32 lands on
    the other side of a knife edge than x64 (its slacks are below f32's
    resolution, the port's are not): kappa on at most 10 % of lanes, and
    on the lanes where kappa agrees the median relative difference on f,
    p and e_total is at most 1e-3 (measured: 0 to 4.4e-4)."""
    net = tres.NetworkConfig()
    jnet = reference.resource.NetworkConfig()
    rng = np.random.default_rng(3)
    sysb = trs.stack_clients(tres.make_clients(rng, 64))
    chb = trs.sample_channels(rng, sysb)
    jsys = reference.resource_stacked.ClientSystemBatch(
        **dataclasses.asdict(sysb))
    jch = reference.resource_stacked.ChannelBatch(chb.xi, chb.gamma)
    jf = reference.resource_stacked.optimize_clients_batched(
        jnet, jsys, jch, n_params, backend="f32")
    tf = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                      backend="f32", device="cpu")
    np.testing.assert_array_equal(tf.feasible, jf.feasible)
    same = tf.kappa == jf.kappa
    assert same.mean() >= 0.90
    m = same & jf.feasible
    for k in ("f", "p", "e_total"):
        a, b = getattr(tf, k)[m], getattr(jf, k)[m]
        assert np.median(np.abs(a - b) / np.abs(b)) <= 1e-3, k


@pytest.mark.parametrize("t_th", [0.5, 1.5])
def test_f32_tight_deadline_gives_finite_power(t_th):
    """Deadlines so tight that a = Nb ln2 / (omega t_left) exceeds 88, where
    2^(Nb/(omega t)) overflows float32: the log-domain solve returns finite
    columns and classifies feasibility as x64 does."""
    net = dataclasses.replace(tres.NetworkConfig(), t_th=t_th)
    n_params = 3_900_000
    nb = n_params * (tres.FPP + 1)
    assert nb * np.log(2.0) / (net.omega * t_th) > 88
    with np.errstate(over="ignore"):
        assert np.isinf(np.float32(2.0) ** np.float32(nb / (net.omega
                                                            * t_th)))
    rng = np.random.default_rng(7)
    sysb = trs.stack_clients(tres.make_clients(rng, 64))
    chb = trs.sample_channels(rng, sysb)
    dx = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                      device="cpu")
    df = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                      backend="f32", device="cpu")
    for col in (df.kappa, df.f, df.p, df.t_total, df.e_total):
        assert np.isfinite(col).all()
    np.testing.assert_array_equal(df.feasible, dx.feasible)
    assert np.abs(df.kappa - dx.kappa).max(initial=0) <= 1


def test_nonfinite_feasible_lane_raises():
    kappa = np.array([2.0, np.nan, 1.0, 3.0])
    f = np.array([1e9, 1e9, np.inf, 1e9])
    p = np.ones(4)
    with pytest.raises(trs.ResourceSolveError, match=r"\[1, 2\]"):
        trs._check_finite(kappa, f, p, np.array([True, True, True, False]),
                          "f32")
    trs._check_finite(kappa, f, p, np.array([True, False, False, False]),
                      "f32")


@pytest.mark.parametrize("dataset", [1, 2])
def test_stream_snapshots_match_reference_key_for_key(reference, dataset):
    """The python streams' ``state_dict`` is the reference's: a snapshot of
    either package restores into the other and both continue bit for bit;
    ``load_streams_state`` refuses another cohort size."""
    from repro_torch.checkpoint import CheckpointError
    _, jstreams = reference.video_caching.make_population(5, 3, topk=2)
    _, tstreams = tvc.make_population(5, 3, topk=2)
    draw = "draw_dataset1" if dataset == 1 else "draw_dataset2"
    for js, ts in zip(jstreams, tstreams):
        getattr(js, draw)(4)
        getattr(ts, draw)(4)
    jsd = reference.online.streams_state_dict(jstreams)
    tsd = tonline.streams_state_dict(tstreams)
    assert [sorted(d) for d in tsd] == [sorted(d) for d in jsd]
    _, jfresh = reference.video_caching.make_population(5, 3, topk=2)
    _, tfresh = tvc.make_population(5, 3, topk=2)
    reference.online.load_streams_state(jfresh, tsd)
    tonline.load_streams_state(tfresh, jsd)
    want, *others = [[getattr(s, draw)(3) for s in streams]
                     for streams in (jstreams, tstreams, jfresh, tfresh)]
    for got in others:
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    with pytest.raises(CheckpointError, match="3 request streams"):
        tonline.load_streams_state(tfresh[:2], tsd)


@pytest.mark.parametrize("n_params", [18_000, 3_900_000])
def test_f32_slacks_keep_the_design_tolerance(reference, monkeypatch,
                                              n_params):
    """Why the port's f32 knife-edge slacks are widened to float32 ulps:
    at the paper's cohort (U=256, seed 0) with the reference's slacks the
    port's f32 solve misses DESIGN.md's tolerance against x64 (at the
    MLP's payload most lanes whose deadline binds fall to the infeasible
    side of the minimum-power check and another initial power point wins;
    at the FCN's, Lemma 1's floor flips kappas), with the widened ones it
    meets it. ``-s`` prints both and the reference's own f32 on the same
    batch."""
    net = tres.NetworkConfig()
    rng = np.random.default_rng(0)
    sysb = trs.stack_clients(tres.make_clients(rng, 256))
    chb = trs.sample_channels(rng, sysb)
    dx = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                      device="cpu")

    def readings(d):
        flips = d.kappa != dx.kappa
        m = dx.feasible & ~flips
        return dict(feasibility_equal=bool(np.array_equal(d.feasible,
                                                          dx.feasible)),
                    flips=float(flips.mean()),
                    **{k: float(np.median(np.abs(getattr(d, k)[m]
                                                 - getattr(dx, k)[m])
                                          / np.abs(getattr(dx, k)[m])))
                       for k in ("f", "p", "e_total")})
    widened = readings(trs.optimize_clients_batched(
        net, sysb, chb, n_params, backend="f32", device="cpu"))
    jf = reference.resource_stacked.optimize_clients_batched(
        reference.resource.NetworkConfig(),
        reference.resource_stacked.ClientSystemBatch(
            **dataclasses.asdict(sysb)),
        reference.resource_stacked.ChannelBatch(chb.xi, chb.gamma),
        n_params, backend="f32")
    monkeypatch.setattr(trs, "_F32_ULPS", {"kappa": 0.0, "power": 0.0,
                                           "check": 0.0})
    narrow = readings(trs.optimize_clients_batched(
        net, sysb, chb, n_params, backend="f32", device="cpu"))
    print(f"f32 slacks at U=256, n_params={n_params}: widened {widened}; "
          f"the reference's slacks {narrow}; the reference's f32 "
          f"{readings(jf)}")

    def meets(r):
        return (r["feasibility_equal"] and r["flips"] <= 0.10
                and max(r["f"], r["p"], r["e_total"]) <= 1e-3)
    assert meets(widened)
    assert not meets(narrow)


def _ulp_noise(fn, gen, k):
    """``fn`` whose float32 results move by a random -k..k ulps each."""
    def noisy(x, *args, **kwargs):
        y = fn(x, *args, **kwargs)
        if y.dtype != torch.float32:
            return y
        steps = torch.randint(-k, k + 1, y.shape, generator=gen)
        up = torch.full_like(y, float("inf"))
        for _ in range(k):
            y = torch.where(steps > 0, torch.nextafter(y, up), y)
            y = torch.where(steps < 0, torch.nextafter(y, -up), y)
            steps = steps - steps.sign()
        return y
    return noisy


@pytest.mark.parametrize("n_params", [381_284, 1_118_500, 3_900_000])
def test_f32_solve_lands_where_it_does_under_other_rounding(monkeypatch,
                                                            n_params):
    """The card's ``log``, ``exp`` and kin round otherwise than the CPU's.
    With every transcendental result of the f32 solve moved by up to 4
    ulps, no kappa and no feasibility flag moves at the paper's cohort over
    4 channel draws, and the decisions stay x64's."""
    net = tres.NetworkConfig()
    rng = np.random.default_rng(0)
    sysb = trs.stack_clients(tres.make_clients(rng, 256))
    fns = ("log", "log2", "exp", "expm1", "log1p")
    originals = {name: getattr(torch, name) for name in fns}
    for draw in range(4):
        chb = trs.sample_channels(rng, sysb)
        want = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                            backend="f32", device="cpu")
        dx = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                          device="cpu")
        np.testing.assert_array_equal(want.kappa, dx.kappa)
        gen = torch.Generator().manual_seed(draw)
        for name in fns:
            monkeypatch.setattr(torch, name,
                                _ulp_noise(originals[name], gen, 4))
        got = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                           backend="f32", device="cpu")
        monkeypatch.undo()
        np.testing.assert_array_equal(got.kappa, want.kappa)
        np.testing.assert_array_equal(got.feasible, want.feasible)
