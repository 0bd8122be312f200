"""The port's online pipeline against the reference: request streams, the
per-client and stacked FIFO buffers and the batched resource solve."""
import numpy as np
import pytest

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
    with pytest.raises(NotImplementedError, match="f32"):
        trs.make_solver_core(tres.NetworkConfig(), "f32")
    with pytest.raises(ValueError, match="unknown"):
        trs.make_solver_core(tres.NetworkConfig(), "f16")
