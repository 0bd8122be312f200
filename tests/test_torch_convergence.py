"""The Theorem-1 calculator of the port (``repro_torch.core.convergence``,
paper eq. 24) against the reference's ``repro.core.convergence`` on the same
seeded float64 inputs (rtol 1e-12: the same host numpy, term for term), and
the structural checks of the theory that ``tests/test_fl_core.py`` makes of
the reference: B_u >= 0, the error terms grow with kappa, the FedAvg
special case (eq. 26), the learning-rate condition, and eq. 35's
Delta* -> lambda."""
import dataclasses

import numpy as np
import pytest

from repro_torch.core.convergence import (BoundHypers, a_term, average_bound,
                                          b_term, fedavg_bound, lr_condition,
                                          optimal_delta, round_bound)
from test_torch_oracle import reference  # noqa: F401

from _hyp import given, settings, st

RTOL = 1e-12


def _hypers(rng) -> dict:
    return dict(beta=rng.uniform(0.5, 2.0), sigma2=rng.uniform(0.0, 1.0),
                rho1=rng.uniform(0.5, 2.0), rho2=rng.uniform(0.0, 1.0),
                eta=rng.uniform(0.001, 0.1), eta_g=rng.uniform(0.5, 2.0))


def _round_inputs(rng, U=6) -> tuple:
    alpha = rng.dirichlet(np.ones(U))
    kappa = rng.integers(1, 6, size=U).astype(np.float64)
    lam = rng.uniform(0.0, 1.0, size=U)
    delta = rng.uniform(0.0, 1.5, size=U)
    phi = rng.uniform(0.0, 0.5, size=U)
    ds = rng.uniform(0.0, 0.5, size=U)
    return alpha, kappa, delta, lam, phi, ds


@pytest.mark.parametrize("seed", range(4))
def test_every_function_matches_the_reference(reference, seed):
    R = reference.convergence
    rng = np.random.default_rng(seed)
    hk = _hypers(rng)
    h, rh = BoundHypers(**hk), R.BoundHypers(**hk)
    assert dataclasses.asdict(h) == dataclasses.asdict(rh)
    assert dataclasses.asdict(BoundHypers()) == dataclasses.asdict(
        R.BoundHypers())
    alpha, kappa, delta, lam, phi, ds = _round_inputs(rng)
    np.testing.assert_allclose(b_term(delta, lam), R.b_term(delta, lam),
                               rtol=RTOL)
    B = b_term(delta, lam)
    np.testing.assert_allclose(a_term(h, alpha, kappa, B),
                               R.a_term(rh, alpha, kappa, B), rtol=RTOL)
    rounds, rrounds = [], []
    for t in range(3):
        l0, l1 = rng.uniform(1.0, 3.0, size=2)
        got = round_bound(h, l0, l1, alpha, kappa, delta, lam, phi, ds)
        want = R.round_bound(rh, l0, l1, alpha, kappa, delta, lam, phi, ds)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        rounds.append(got)
        rrounds.append(want)
    np.testing.assert_allclose(average_bound(h, rounds),
                               R.average_bound(rh, rrounds), rtol=RTOL)
    for k in (1, 3, 5):
        assert lr_condition(h, k) == R.lr_condition(rh, k)
    np.testing.assert_allclose(fedavg_bound(h, 2.0, 1.9, alpha, 3, phi),
                               R.fedavg_bound(rh, 2.0, 1.9, alpha, 3, phi),
                               rtol=RTOL)
    for u in range(len(alpha)):
        args = (alpha[u], kappa[u], lam[u], phi[u], ds[u])
        for gamma in (0.0, rng.uniform(0.0, 0.5)):
            np.testing.assert_allclose(
                optimal_delta(h, *args, gamma_u=gamma),
                R.optimal_delta(rh, *args, gamma_u=gamma), rtol=RTOL)


@given(st.floats(0.0, 3.0), st.floats(0.0, 1.0))
@settings(max_examples=30, deadline=None)
def test_b_term_nonnegative(delta, lam):
    assert b_term(np.array([delta]), np.array([lam]))[0] >= 0.0


def test_round_bound_error_terms_scale_with_kappa():
    h = BoundHypers(beta=1.0, sigma2=0.5, rho2=1.0, eta=0.01)
    alpha = np.full(4, 0.25)
    lam = np.full(4, 0.8)
    delta = lam.copy()
    phi = np.full(4, 0.1)
    ds = np.full(4, 0.2)
    b1 = round_bound(h, 1.0, 0.9, alpha, np.full(4, 1.0), delta, lam, phi, ds)
    b5 = round_bound(h, 1.0, 0.9, alpha, np.full(4, 5.0), delta, lam, phi, ds)
    assert b5["shift_err"] > b1["shift_err"]
    assert b5["hetero_err"] > b1["hetero_err"]


def test_fedavg_special_case_consistency():
    """Delta = 1, lambda = 1, IID (rho2 = 0): eq. 24's bracket reduces to
    the FedAvg bound, eq. 26."""
    h = BoundHypers(beta=1.0, sigma2=0.3, rho1=1.0, rho2=0.0, eta=0.01,
                    eta_g=1.0)
    alpha = np.full(3, 1 / 3)
    kappa = np.full(3, 2.0)
    phi = np.full(3, 0.05)
    r = round_bound(h, 1.0, 0.95, alpha, kappa, np.ones(3), np.ones(3), phi,
                    np.zeros(3))
    fa = fedavg_bound(h, 1.0, 0.95, alpha, 2, phi)
    np.testing.assert_allclose(r["total"] * r["A"], fa, rtol=1e-9)


def test_lr_condition():
    assert lr_condition(BoundHypers(beta=1.0, eta=0.05, eta_g=1.0), 5)
    assert not lr_condition(BoundHypers(beta=1.0, eta=0.2, eta_g=1.0), 5)


@given(st.floats(0.01, 0.99), st.floats(0.0, 0.5), st.floats(0.0, 0.5))
@settings(max_examples=30, deadline=None)
def test_optimal_delta_tracks_lambda(lam, phi, ds):
    """Eq. 35: with gamma = 0, Delta* <= lam and -> lam as sigma2 -> 0."""
    d = optimal_delta(BoundHypers(sigma2=0.0), 0.25, 3.0, lam, phi, ds,
                      gamma_u=0.0)
    np.testing.assert_allclose(d, lam, rtol=1e-9)
    d2 = optimal_delta(BoundHypers(sigma2=5.0), 0.25, 3.0, lam, phi, ds,
                       gamma_u=0.0)
    assert d2 <= lam + 1e-12
