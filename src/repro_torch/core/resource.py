"""Per-client joint resource optimization (paper Section II-C, Appendix
B), a numpy copy of ``repro/core/resource.py``.

Each client jointly optimizes (local SGD rounds kappa, CPU frequency f,
transmit power p) to maximize

    eps * kappa / (0.5 v n nbar c s f^2)  +  (1-eps) * omega log2(1+SNR(p)) / p

s.t. deadline t_th and energy budget e_bd (eqs. 5/37), by the paper's
alternating solution: Lemma 1's closed-form kappa, Lemma 2's closed-form f
and SCA for p (eqs. 50-52), each SCA step solved exactly at an endpoint of
the feasible interval. Clients for which the problem is infeasible are
stragglers (kappa = 0). Everything is float64 numpy on the host, once per
client per round, as in the reference: the loop engine's solve
(``optimize_round``), and the system model the batched solve
(``core/resource_stacked.py``) shares.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

FPP = 32  # floating point precision (bits)

# Knife-edge slacks, as in the reference: the alternating solve parks its
# iterates exactly on two constraint boundaries, so (a) floor(J2) would flip
# kappa-1 vs kappa on last-ulp rounding and (b) the p_lo > p_max check would
# be a coin flip at p = p_max. The slacks keep both decisions on the
# exact-arithmetic side, the same across float implementations.
_J_SLACK = 1e-7
_P_SLACK = 1e-9


@dataclass
class ClientSystem:
    """Static per-client system configuration (paper Section V-A3)."""
    c: float            # CPU cycles per bit
    s: float            # sample size (bits)
    f_max: float        # max CPU frequency (Hz)
    p_max: float        # max transmit power (W)
    e_bd: float         # energy budget (J)
    distance: float     # to BS (m)


@dataclass
class ChannelState:
    """Per-round wireless channel: large-scale path gain Xi and shadowing Gamma
    (linear scale)."""
    xi: float
    gamma: float


@dataclass
class NetworkConfig:
    omega: float = 3 * 180e3       # bandwidth (Hz)
    noise_psd_dbm: float = -174.0  # thermal noise PSD (dBm/Hz)
    noise_figure_db: float = 7.0
    t_th: float = 200.0            # deadline (s)
    kappa_max: int = 5
    v: float = 2e-28               # effective capacitance
    n: int = 32                    # number of mini-batches
    nbar: int = 5                  # mini-batch size
    eps: float = 0.5               # objective trade-off epsilon
    sca_iters: int = 8
    outer_iters: int = 6
    tol: float = 1e-6

    @property
    def noise_power(self) -> float:
        return 10 ** ((self.noise_psd_dbm + self.noise_figure_db - 30) / 10) \
            * self.omega


def pathloss_linear(distance_m) -> float:
    """3GPP-style urban path loss at 2.4 GHz: PL(dB)=128.1+37.6 log10(d_km).
    Elementwise — accepts a scalar or an (U,) array of distances."""
    pl_db = 128.1 + 37.6 * np.log10(np.maximum(distance_m, 1.0) / 1000.0)
    return 10 ** (-pl_db / 10)


def sample_channel(rng: np.random.Generator, sys: ClientSystem,
                   shadow_sigma_db: float = 8.0) -> ChannelState:
    gamma = 10 ** (rng.normal(0.0, shadow_sigma_db) / 10)
    return ChannelState(xi=pathloss_linear(sys.distance), gamma=gamma)


def _rate(net: NetworkConfig, ch: ChannelState, p: float) -> float:
    """omega * log2(1 + Xi*Gamma*p / (omega*xi^2)) — bits/s."""
    snr = ch.xi * ch.gamma * p / net.noise_power
    return net.omega * np.log2(1.0 + snr)


def _upload_time(net, ch, p, n_params) -> float:
    return n_params * (FPP + 1) / max(_rate(net, ch, p), 1e-12)


def _upload_energy(net, ch, p, n_params) -> float:
    return _upload_time(net, ch, p, n_params) * p


def _comp_coeff(net: NetworkConfig, sys: ClientSystem) -> float:
    """n*nbar*c*s — cycles per local SGD round."""
    return net.n * net.nbar * sys.c * sys.s


def optimal_kappa(net, sys, ch, f, p, n_params) -> int:
    """Lemma 1 (eq. 42)."""
    cc = _comp_coeff(net, sys)
    e_up = _upload_energy(net, ch, p, n_params)
    t_up = _upload_time(net, ch, p, n_params)
    j1 = (sys.e_bd - e_up) / (0.5 * net.v * cc * f ** 2)
    j2 = f * (net.t_th - t_up) / cc
    k = min(net.kappa_max, int(np.floor(min(j1, j2) + _J_SLACK)))
    return max(k, 0)


def optimal_frequency(net, sys, ch, kappa, p, n_params) -> float:
    """Lemma 2 (eq. 48): the deadline lower bound (objective decreasing in f)."""
    cc = _comp_coeff(net, sys)
    r = _rate(net, ch, p)
    denom = net.t_th * r - n_params * (FPP + 1)
    if denom <= 0:
        return np.inf  # infeasible: upload alone exceeds the deadline
    return cc * kappa * r / denom


def _sca_power(net, sys, ch, kappa, f, n_params, p0) -> Optional[float]:
    """SCA for the power subproblem (eqs. 50-52). Each iteration the linearized
    objective is affine in p -> optimum at an endpoint of the feasible interval."""
    g = ch.xi * ch.gamma / net.noise_power   # SNR slope: snr = g*p
    Nb = n_params * (FPP + 1)
    e_cp = 0.5 * net.v * _comp_coeff(net, sys) * kappa * f ** 2
    # (52c)/(11c): minimum power so the upload meets the deadline given kappa,f
    t_cp = _comp_coeff(net, sys) * kappa / f
    t_left = net.t_th - t_cp
    if t_left <= 0:
        return None
    snr_min = 2.0 ** (Nb / (net.omega * t_left)) - 1.0
    p_lo = snr_min / g
    if p_lo > sys.p_max * (1 + _P_SLACK):
        return None
    p_lo = min(p_lo, sys.p_max)
    p = max(min(p0, sys.p_max), p_lo, 1e-6)
    for _ in range(net.sca_iters):
        ln = np.log1p(g * p)
        # ee(p) ~ affine: slope of omega*log2(1+gp)/p at p (eq. 50)
        obj_slope = (net.omega / np.log(2)) * (g / (p * (1 + g * p))
                                               - ln / p ** 2)
        # ebar(p) ~ affine: upload energy linearization (eq. 51)
        e_at = Nb * np.log(2) / net.omega * (p / ln)
        e_slope = Nb * np.log(2) / net.omega * (1 / ln - g * p /
                                                (ln ** 2 * (1 + g * p)))
        # energy constraint: e_cp + e_at + e_slope*(pp - p) <= e_bd
        p_hi = sys.p_max
        if e_slope > 0:
            p_hi = min(p_hi, p + (sys.e_bd - e_cp - e_at) / e_slope)
        if p_hi < p_lo - 1e-12:
            return None
        p_new = p_hi if obj_slope >= 0 else p_lo
        p_new = float(np.clip(p_new, p_lo, sys.p_max))
        if abs(p_new - p) < net.tol:
            p = p_new
            break
        p = 0.5 * (p + p_new)   # damped update for stability
    # verify true (non-linearized) constraints
    if (_upload_energy(net, ch, p, n_params) + e_cp <= sys.e_bd * (1 + 1e-6)
            and t_cp + _upload_time(net, ch, p, n_params)
            <= net.t_th * (1 + 1e-6)):
        return p
    return None


@dataclass
class ResourceDecision:
    kappa: int
    f: float
    p: float
    feasible: bool
    t_total: float = 0.0
    e_total: float = 0.0


def optimize_client(net: NetworkConfig, sys: ClientSystem, ch: ChannelState,
                    n_params: int) -> ResourceDecision:
    """Algorithm 1/4 with a small sweep over initial power points (the paper's
    algorithm takes "initial points f^0, p^0" as input; a bad initial p can make
    the first kappa projection infeasible even when the problem is not)."""
    best = ResourceDecision(0, sys.f_max, sys.p_max, False)
    for frac in (1.0, 0.1, 0.01, 1e-3, 1e-4):
        cand = _optimize_from(net, sys, ch, n_params, sys.p_max * frac)
        if cand.feasible and (not best.feasible or cand.kappa > best.kappa):
            best = cand
    return best


def _optimize_from(net: NetworkConfig, sys: ClientSystem, ch: ChannelState,
                   n_params: int, p0: float) -> ResourceDecision:
    f, p = sys.f_max, p0
    best = ResourceDecision(0, f, p, False)
    for _ in range(net.outer_iters):
        kappa = optimal_kappa(net, sys, ch, f, p, n_params)
        if kappa < 1:
            break
        f_new = optimal_frequency(net, sys, ch, kappa, p, n_params)
        if not np.isfinite(f_new) or f_new > sys.f_max:
            # cannot meet the deadline at this kappa; try fewer local rounds
            ok = False
            for k2 in range(kappa - 1, 0, -1):
                f_new = optimal_frequency(net, sys, ch, k2, p, n_params)
                if np.isfinite(f_new) and f_new <= sys.f_max:
                    kappa, ok = k2, True
                    break
            if not ok:
                break
        f = float(np.clip(f_new, 1e6, sys.f_max))
        p_new = _sca_power(net, sys, ch, kappa, f, n_params, p)
        if p_new is None:
            break
        p = p_new
        t_cp = _comp_coeff(net, sys) * kappa / f
        e_cp = 0.5 * net.v * _comp_coeff(net, sys) * kappa * f ** 2
        t_tot = t_cp + _upload_time(net, ch, p, n_params)
        e_tot = e_cp + _upload_energy(net, ch, p, n_params)
        if t_tot <= net.t_th * (1 + 1e-6) and e_tot <= sys.e_bd * (1 + 1e-6):
            best = ResourceDecision(kappa, f, p, True, t_tot, e_tot)
    return best


def make_clients(rng: np.random.Generator, num_clients: int,
                 cell_radius_m: float = 1000.0) -> list:
    """Sample the paper's client population (Section V-A3)."""
    out = []
    for _ in range(num_clients):
        out.append(ClientSystem(
            c=rng.uniform(25, 40),
            s=101_376.0,                          # Dataset-1 bits/sample (Table I)
            f_max=rng.uniform(1.0, 1.8) * 1e9,
            p_max=10 ** (rng.uniform(20, 30) / 10) / 1000,   # 20-30 dBm -> W
            e_bd=rng.uniform(1.2, 2.5),
            distance=cell_radius_m * np.sqrt(rng.uniform(0.01, 1.0)),
        ))
    return out


def optimize_round(rng: np.random.Generator, net: NetworkConfig,
                   clients: list, n_params: int) -> list:
    """One FL round: sample channels and solve (5) for every client."""
    return [optimize_client(net, sys, sample_channel(rng, sys), n_params)
            for sys in clients]
