"""Per-client system model of the resource optimization (paper Section
II-C, Appendix B): the numpy pieces of ``repro/core/resource.py`` that the
batched solve (``core/resource_stacked.py``) and the harness need.
"""
from __future__ import annotations

from dataclasses import dataclass

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
