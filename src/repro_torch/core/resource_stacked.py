"""Batched joint resource optimization (paper Section II-C, Appendix B).

The port of ``repro/core/resource_stacked.py``: Lemma 1 (kappa) and Lemma 2
(CPU frequency) in closed form and the interval-endpoint SCA power step,
for all U clients at once as elementwise torch ops over (U,) tensors. The
scalar algorithm's early exits (straggler breaks, frequency fallback, SCA
convergence) become lane masks, and Algorithm 1's five initial power
points run as a leading axis of five.

Two numeric backends (``resource_backend``):

  * ``"x64"`` (default, the parity oracle): float64 (torch needs no scoped
    flag). Against the reference, kappa and feasibility match exactly and
    (f, p) to 1e-6 relative.
  * ``"f32"``: float32, with the one term that overflows it, the minimum
    SNR 2^(Nb / (omega t_left)) - 1, taken in the log domain:
    ``log p_lo = log(expm1(a)) - log g`` with ``a = Nb ln2 / (omega
    t_left)`` (``expm1`` for a <= 10, ``a + log1p(-e^-a)`` above) is
    compared with ``log p_max`` and only the clipped value is
    exponentiated. DESIGN.md's tolerance against x64: feasibility exact,
    kappa flips on at most 10 % of lanes, median relative difference on
    f, p and e_total at most 1e-3. Feasible lanes that come back
    non-finite raise ``ResourceSolveError``.

The solve sits on two knife edges by construction: Lemma 2 picks f so
that the deadline binds, so the next Lemma 1 floor sees j = kappa and the
SCA's minimum power sees p_lo = p. The reference's slacks there
(``_J_SLACK`` 1e-7, ``_P_SLACK`` 1e-9) are below float32's resolution,
and with them the side each lane lands on is decided by rounding: in
torch on the CPU, at U=256, most lanes fall to the other side than x64
(median relative p difference 0.90 at the MLP's payload, 12 % kappa
flips at the FCN's), fewer in XLA. So on the f32 backend each slack is
widened to a few float32 ulps of its term (``_F32_ULPS``), and the f32
solve then lands where x64 does (``tests/test_torch_online.py``, ``-k
slacks``, prints both); x64 keeps the reference's slacks.

``sample_channels`` draws the same channel stream from an
``np.random.Generator`` as the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.resource import (_J_SLACK, _P_SLACK, FPP, ClientSystem,
                                       NetworkConfig, pathloss_linear)
from repro_torch.device import resolve_device

_LN2 = float(np.log(2.0))

RESOURCE_BACKENDS = ("x64", "f32")
BACKEND_DTYPES = {"x64": torch.float64, "f32": torch.float32}
_FRACS = (1.0, 0.1, 0.01, 1e-3, 1e-4)     # Algorithm 1's initial power points
# f32 knife-edge slacks, in float32 ulps: of j in Lemma 1's floor, and of
# log p_lo against log p_max, whose rounding t_left = t_th - t_cp amplifies
# by t_th / t_left (see the module docstring)
_F32_ULPS = {"kappa": 8.0, "power": 4.0}


class ResourceSolveError(RuntimeError):
    """The batched solve produced non-finite kappa/f/p on feasible lanes."""


@dataclass
class ClientSystemBatch:
    """Column-stacked ``ClientSystem``: every field an (U,) float64 array."""
    c: np.ndarray
    s: np.ndarray
    f_max: np.ndarray
    p_max: np.ndarray
    e_bd: np.ndarray
    distance: np.ndarray

    def __len__(self) -> int:
        return self.c.shape[0]


def stack_clients(clients: Sequence[ClientSystem]) -> ClientSystemBatch:
    """Stack a ``make_clients`` population into (U,) field arrays."""
    cols = {f.name: np.array([getattr(cl, f.name) for cl in clients],
                             np.float64)
            for f in dataclasses.fields(ClientSystem)}
    return ClientSystemBatch(**cols)


@dataclass
class ChannelBatch:
    """Per-round wireless channels for the whole cohort: (U,) arrays."""
    xi: np.ndarray
    gamma: np.ndarray


def sample_channels(rng: np.random.Generator, sysb: ClientSystemBatch,
                    shadow_sigma_db: float = 8.0) -> ChannelBatch:
    """One array draw: the same stream as U sequential scalar draws."""
    gamma = 10 ** (rng.normal(0.0, shadow_sigma_db, size=len(sysb)) / 10)
    return ChannelBatch(xi=pathloss_linear(sysb.distance), gamma=gamma)


@dataclass
class ResourceDecisionBatch:
    """Column-stacked decisions; ``kappa`` is 0 for stragglers."""
    kappa: np.ndarray       # (U,) int64
    f: np.ndarray           # (U,) float64
    p: np.ndarray           # (U,) float64
    feasible: np.ndarray    # (U,) bool
    t_total: np.ndarray     # (U,) float64
    e_total: np.ndarray     # (U,) float64


def make_solver_core(net: NetworkConfig, backend: str = "x64"):
    """The all-clients solve as a function of (c, s, f_max, p_max, e_bd, xi,
    gamma) — (U,) tensors of the backend's dtype (``BACKEND_DTYPES``) on
    one device — and the scalar payload ``n_params``, returning the six
    decision columns as tensors. Every formula mirrors the reference line
    for line; on the f32 backend the minimum-power step runs in the log
    domain."""
    if backend not in RESOURCE_BACKENDS:
        raise ValueError(f"unknown resource backend {backend!r} "
                         f"(expected one of {RESOURCE_BACKENDS})")
    log_domain = backend == "f32"
    dtype = BACKEND_DTYPES[backend]
    noise = net.noise_power
    inf = float("inf")

    def solve(c, s, f_max, p_max, e_bd, xi, gamma, n_params):
        kw = dict(dtype=dtype, device=c.device)
        fracs = torch.tensor(_FRACS, **kw)
        ks = torch.arange(1.0, net.kappa_max + 1, **kw)[:, None, None]
        xg = xi * gamma
        cc = net.n * net.nbar * c * s               # cycles per local round
        # upload payload (bits), in the backend's dtype as the reference's
        nb = torch.tensor(float(n_params), **kw) * (FPP + 1)
        g = xg / noise                              # SNR slope: snr = g*p
        log1p_slack = torch.log1p(torch.tensor(_P_SLACK, **kw))
        eps = torch.finfo(dtype).eps

        def rate(p):
            return net.omega * torch.log2(1.0 + xg * p / noise)

        def t_up(p):
            return nb / torch.clamp(rate(p), min=1e-12)

        def e_up(p):
            return t_up(p) * p

        def opt_kappa(f, p):
            """Lemma 1 (eq. 42)."""
            j1 = (e_bd - e_up(p)) / (0.5 * net.v * cc * f ** 2)
            j2 = f * (net.t_th - t_up(p)) / cc
            j = torch.minimum(j1, j2)
            slack = (torch.clamp(_F32_ULPS["kappa"] * eps * j, min=_J_SLACK)
                     if log_domain else _J_SLACK)
            k = torch.clamp(torch.floor(j + slack), max=float(net.kappa_max))
            return torch.clamp(k, min=0.0)

        def opt_freq(kappa, p):
            """Lemma 2 (eq. 48); inf where upload alone exceeds deadline."""
            r = rate(p)
            denom = net.t_th * r - nb
            val = cc * kappa * r / torch.where(denom > 0, denom, 1.0)
            return torch.where(denom > 0, val, inf)

        def min_power(t_left, valid):
            """(52c)/(11c): smallest p meeting the deadline at (kappa, f).

            The direct form 2^(Nb/(omega*t_left)) - 1 overflows f32 for
            tight deadlines; the log-domain form compares log p_lo with
            log p_max and exponentiates only the clipped value."""
            t_safe = torch.where(valid, t_left, 1.0)
            if not log_domain:
                snr_min = 2.0 ** (nb / (net.omega * t_safe)) - 1.0
                p_lo = snr_min / g
                valid = valid & (p_lo <= p_max * (1 + _P_SLACK))
                return (torch.where(valid, torch.minimum(p_lo, p_max), 1e-6),
                        valid)
            a = nb * _LN2 / (net.omega * t_safe)    # log(1 + snr_min)
            # log(expm1(a)): the exact small-a form, the overflow-free
            # large-a form
            log_snr = torch.where(
                a > 10.0,
                a + torch.log1p(-torch.exp(-torch.clamp(a, min=10.0))),
                torch.log(torch.expm1(torch.clamp(a, max=10.0))))
            log_p_lo = log_snr - torch.log(g)
            log_cap = torch.log(p_max)
            # d log_snr / d log t_left = -a / (1 - e^-a); t_left carries
            # ~eps * t_th of rounding from its cancellation
            slack = torch.maximum(
                _F32_ULPS["power"] * eps * (net.t_th / t_safe) * a
                / -torch.expm1(-a), log1p_slack)
            valid = valid & (log_p_lo <= log_cap + slack)
            p_lo = torch.exp(torch.minimum(log_p_lo, log_cap))
            return torch.where(valid, p_lo, 1e-6), valid

        def sca_power(kappa, f, p0):
            """SCA (eqs. 50-52) with convergence/abort masks per lane."""
            e_cp = 0.5 * net.v * cc * kappa * f ** 2
            t_cp = cc * kappa / f
            t_left = net.t_th - t_cp
            valid = t_left > 0
            p_lo, valid = min_power(t_left, valid)
            p = torch.clamp(torch.maximum(torch.minimum(p0, p_max), p_lo),
                            min=1e-6)
            done = torch.zeros_like(valid)
            for _ in range(net.sca_iters):
                act = valid & ~done
                ln = torch.log1p(g * p)
                obj_slope = (net.omega / _LN2) * (g / (p * (1 + g * p))
                                                  - ln / p ** 2)
                e_at = nb * _LN2 / net.omega * (p / ln)
                e_slope = nb * _LN2 / net.omega * (1 / ln - g * p /
                                                   (ln ** 2 * (1 + g * p)))
                pos = e_slope > 0
                p_hi = torch.where(
                    pos,
                    torch.minimum(p_max, p + (e_bd - e_cp - e_at)
                                  / torch.where(pos, e_slope, 1.0)),
                    p_max)
                bad = p_hi < p_lo - 1e-12
                valid = valid & ~(act & bad)
                act = act & ~bad
                p_new = torch.minimum(
                    torch.maximum(torch.where(obj_slope >= 0, p_hi, p_lo),
                                  p_lo), p_max)
                conv = torch.abs(p_new - p) < net.tol
                p = torch.where(act, torch.where(conv, p_new,
                                                 0.5 * (p + p_new)), p)
                done = done | (act & conv)
            ok = valid & (e_up(p) + e_cp <= e_bd * (1 + 1e-6)) \
                & (t_cp + t_up(p) <= net.t_th * (1 + 1e-6))
            return p, ok

        # all five initial power points at once: (5, U) lanes
        p = p_max[None, :] * fracs[:, None]
        f = f_max.expand_as(p)
        alive = torch.ones(p.shape, dtype=torch.bool, device=p.device)
        rk = torch.zeros_like(p)
        rf, rp = f, p
        rfeas = torch.zeros_like(alive)
        rt = torch.zeros_like(p)
        re_ = torch.zeros_like(p)
        for _ in range(net.outer_iters):
            kappa = opt_kappa(f, p)
            alive = alive & (kappa >= 1)
            f_new = opt_freq(kappa, p)
            good = torch.isfinite(f_new) & (f_new <= f_max)
            # deadline infeasible at kappa: largest k2 < kappa that fits
            f_all = opt_freq(ks, p[None])                    # (K, 5, U)
            ok_all = torch.isfinite(f_all) & (f_all <= f_max)
            cand = ok_all & (ks <= (kappa - 1)[None])
            k2 = torch.amax(torch.where(cand, ks, 0.0), dim=0)
            f_k2 = torch.sum(torch.where(ks == k2[None], f_all, 0.0), dim=0)
            kappa = torch.where(good, kappa, k2)
            f_new = torch.where(good, f_new, f_k2)
            alive = alive & (good | (k2 >= 1))
            f = torch.where(alive, torch.minimum(torch.clamp(f_new, min=1e6),
                                                 f_max), f)
            p_sca, sca_ok = sca_power(kappa, f, p)
            alive = alive & sca_ok
            p = torch.where(alive, p_sca, p)
            t_tot = cc * kappa / f + t_up(p)
            e_tot = 0.5 * net.v * cc * kappa * f ** 2 + e_up(p)
            okc = alive & (t_tot <= net.t_th * (1 + 1e-6)) \
                & (e_tot <= e_bd * (1 + 1e-6))
            rk = torch.where(okc, kappa, rk)
            rf = torch.where(okc, f, rf)
            rp = torch.where(okc, p, rp)
            rt = torch.where(okc, t_tot, rt)
            re_ = torch.where(okc, e_tot, re_)
            rfeas = rfeas | okc

        bk = torch.zeros_like(c)
        bf, bp = f_max, p_max
        bfeas = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
        bt = torch.zeros_like(c)
        be = torch.zeros_like(c)
        for i in range(len(_FRACS)):                # keep the scalar order
            better = rfeas[i] & (~bfeas | (rk[i] > bk))
            bk = torch.where(better, rk[i], bk)
            bf = torch.where(better, rf[i], bf)
            bp = torch.where(better, rp[i], bp)
            bt = torch.where(better, rt[i], bt)
            be = torch.where(better, re_[i], be)
            bfeas = bfeas | rfeas[i]
        return bk, bf, bp, bfeas, bt, be

    return solve


def _check_finite(kappa, f, p, feas, backend: str) -> None:
    """Feasible lanes must carry finite decisions: raise, never hand
    non-finite kappa/f/p to the round loop."""
    bad = feas & ~(np.isfinite(kappa) & np.isfinite(f) & np.isfinite(p))
    if bad.any():
        lanes = np.flatnonzero(bad)[:8]
        raise ResourceSolveError(
            f"resource solve ({backend} backend) produced non-finite "
            f"kappa/f/p on {int(bad.sum())} feasible client(s) "
            f"(first lanes {lanes.tolist()}: "
            f"kappa={kappa[lanes].tolist()}, f={f[lanes].tolist()}, "
            f"p={p[lanes].tolist()}); for tight-deadline/knife-edge "
            "configurations run resource_backend='x64'")


def optimize_clients_batched(net: NetworkConfig, sysb: ClientSystemBatch,
                             ch: ChannelBatch, n_params: int,
                             backend: str = "x64", device=None
                             ) -> ResourceDecisionBatch:
    """All-clients solve on ``device`` in the backend's dtype; the columns
    come back as host numpy float64/int64/bool whatever the backend."""
    solver = make_solver_core(net, backend)
    dev = resolve_device(device)
    cols = [torch.as_tensor(np.asarray(a, np.float64), device=dev)
            .to(BACKEND_DTYPES[backend])
            for a in (sysb.c, sysb.s, sysb.f_max, sysb.p_max, sysb.e_bd,
                      ch.xi, ch.gamma)]
    kappa, f, p, feas, t, e = [o.cpu().numpy()
                               for o in solver(*cols, n_params)]
    feas = feas.astype(bool)
    _check_finite(kappa, f, p, feas, backend)
    return ResourceDecisionBatch(kappa=kappa.astype(np.int64),
                                 f=f.astype(np.float64),
                                 p=p.astype(np.float64), feasible=feas,
                                 t_total=t.astype(np.float64),
                                 e_total=e.astype(np.float64))


def optimize_round_batched(rng: np.random.Generator, net: NetworkConfig,
                           sysb: ClientSystemBatch, n_params: int,
                           backend: str = "x64", device=None
                           ) -> ResourceDecisionBatch:
    """One FL round: vectorized channel sampling + the batched solve (5)."""
    return optimize_clients_batched(net, sysb, sample_channels(rng, sysb),
                                    n_params, backend=backend, device=device)
